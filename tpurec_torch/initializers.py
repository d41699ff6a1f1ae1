"""Seeded parameter initialisation (the flax initializers the JAX package uses).

Every port module that owns parameters defines ``init_weights(generator)``
for its OWN parameters (not its children's); ``init_parameters`` walks the
module tree once with one ``torch.Generator``. The numbers differ from JAX's
for the same seed: tests move weights across with ``tpurec_torch.bridge``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def uniform_(t: torch.Tensor, scale: float, generator: torch.Generator) -> None:
    """U(-scale, scale) — the JAX package's ``uniform_init`` for tables."""
    with torch.no_grad():
        t.uniform_(-scale, scale, generator=generator)


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``glorot_uniform``: U(±sqrt(6 / (fan_in + fan_out))) with the
    fans of the last two axes times the leading axes' size (symmetric in the
    two, so (in, out) and ``nn.Linear``'s (out, in) layouts get the same
    limit)."""
    receptive = t.numel() // (t.shape[-1] * t.shape[-2])
    uniform_(t, math.sqrt(6.0 / (receptive * (t.shape[-1] + t.shape[-2]))), generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``Dense``'s default kernel init on an (out, in) weight:
    truncated normal over [-2σ, 2σ] with variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_parameters(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialise every port module under ``model`` from one seeded generator
    on the device the parameters live on."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    for module in model.modules():
        init = getattr(module, "init_weights", None)
        if init is not None:
            init(generator)
    return model
