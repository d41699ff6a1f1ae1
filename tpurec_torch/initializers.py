"""Seeded parameter initialisation (the flax initializers the JAX package uses).

Every port module that owns parameters defines ``init_weights(generator)``
for its OWN parameters (not its children's); ``init_parameters`` walks the
module tree once with one ``torch.Generator``. The numbers differ from JAX's
for the same seed: tests move weights across with ``tpurec_torch.bridge``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
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


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator,
                  fan_in: Optional[int] = None) -> None:
    """flax ``lecun_normal``: truncated normal over [-2σ, 2σ] with variance
    1/fan_in. ``fan_in`` defaults to an (out, in) Dense weight's; a flax
    conv kernel (w, 1, C_in, C_out) passes its w·C_in."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def orthogonal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``orthogonal()`` (the recurrent cells' ``recurrent_kernel_init``):
    a normal matrix's QR factor with the signs of R's diagonal folded in, so
    the draw is uniform over the orthogonal matrices. A square (H, H)
    kernel is orthogonal in either layout."""
    with torch.no_grad():
        nn.init.orthogonal_(weight, generator=generator)


# --------------------------------------------------------------------------
# JAX's threefry normals, for the constants the JAX package draws from a
# fixed key inside a module (MIND's routing-logit init, ``jax.random.normal(
# jax.random.key(7), (1, K, L))``): the same values, computed with numpy.
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's single-precision erfinv (M. Giles' polynomials), highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                 -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                 -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k1: int, k2: int, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under key
    (k1, k2), 20 rounds, as ``jax/_src/prng.py:_threefry2x32_lowering``."""
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl32(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def _erfinv32(x: np.ndarray) -> np.ndarray:
    w = -np.log1p(-x * x)
    small = w < np.float32(5.0)
    ws, wl = w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)
    ps, pl = np.float32(_ERFINV_SMALL[0]), np.float32(_ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        ps, pl = np.float32(cs) + ps * ws, np.float32(cl) + pl * wl
    return np.where(small, ps, pl) * x


def jax_normal(seed: int, n: int) -> np.ndarray:
    """The first ``n`` values (fp32) of ``jax.random.normal(jax.random.key(
    seed), shape)`` over the flat index, for a 32-bit ``seed`` under
    ``jax_threefry_partitionable`` (the JAX package's setting): a shape of
    ``n`` elements gets these values in row-major order.

    Bits: threefry of the 64-bit element index with key (0, seed), the two
    words xor-ed (``prng.py:_threefry_random_bits_partitionable``); uniform
    on [nextafter(-1, 0), 1) from the top 23 bits (``random.py:_uniform``);
    then √2·erfinv (``random.py:_normal_real``) with XLA's fp32 erfinv, so a
    value is within a few ulp of JAX's."""
    idx = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = _threefry2x32(
            0, seed, (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
        )
    bits = hi ^ lo
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    low = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(low, unit * (np.float32(1.0) - low) + low)
    return np.float32(math.sqrt(2.0)) * _erfinv32(u)


def draw_share_(param: torch.Tensor, draw, split: Optional[Tuple[int, int, int]]) -> None:
    """``draw(t)`` on ``param``; with ``split`` = (dim, index, n) ``param`` is
    rank ``index``'s share of a tensor n times as long on ``dim``: the whole
    tensor is drawn (its fans, and the generator's advance, are the
    one-device draw's) and the share kept, so the shares of every rank make
    the one-device tensor bit for bit."""
    if split is None:
        draw(param)
        return
    dim, index, n = split
    shape = list(param.shape)
    size = shape[dim]
    shape[dim] = size * n
    whole = param.new_empty(shape)
    draw(whole)
    with torch.no_grad():
        param.copy_(whole.narrow(dim, index * size, size))


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
