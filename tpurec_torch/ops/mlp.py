"""Dense tower building blocks: ``Dense``, ``MLP``, ``PReLU`` and ``Dice``
(counterpart of ``tpurec/ops/mlp.py``), and flax's ``BatchNorm`` and
``LayerNorm``.

Parameters are fp32; matmuls run in the module's compute ``dtype`` (bf16 in
production, as the JAX package's trainer sets it). Normalisation statistics
are computed in fp32. Child modules keep the flax names (``dense_0``,
``prelu_0``, ``dice_0/bn``...) so weights map across by path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.initializers import glorot_uniform_, lecun_normal_, orthogonal_


def _compute_dtype(x: torch.Tensor, param: torch.Tensor, dtype: Optional[torch.dtype]):
    """flax ``promote_dtype``: the module dtype when set, else the promotion of
    the input's and the parameter's types."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is (out, in) like ``nn.Linear`` (the flax
    kernel transposed), bias zeros (none with ``use_bias=False``); inputs,
    weight and bias are cast to the compute dtype before the product.
    ``kernel_init`` is lecun normal (flax's default), glorot uniform, or
    orthogonal (the recurrent cells' hidden-state kernels)."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        dtype: Optional[torch.dtype] = None,
        kernel_init: str = "lecun_normal",
        use_bias: bool = True,
    ):
        super().__init__()
        if kernel_init not in ("lecun_normal", "glorot_uniform", "orthogonal"):
            raise ValueError(f"unknown kernel_init {kernel_init!r}")
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.dtype = dtype
        self.kernel_init = kernel_init

    def init_weights(self, generator: torch.Generator) -> None:
        if self.kernel_init == "glorot_uniform":
            glorot_uniform_(self.weight, generator)
        elif self.kernel_init == "orthogonal":
            orthogonal_(self.weight, generator)
        else:
            lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.weight, self.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99)`` over every axis but the last:
    ``scale`` (ones) and ``bias`` (zeros) when ``use_scale``/``use_bias``,
    ``epsilon`` 1e-5 by default (``Dice`` takes neither and 1e-9). Its
    ``running_mean``/``running_var`` are flax's ``batch_stats``
    ``mean``/``var``. Statistics and the normalisation are computed in fp32.

    In training mode it normalises with the batch's mean and its *biased*
    variance (flax's E[x²] − E[x]², clipped at 0) and updates the running
    statistics itself, ``r = 0.99·r + 0.01·batch``, with that same biased
    variance (``F.batch_norm`` would update ``running_var`` with the unbiased
    one). In eval mode it normalises with the running statistics.

    The output dtype is flax's: ``dtype`` when it is set (FiBiNET++'s
    ``cat_bn``; the statistics and the normalisation stay fp32), else the
    promotion of the input's and the fp32 parameters' types (fp32 for a
    bf16 input; NFM's ``bn``), or the input's when there are no
    parameters."""

    momentum = 0.99  # flax convention: the weight of the running value

    def __init__(self, num_features: int, use_scale: bool = True, use_bias: bool = True,
                 epsilon: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(num_features)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(num_features)) if use_bias else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.scale is not None:
            nn.init.ones_(self.scale)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1]).float()
        if self.training:
            mean = flat.mean(dim=0)
            var = (torch.square(flat).mean(dim=0) - torch.square(mean)).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(
                    self.momentum * self.running_mean + (1.0 - self.momentum) * mean
                )
                self.running_var.copy_(
                    self.momentum * self.running_var + (1.0 - self.momentum) * var
                )
        else:
            mean, var = self.running_mean, self.running_var
        y = _normalize(flat, mean, var, self.epsilon, self.scale, self.bias)
        if self.dtype is not None:
            return y.reshape(x.shape).to(self.dtype)
        has_params = self.scale is not None or self.bias is not None
        return y.reshape(x.shape).to(torch.promote_types(x.dtype, torch.float32) if has_params else x.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: epsilon 1e-6 (not torch's
    1e-5), ``scale`` (ones) and ``bias`` (zeros); the mean and the variance
    (E[x²] − E[x]², clipped at 0) in fp32 whatever the input's dtype, the
    normalisation in fp32, the result in ``dtype`` (None: the promotion of
    the input's type and fp32)."""

    epsilon = 1e-6

    def __init__(self, num_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (torch.square(x32).mean(dim=-1, keepdim=True) - torch.square(mean)).clamp_min(0.0)
        y = _normalize(x32, mean, var, self.epsilon, self.scale, self.bias)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


def _normalize(x, mean, var, epsilon, scale, bias):
    """flax's ``_normalize`` in fp32: (x − mean)·(rsqrt(var + ε)·scale) + bias."""
    mul = torch.rsqrt(var + epsilon)
    if scale is not None:
        mul = mul * scale
    y = (x - mean) * mul
    return y if bias is None else y + bias


class PReLU(nn.Module):
    """Parametric ReLU with a learnable per-channel slope (init 0.25)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.alpha, 0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        return torch.where(x > 0, x, alpha * x)


class Dice(nn.Module):
    """Data-adaptive activation: p = sigmoid(BN(x)); out = p·x + (1−p)·α·x.
    The BatchNorm has no scale or bias, epsilon 1e-9 and flax momentum 0.99."""

    def __init__(self, num_features: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(num_features))
        self.bn = BatchNorm(num_features, use_scale=False, use_bias=False, epsilon=1e-9)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.alpha)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype)
        p = torch.sigmoid(self.bn(x))
        return p * x + (1.0 - p) * alpha * x


_SIMPLE_ACTS = {"relu": F.relu, "linear": lambda x: x}


class MLP(nn.Module):
    """Multi-layer dense tower.

    ``activation`` applies after every layer; the last layer uses
    ``out_activation`` when it is set and ``activation`` otherwise (so DIN's
    ``MLP((200, 80))`` ends in relu). Activations: relu, linear, prelu and
    dice. (The JAX MLP's other activations, its BatchNorm/LayerNorm options
    and its dropout come with the first ported model that sets them.)
    """

    def __init__(
        self,
        in_features: int,
        hidden_dims: Sequence[int],
        activation: str = "relu",
        out_activation: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        self.acts = []
        n = len(self.hidden_dims)
        width_in = in_features
        for i, width in enumerate(self.hidden_dims):
            self.add_module(f"dense_{i}", Dense(width_in, width, dtype, "glorot_uniform"))
            act = activation
            if i == n - 1 and out_activation is not None:
                act = out_activation
            if act == "prelu":
                self.add_module(f"prelu_{i}", PReLU(width))
            elif act == "dice":
                self.add_module(f"dice_{i}", Dice(width))
            elif act not in _SIMPLE_ACTS:
                raise ValueError(f"unknown activation {act!r}")
            self.acts.append(act)
            width_in = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, act in enumerate(self.acts):
            x = getattr(self, f"dense_{i}")(x)
            if act in ("prelu", "dice"):
                x = getattr(self, f"{act}_{i}")(x)
            else:
                x = _SIMPLE_ACTS[act](x)
        return x
