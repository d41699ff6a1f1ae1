"""Convolutional feature extractors (counterpart of ``tpurec/ops/conv.py``):
CCPM's and FGCNN's blocks, k-max pooling and DeepCrossing's residual unit.

Feature maps are in flax's NHWC layout at every module boundary,
(B, fields, embed_dim, channels), so each reshape (CCPM's output, FGCNN's
``recombine`` input) flattens in the JAX package's order and its weights
mean the same here. ``Conv`` pads the NCHW view of that tensor for cuDNN
and returns the NHWC view of its output.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.initializers import lecun_normal_
from tpurec_torch.ops.mlp import Dense, _compute_dtype


def k_max_pool(x: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
    """The ``k`` largest values along ``dim``, in descending order, as
    ``jnp.sort`` (stable, ascending), flipped, then the first ``k``: among
    tied values the later index is taken, and gets the gradient.
    (``torch.sort(descending=True)`` or ``topk`` would take the earlier.)"""
    top = torch.sort(x, dim=dim, stable=True).values.flip(dim)
    return top.narrow(dim, 0, k)


class Conv(nn.Module):
    """flax ``nn.Conv(out_channels, kernel_size=(width, 1), padding="SAME")``
    on an NHWC input: ``kernel`` is flax's raw (width, 1, C_in, C_out)
    parameter (lecun normal with fan-in width·C_in), ``bias`` (C_out,)
    zeros; input, kernel and bias in the compute dtype. "SAME" pads width − 1
    rows of the field axis, (width − 1) // 2 before, as lax does (2 before
    and 3 after at width 6)."""

    def __init__(self, in_channels: int, out_channels: int, width: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(width, 1, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def init_weights(self, generator: torch.Generator) -> None:
        width, _, c_in, _ = self.kernel.shape
        lecun_normal_(self.kernel, generator, fan_in=width * c_in)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.kernel, self.dtype)
        width = self.kernel.shape[0]
        before = (width - 1) // 2
        x = F.pad(x.to(dt).permute(0, 3, 1, 2), (0, 0, before, width - 1 - before))
        weight = self.kernel.to(dt).permute(3, 2, 0, 1)  # (C_out, C_in, width, 1)
        return F.conv2d(x, weight, self.bias.to(dt)).permute(0, 2, 3, 1)


def ccpm_pool_sizes(num_fields: int, levels: int) -> Tuple[int, ...]:
    """CCPM's k a level: 3 at the last, max(3, ⌊(1 − ((i+1)/n)^(n−i−1))·F⌋)
    before it, each at most the fields left (``tpurec/ops/conv.py:63-69``)."""
    sizes, fields = [], num_fields
    for i in range(levels):
        if i == levels - 1:
            k = 3
        else:
            k = max(3, int((1 - ((i + 1) / levels) ** (levels - i - 1)) * num_fields))
        fields = min(k, fields)
        sizes.append(fields)
    return tuple(sizes)


class CCPMBlock(nn.Module):
    """``conv`` over the field axis, tanh, then k-max pooling of the fields."""

    def __init__(self, in_channels: int, num_filters: int, kernel_width: int, pool_k: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pool_k = pool_k
        self.conv = Conv(in_channels, num_filters, kernel_width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return k_max_pool(torch.tanh(self.conv(x)), self.pool_k, dim=1)


class CCPM(nn.Module):
    """Stacked ``block_{i}`` with CCPM's per-level k: (B, F, D) →
    (B, k_last·D·filters_last), flattened in NHWC order."""

    def __init__(self, num_fields: int, dim: int, num_filters: Sequence[int] = (4, 4),
                 kernel_widths: Sequence[int] = (6, 5), dtype: Optional[torch.dtype] = None):
        super().__init__()
        pools = ccpm_pool_sizes(num_fields, len(num_filters))
        channels = 1
        for i, (filters, width, k) in enumerate(zip(num_filters, kernel_widths, pools)):
            self.add_module(f"block_{i}", CCPMBlock(channels, filters, width, k, dtype))
            channels = filters
        self.out_features = pools[-1] * dim * channels
        self.levels = len(pools)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x = emb[..., None]
        for i in range(self.levels):
            x = getattr(self, f"block_{i}")(x)
        return x.reshape(emb.shape[0], -1)


class FGCNNBlock(nn.Module):
    """``conv``, tanh, a (pool_width, 1) max-pool of stride pool_width
    (VALID), then ``recombine`` (Dense over the map flattened in NHWC order)
    and tanh: (B, F, D, C) → (pooled (B, F', D, filters), new features
    (B, F'·new_maps, D)), F' = ⌊F / pool_width⌋."""

    def __init__(self, num_fields: int, dim: int, in_channels: int, num_filters: int,
                 kernel_width: int, pool_width: int, new_maps: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.pool_width, self.new_maps = pool_width, new_maps
        self.out_fields = num_fields // pool_width
        self.conv = Conv(in_channels, num_filters, kernel_width, dtype)
        self.recombine = Dense(self.out_fields * dim * num_filters,
                               self.out_fields * dim * new_maps, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.tanh(self.conv(x)).permute(0, 3, 1, 2)
        h = F.max_pool2d(h, (self.pool_width, 1)).permute(0, 2, 3, 1)
        b, f2, d, _ = h.shape
        new = torch.tanh(self.recombine(h.reshape(b, -1)))
        return h, new.reshape(b, f2 * self.new_maps, d)


class FGCNN(nn.Module):
    """Stacked ``block_{i}``; the generated features of every level
    concatenated along the field axis, (B, F, D) → (B, out_fields, D)."""

    def __init__(self, num_fields: int, dim: int, num_filters: Sequence[int] = (14, 16),
                 kernel_widths: Sequence[int] = (7, 7), pool_widths: Sequence[int] = (2, 2),
                 new_maps: Sequence[int] = (3, 3), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.levels = len(num_filters)
        fields, channels, self.out_fields = num_fields, 1, 0
        for i in range(self.levels):
            block = FGCNNBlock(fields, dim, channels, num_filters[i], kernel_widths[i],
                               pool_widths[i], new_maps[i], dtype)
            self.add_module(f"block_{i}", block)
            fields, channels = block.out_fields, num_filters[i]
            self.out_fields += fields * new_maps[i]

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        x, generated = emb[..., None], []
        for i in range(self.levels):
            x, new = getattr(self, f"block_{i}")(x)
            generated.append(new)
        return torch.cat(generated, dim=1)


class ResidualBlock(nn.Module):
    """DeepCrossing's residual unit: relu(x + ``fc2``(relu(``fc1``(x))))."""

    def __init__(self, in_features: int, hidden_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, in_features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(x + self.fc2(torch.relu(self.fc1(x))))
