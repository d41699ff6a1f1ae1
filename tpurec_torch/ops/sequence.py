"""Sequence ops (counterpart of ``tpurec/ops/sequence.py``): the masked GRU
and LSTM, DIEN's attention-gated GRU family (AUGRU, AGRU, AIGRU), and the
position encodings.

The JAX package runs each recurrence as one ``lax.scan`` over flax's cells;
here each is a Python loop over the time axis with one set of cell
parameters. The input products of every step are taken for all L steps in
one product before the loop, and split into per-step views with
``unbind`` (whose backward stacks the L gradients once; a slice a step
would write a zeroed (B, L, ·) gradient a step); the recurrent products and
the gate arithmetic run one step at a time. (cuDNN's ``nn.GRU``/``nn.LSTM`` cannot take their
place: the carry is fp32 while the products run in the compute dtype, a
mask need not be a prefix, and the LSTM's padded steps output 0.)

Dtypes follow flax's cells: the GRU and LSTM carries start at zeros in the
parameter dtype (fp32), each Dense layer casts its input to the compute
``dtype`` and returns that dtype, so in a bf16 model the gate mix is
promoted back to fp32 and ``MaskedGRU``, ``MaskedLSTM`` and
``MaskedBiLSTM`` return fp32. ``AttentionGRU``'s carry starts at zeros in
the input's dtype.

A padded step (mask 0) keeps the previous carry, as ``keep·new + (1 −
keep)·old``. ``MaskedGRU``'s output at that step is the kept carry; the
LSTMs' output there is 0 (``keep·y``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.ops.mlp import Dense, _compute_dtype

_GRU_GATES = ("r", "z", "n")
_LSTM_GATES = ("i", "f", "g", "o")


def _keep(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The (B, L, 1) step mask (ones without a mask)."""
    if mask is None:
        return x.new_ones(x.shape[:2] + (1,), dtype=x.dtype)
    return mask[..., None]


def _stacked(layers, x: torch.Tensor, bias: bool, dtype: Optional[torch.dtype]):
    """The Dense ``layers``' weights side by side as one (Σout, in) weight,
    cast to the compute dtype for an input like ``x``, and their biases
    (zeros for a layer without one) when ``bias``."""
    dt = _compute_dtype(x, layers[0].weight, dtype)
    weight = torch.cat([layer.weight for layer in layers]).to(dt)
    if not bias:
        return weight, None, dt
    b = torch.cat([
        layer.bias if layer.bias is not None else layer.weight.new_zeros(layer.weight.shape[0])
        for layer in layers
    ]).to(dt)
    return weight, b, dt


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``'s parameters: the input Dense layers ``ir``,
    ``iz``, ``in`` (lecun normal, with bias) and the hidden-state ones
    ``hr``, ``hz`` (orthogonal, no bias) and ``hn`` (orthogonal, with bias):

        r = σ(ir(x) + hr(h)), z = σ(iz(x) + hz(h)),
        n = tanh(in(x) + r·hn(h)), h' = (1 − z)·n + z·h.
    """

    def __init__(self, in_features: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in _GRU_GATES:
            self.add_module(f"i{g}", Dense(in_features, hidden, dtype))
            self.add_module(f"h{g}", Dense(hidden, hidden, dtype, "orthogonal", use_bias=g == "n"))

    def scan(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """All L states (B, L, H) of the masked recurrence over x (B, L, D)."""
        hd = self.hidden
        w_i, b_i, _ = _stacked([getattr(self, f"i{g}") for g in _GRU_GATES], x, True, self.dtype)
        xi = F.linear(x.to(w_i.dtype), w_i, b_i).unbind(1)  # every step's input products
        h = x.new_zeros((x.shape[0], hd), dtype=self.hr.weight.dtype)
        w_h, b_h, dt = _stacked([getattr(self, f"h{g}") for g in _GRU_GATES], h, True, self.dtype)
        keep = _keep(mask, x).unbind(1)
        ys = []
        for gi, k in zip(xi, keep):
            gh = F.linear(h.to(dt), w_h, b_h)
            rz = torch.sigmoid(gi[:, : 2 * hd] + gh[:, : 2 * hd])
            r, z = rz[:, :hd], rz[:, hd:]
            n = torch.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
            new = (1.0 - z) * n + z * h
            k = k.to(new.dtype)
            h = k * new + (1 - k) * h
            ys.append(h)
        return torch.stack(ys, dim=1)


class MaskedGRU(nn.Module):
    """GRU returning all hidden states (B, L, H); a padded step carries the
    previous state through unchanged, and that state is its output. The
    cell is ``cell`` (``GRUCell``)."""

    def __init__(self, in_features: int, hidden_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cell = GRUCell(in_features, hidden_dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.cell.scan(x, mask)


class AttentionGRU(nn.Module):
    """DIEN's interest-evolution recurrence over x (B, L, D) gated by the
    attention scores (B, L); returns the final state (B, H):

    - ``'augru'``: h' = (1 − a·u)·h + a·u·h̃;
    - ``'agru'``: h' = (1 − a)·h + a·h̃;
    - ``'aigru'``: a plain ``MaskedGRU`` (``gru``) over a∘x, its last step;

    with u = σ(wu(x) + uu(h)), r = σ(wr(x) + ur(h)), h̃ = tanh(wh(x) +
    uh(r·h)), six biased Dense layers (lecun normal). The carry starts at
    zeros in x's dtype; a padded step keeps it."""

    def __init__(self, in_features: int, hidden_dim: int, mode: str = "augru",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if mode not in ("augru", "agru", "aigru"):
            raise ValueError(f"unknown AttentionGRU mode {mode!r}")
        self.mode, self.hidden, self.dtype = mode, hidden_dim, dtype
        if mode == "aigru":
            self.gru = MaskedGRU(in_features, hidden_dim, dtype)
            return
        for name in ("u", "r", "h"):
            self.add_module(f"w{name}", Dense(in_features, hidden_dim, dtype))
            self.add_module(f"u{name}", Dense(hidden_dim, hidden_dim, dtype))

    def forward(self, x: torch.Tensor, scores: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.mode == "aigru":
            return self.gru(x * scores[..., None].to(x.dtype), mask)[:, -1]
        hd = self.hidden
        w_x, b_x, _ = _stacked([self.wu, self.wr, self.wh], x, True, self.dtype)
        xw = F.linear(x.to(w_x.dtype), w_x, b_x).unbind(1)  # wu, wr, wh of every step
        h = x.new_zeros((x.shape[0], hd))
        w_h, b_h, dt = _stacked([self.uu, self.ur], h, True, self.dtype)
        w_uh, b_uh, _ = _stacked([self.uh], h, True, self.dtype)
        for xt, a, k in zip(xw, scores[..., None].unbind(1), _keep(mask, x).unbind(1)):
            ur = torch.sigmoid(xt[:, : 2 * hd] + F.linear(h.to(dt), w_h, b_h))
            u, r = ur[:, :hd], ur[:, hd:]
            h_tilde = torch.tanh(xt[:, 2 * hd:] + F.linear((r * h).to(dt), w_uh, b_uh))
            a = a.to(h.dtype)
            if self.mode == "augru":
                gate = a * u
            else:  # 'agru': a in the dtype a·ones_like(u) has
                gate = a.to(torch.promote_types(a.dtype, u.dtype)).expand_as(u)
            new = (1 - gate) * h + gate * h_tilde
            k = k.to(h.dtype)
            h = k * new + (1 - k) * h
        return h


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``'s parameters: the input Dense layers
    ``ii``, ``if``, ``ig``, ``io`` (lecun normal, no bias) and the
    hidden-state ones ``hi``, ``hf``, ``hg``, ``ho`` (orthogonal, with
    bias), gates in the order i, f, g, o:

        c' = f·c + i·g, h' = o·tanh(c').
    """

    def __init__(self, in_features: int, hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in _LSTM_GATES:
            self.add_module(f"i{g}", Dense(in_features, hidden, dtype, use_bias=False))
            self.add_module(f"h{g}", Dense(hidden, hidden, dtype, "orthogonal"))

    def scan(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The outputs (B, L, H) of the masked recurrence over x (B, L, D):
        each step's h', 0 at a padded step."""
        hd = self.hidden
        w_i, _, _ = _stacked([getattr(self, f"i{g}") for g in _LSTM_GATES], x, False, self.dtype)
        xi = F.linear(x.to(w_i.dtype), w_i, None).unbind(1)  # every step's input products
        c = x.new_zeros((x.shape[0], hd), dtype=self.hi.weight.dtype)
        h = torch.zeros_like(c)
        w_h, b_h, dt = _stacked([getattr(self, f"h{g}") for g in _LSTM_GATES], h, True, self.dtype)
        ys = []
        for gi, k in zip(xi, _keep(mask, x).unbind(1)):
            gates = F.linear(h.to(dt), w_h, b_h) + gi
            sig = torch.sigmoid(gates)
            i, f, o = sig[:, :hd], sig[:, hd: 2 * hd], sig[:, 3 * hd:]
            g = torch.tanh(gates[:, 2 * hd: 3 * hd])
            new_c = f * c + i * g
            y = o * torch.tanh(new_c)
            k = k.to(y.dtype)
            c = k * new_c + (1 - k) * c
            h = k * y + (1 - k) * h
            ys.append(k * y)
        return torch.stack(ys, dim=1)


class MaskedLSTM(nn.Module):
    """Stacked unidirectional LSTM (``layer_{i}``, each an ``LSTMCell``)
    returning the top layer's outputs (B, L, H); a padded step keeps the
    carry and outputs 0."""

    def __init__(self, in_features: int, hidden_dim: int, num_layers: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            width = in_features if layer == 0 else hidden_dim
            self.add_module(f"layer_{layer}", LSTMCell(width, hidden_dim, dtype))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in range(self.num_layers):
            x = getattr(self, f"layer_{layer}").scan(x, mask)
        return x


class MaskedBiLSTM(nn.Module):
    """Bidirectional LSTM: ``fwd`` over the sequence, ``bwd`` over the
    flipped sequence and mask, its outputs flipped back and concatenated
    after ``fwd``'s → (B, L, 2H)."""

    def __init__(self, in_features: int, hidden_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fwd = LSTMCell(in_features, hidden_dim, dtype)
        self.bwd = LSTMCell(in_features, hidden_dim, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        fwd = self.fwd.scan(x, mask)
        flipped = None if mask is None else torch.flip(mask, dims=(1,))
        bwd = self.bwd.scan(torch.flip(x, dims=(1,)), flipped)
        return torch.cat([fwd, torch.flip(bwd, dims=(1,))], dim=-1)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal position table (length, dim), fp32: sin on even
    columns, cos on odd ones (``tpurec/ops/sequence.py:204-213``)."""
    pos = np.arange(length)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    table = np.zeros((length, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class LearnedPositionEmbedding(nn.Module):
    """A learned position table ``pos`` (max_length, dim), fp32, N(0, 0.02²);
    ``forward(length)`` returns its first ``length`` rows in ``dtype``."""

    def __init__(self, max_length: int, dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.pos = nn.Parameter(torch.empty(max_length, dim))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.pos.normal_(0.0, 0.02, generator=generator)

    def forward(self, length: int) -> torch.Tensor:
        out = self.pos[:length]
        return out.to(self.dtype) if self.dtype is not None else out

