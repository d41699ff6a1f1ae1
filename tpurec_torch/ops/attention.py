"""Attention ops (counterpart of ``tpurec/ops/attention.py``): masked
scaled-dot multi-head attention (AutoInt's field self-attention, and the
sequence models' encoders later) and DIN's target attention.

Masks are 1 = keep; a masked logit becomes −1e9 and the softmax runs in
fp32. The JAX package's ``MultiHeadAttention`` shards its projections over
a ``'model'`` mesh axis; on the port's mesh they are whole on every rank,
which changes where they live, not what they compute (their tensor-parallel
placement is ROADMAP slice 7).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.ops import kernels
from tpurec_torch.ops.mlp import MLP, Dense, LayerNorm

_NEG_INF = -1e9


def scaled_dot_attention(
    q: torch.Tensor,  # (B, H, Lq, Dh)
    k: torch.Tensor,  # (B, H, Lk, Dh)
    v: torch.Tensor,  # (B, H, Lk, Dv)
    mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Lq, Lk); 1 = keep
) -> torch.Tensor:
    """softmax(q·kᵀ/√Dh)·v with the JAX package's roundings: the logits
    in q's dtype, then fp32 times the fp32 scale; the softmax in fp32; its
    weights in v's dtype for the second product. Written as two products,
    not ``F.scaled_dot_product_attention``, whose fused kernels round
    elsewhere."""
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))  # JAX's fp32 value
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        logits = torch.where(mask.to(torch.bool), logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def expand_mask(mask: Optional[torch.Tensor], q_len: int, k_len: int) -> Optional[torch.Tensor]:
    """A (B, Lk) key mask or a (B, Lq, Lk) pair mask as (B, 1, Lq, Lk)."""
    if mask is None:
        return None
    if mask.dim() == 2:
        mask = mask[:, None, :] * mask.new_ones((1, q_len, 1))
    return mask[:, None, :, :]


class MultiHeadAttention(nn.Module):
    """Masked multi-head attention of (B, Lq, D) queries over (B, Lk,
    ``kv_dim``) keys and values (the queries themselves when ``kv`` is
    None): ``q``/``k``/``v`` projections to ``num_heads`` × ``head_dim``
    without bias, ``scaled_dot_attention``, the ``out`` projection back to
    D, the residual when ``use_residual`` and ``ln`` (``LayerNorm``); all
    in ``dtype``. (The JAX module's ``out_dim``, ``use_layer_norm=False``
    and dropout come with the first ported model that sets them.)"""

    def __init__(self, dim: int, num_heads: int, head_dim: int, kv_dim: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None, use_residual: bool = True):
        super().__init__()
        kv_dim = dim if kv_dim is None else kv_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.residual = use_residual
        width = num_heads * head_dim
        self.q = Dense(dim, width, dtype, use_bias=False)
        self.k = Dense(kv_dim, width, dtype, use_bias=False)
        self.v = Dense(kv_dim, width, dtype, use_bias=False)
        self.out = Dense(width, dim, dtype)
        self.ln = LayerNorm(dim, dtype)

    def forward(
        self,
        q: torch.Tensor,  # (B, Lq, D)
        kv: Optional[torch.Tensor] = None,  # (B, Lk, kv_dim)
        mask: Optional[torch.Tensor] = None,  # (B, Lk) or (B, Lq, Lk)
    ) -> torch.Tensor:
        kv = q if kv is None else kv
        b, lq, _ = q.shape
        lk = kv.shape[1]
        h, dh = self.num_heads, self.head_dim

        def heads(x, proj, length):
            return proj(x).reshape(b, length, h, dh).transpose(1, 2)

        out = scaled_dot_attention(heads(q, self.q, lq), heads(kv, self.k, lk),
                                   heads(kv, self.v, lk), expand_mask(mask, lq, lk))
        out = self.out(out.transpose(1, 2).reshape(b, lq, h * dh))
        if self.residual:
            out = out + q
        return self.ln(out)


class DinTargetAttention(nn.Module):
    """DIN activation-unit target attention over a behavior sequence.

    Per step t: score_t = MLP([q, q−k_t, k_t, q⊙k_t]) → scalar; masked scores
    weight a sum-pool over the sequence. Returns (pooled (B, D), scores (B, L)).

    Kernel form (one relu/prelu hidden layer, no outer product): explicit
    ``w1`` (4D, H), ``b1`` (H,), ``w2`` (H, 1) and ``alpha`` (H,) params, the
    same as the JAX package's. Query and keys go to the attention in fp32
    through ``kernels.DinAttention`` (forward and backward kernels on the
    card, their plain versions on the CPU; without grad only its forward
    runs). Pooled comes back in the keys' dtype,
    scores stay fp32 (``tpurec/ops/attention.py:159-162``). Any other
    configuration runs the generic MLP form (``act_mlp``).
    """

    def __init__(
        self,
        dim: int,
        hidden_dims: Sequence[int] = (36,),
        use_outer_product: bool = False,
        activation: str = "prelu",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.use_outer_product = use_outer_product
        self.kernel_form = (
            len(hidden_dims) == 1
            and activation in ("relu", "prelu")
            and not use_outer_product
        )
        if self.kernel_form:
            h = hidden_dims[0]
            self.w1 = nn.Parameter(torch.empty(4 * dim, h))
            self.b1 = nn.Parameter(torch.empty(h))
            self.w2 = nn.Parameter(torch.empty(h, 1))
            self.alpha = nn.Parameter(torch.empty(h)) if activation == "prelu" else None
        else:
            in_features = 4 * dim + (dim * dim if use_outer_product else 0)
            self.act_mlp = MLP(
                in_features,
                hidden_dims + (1,),
                activation=activation,
                out_activation="linear",
                dtype=dtype,
            )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.kernel_form:
            glorot_uniform_(self.w1, generator)
            nn.init.zeros_(self.b1)
            glorot_uniform_(self.w2, generator)
            if self.alpha is not None:
                nn.init.constant_(self.alpha, 0.25)

    def forward(
        self,
        query: torch.Tensor,  # (B, D)
        keys: torch.Tensor,  # (B, L, D)
        mask: Optional[torch.Tensor] = None,  # (B, L) 1 = real step
    ):
        b, l, d = keys.shape
        if self.kernel_form:
            m = mask if mask is not None else keys.new_ones((b, l), dtype=torch.float32)
            args = (
                query.to(torch.float32), keys.to(torch.float32), m,
                self.w1, self.b1, self.w2[:, 0], self.alpha,
            )
            pooled, scores = kernels.DinAttention.apply(*args)
            return pooled.to(keys.dtype), scores
        q = query[:, None, :].expand(b, l, d)
        feats = [q, q - keys, keys, q * keys]
        if self.use_outer_product:
            feats.append(torch.einsum("bld,ble->blde", q, keys).reshape(b, l, d * d))
        x = self.act_mlp(torch.cat(feats, dim=-1))
        scores = x.reshape(b, l).to(torch.float32)
        if mask is not None:
            scores = torch.where(mask != 0, scores, 0.0)
        pooled = torch.einsum("bl,bld->bd", scores.to(keys.dtype), keys)
        return pooled, scores
