"""DIN target attention (counterpart of ``DinTargetAttention`` in
``tpurec/ops/attention.py``). ``MultiHeadAttention`` comes with the models
that use it."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.ops import kernels
from tpurec_torch.ops.mlp import MLP


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
