"""FiBiNET++, MaskNet (serial and parallel) and ContextNet (counterpart of
``tpurec/models/fibinetpp.py``).

The three share ``_NormEmbedBase.norm_embed``: the categorical field
embeddings through ``cat_bn`` (flax's ``BatchNorm`` over (B, F·D) with
``dtype``), and each continuous feature as its value times a learned
embedding (a row of ``cont_emb`` (C, D), glorot uniform) through
``cont_ln``, appended as C more fields. Child modules keep the flax names,
so weights map across by path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.models.base import Inputs, Outputs, binary_output, stack_continuous, stack_ids
from tpurec_torch.ops.interactions import _pairs
from tpurec_torch.ops.mlp import MLP, BatchNorm, Dense, LayerNorm


class _NormEmbedBase(nn.Module):
    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.continuous_names = list(continuous_names)
        self.embed_dim = embed_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        n_cat, n_cont = len(self.feature_names), len(self.continuous_names)
        self.num_fields = n_cat + n_cont
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.cat_bn = BatchNorm(n_cat * embed_dim, dtype=dtype)
        self.cont_emb = nn.Parameter(torch.empty(n_cont, embed_dim)) if n_cont else None
        self.cont_ln = LayerNorm(embed_dim, dtype) if n_cont else None

    def init_weights(self, generator: torch.Generator) -> None:
        if self.cont_emb is not None:
            glorot_uniform_(self.cont_emb, generator)

    def norm_embed(self, inputs: Inputs) -> torch.Tensor:
        """(B, F + C, D): the batch-normalised categorical embeddings, then
        the layer-normalised value-scaled continuous ones."""
        emb = self.emb(stack_ids(inputs, self.feature_names))
        b, f, d = emb.shape
        emb = self.cat_bn(emb.reshape(b, f * d)).reshape(b, f, d)
        cont = stack_continuous(inputs, self.continuous_names)
        if cont is not None:
            scaled = cont[..., None].to(emb.dtype) * self.cont_emb.to(emb.dtype)[None]
            emb = torch.cat([emb, self.cont_ln(scaled)], dim=1)
        return emb


class FiBiNetPlusPlus(_NormEmbedBase):
    """Bilinear+ ∥ SENet+ → MLP → ``head``. Bilinear+: the scalar
    (e_i·W)·e_j of every field pair (``bilinear_w`` (D, D)), then
    ``bilinear_reduce``; SENet+: each field's ``senet_groups`` group means
    and maxima, ``se_squeeze`` (relu) and ``se_excite`` over F·D, the
    embeddings times 2σ(excitation), then ``se_ln``."""

    def __init__(self, *args, senet_groups: int = 2, reduction: int = 3, reduce_dim: int = 32, **kw):
        super().__init__(*args, **kw)
        f, d, g = self.num_fields, self.embed_dim, senet_groups
        if d % g:
            raise ValueError(f"embed_dim {d} not divisible by senet_groups {g}")
        self.senet_groups = g
        self.bilinear_w = nn.Parameter(torch.empty(d, d))
        self.bilinear_reduce = Dense(f * (f - 1) // 2, reduce_dim, self.dtype)
        mid = max(1, (f * 2 * g) // reduction)
        self.se_squeeze = Dense(f * 2 * g, mid, self.dtype)
        self.se_excite = Dense(mid, f * d, self.dtype)
        self.se_ln = LayerNorm(f * d, self.dtype)
        self.mlp = MLP(reduce_dim + f * d, self.hidden_dims, dtype=self.dtype)
        self.head = Dense(self.hidden_dims[-1], 1, self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        glorot_uniform_(self.bilinear_w, generator)

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.norm_embed(inputs)
        b, f, d = emb.shape
        # (e_i·W)·e_j for every pair: all F × F products in one batched
        # product, then the upper triangle (no (B, P, D) gathers)
        iu, ju = _pairs(emb)
        left = emb @ self.bilinear_w.to(emb.dtype)
        scalars = torch.matmul(left, emb.transpose(1, 2))[:, iu, ju]
        bilinear = self.bilinear_reduce(scalars)
        g = self.senet_groups
        grouped = emb.reshape(b, f, g, d // g)
        squeeze = torch.cat([grouped.mean(dim=-1), grouped.amax(dim=-1)], dim=-1).reshape(b, f * 2 * g)
        excite = self.se_excite(F.relu(self.se_squeeze(squeeze)))
        se = self.se_ln(emb.reshape(b, f * d) * (2.0 * torch.sigmoid(excite)))
        x = torch.cat([bilinear, se], dim=-1)
        return binary_output(self.head(self.mlp(x)))


class MaskBlock(nn.Module):
    """Instance-guided mask block: relu(``ln``(``hidden``(v ⊙ mask))) with
    mask = ``mask_fc2``(relu(``mask_fc1``(mask input)))."""

    def __init__(self, in_features: int, mask_features: int, hidden_dim: int, mask_hidden: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mask_fc1 = Dense(mask_features, mask_hidden, dtype)
        self.mask_fc2 = Dense(mask_hidden, in_features, dtype)
        self.hidden = Dense(in_features, hidden_dim, dtype)
        self.ln = LayerNorm(hidden_dim, dtype)

    def forward(self, v: torch.Tensor, v_mask_input: torch.Tensor) -> torch.Tensor:
        m = self.mask_fc2(F.relu(self.mask_fc1(v_mask_input)))
        return F.relu(self.ln(self.hidden(v * m)))


class MaskNet(_NormEmbedBase):
    """``num_blocks`` mask blocks (``block_{i}``), each guided by the
    flattened embeddings: ``'serial'`` chains them into ``head``;
    ``'parallel'`` runs each on the embeddings and concatenates them into
    ``mlp`` → ``head``."""

    def __init__(self, *args, mode: str = "parallel", num_blocks: int = 3, block_dim: int = 64, **kw):
        super().__init__(*args, **kw)
        if mode not in ("serial", "parallel"):
            raise ValueError(f"unknown MaskNet mode {mode!r}")
        self.mode, self.num_blocks = mode, num_blocks
        flat = self.num_fields * self.embed_dim
        for i in range(num_blocks):
            width = flat if mode == "parallel" or i == 0 else block_dim
            self.add_module(f"block_{i}", MaskBlock(width, flat, block_dim, dtype=self.dtype))
        if mode == "parallel":
            self.mlp = MLP(num_blocks * block_dim, self.hidden_dims, dtype=self.dtype)
        self.head = Dense(block_dim if mode == "serial" else self.hidden_dims[-1], 1, self.dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.norm_embed(inputs)
        flat = emb.reshape(emb.shape[0], -1)
        blocks = [getattr(self, f"block_{i}") for i in range(self.num_blocks)]
        if self.mode == "serial":
            h = flat
            for block in blocks:
                h = block(h, flat)
        else:
            h = self.mlp(torch.cat([block(flat, flat) for block in blocks], dim=-1))
        return binary_output(self.head(h))


class ContextNet(_NormEmbedBase):
    """Contextual embedding, then ``num_blocks`` per-field feed-forward
    blocks: each field's embedding times its mask ``ctx_agg``(context) ·
    ``ctx_proj`` (F, A, D); a block is h ← ``ln_{i}``(relu(ff(h)) + h) with
    ff a shared ``ffn_{i}`` (D, D, no bias; ``'pointwise'``) or a per-field
    ``ffn_w_{i}`` (F, D, D; ``'singlelayer'``); then ``mlp`` → ``head``."""

    def __init__(self, *args, num_blocks: int = 2, block_mode: str = "pointwise", agg_dim: int = 64,
                 **kw):
        super().__init__(*args, **kw)
        if block_mode not in ("pointwise", "singlelayer"):
            raise ValueError(f"unknown ContextNet block_mode {block_mode!r}")
        f, d = self.num_fields, self.embed_dim
        self.num_blocks, self.block_mode = num_blocks, block_mode
        self.ctx_agg = Dense(f * d, agg_dim, self.dtype)
        self.ctx_proj = nn.Parameter(torch.empty(f, agg_dim, d))
        for i in range(num_blocks):
            if block_mode == "pointwise":
                self.add_module(f"ffn_{i}", Dense(d, d, self.dtype, use_bias=False))
            else:
                self.register_parameter(f"ffn_w_{i}", nn.Parameter(torch.empty(f, d, d)))
            self.add_module(f"ln_{i}", LayerNorm(d, self.dtype))
        self.mlp = MLP(f * d, self.hidden_dims, dtype=self.dtype)
        self.head = Dense(self.hidden_dims[-1], 1, self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        glorot_uniform_(self.ctx_proj, generator)
        if self.block_mode == "singlelayer":
            for i in range(self.num_blocks):
                glorot_uniform_(getattr(self, f"ffn_w_{i}"), generator)

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.norm_embed(inputs)
        b, f, d = emb.shape
        agg = F.relu(self.ctx_agg(emb.reshape(b, f * d)))
        h = emb * torch.einsum("ba,fad->bfd", agg, self.ctx_proj.to(emb.dtype))
        for i in range(self.num_blocks):
            if self.block_mode == "pointwise":
                ff = getattr(self, f"ffn_{i}")(h)
            else:
                ff = torch.einsum("bfd,fde->bfe", h, getattr(self, f"ffn_w_{i}").to(h.dtype))
            h = getattr(self, f"ln_{i}")(F.relu(ff) + h)
        return binary_output(self.head(self.mlp(h.reshape(b, -1))))
