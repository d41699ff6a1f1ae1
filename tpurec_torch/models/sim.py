"""Long-sequence ranking with a search stage and an exact stage: SIM, CAN
and ETA (counterpart of ``tpurec/models/sim.py``).

Output contract: two 2-class logit heads, ``gsu_logits`` and
``esu_logits`` (fp32), and ``output``, the ESU's positive-class
probability; training uses ``loss='gsu_esu'``. SIM and ETA also return
``topk_indices``, the (B, k) steps their search picked.

Child modules keep the flax names (``emb``, ``{gsu,esu}_mlp``,
``{gsu,esu}_head``, ``esu_rnn``, ``esu_mha``, ``trunk``, ``trunk_rnn``,
``induction_emb_{field}``, ``long_mha``, ``short_mha``), so weights map
across by path. ETA's hash projections are the flax ``constants``
``hash_proj`` (D, n_hash_bits) and ``lsh_self_proj`` (D, lsh_self_bits):
persistent buffers here, drawn as the JAX module draws them
(``jax.random.normal`` of keys 3 and 11, through ``jax_normal``), loaded
exactly by ``params_from_jax``, and seen by no optimizer.

``use_dien_trunk`` composes the port's ``DIEN`` as ``trunk`` (its own
``emb`` table, ``aux_weight`` 0); its fp32 ``trunk_features`` join the ESU
input (CAN: both heads'). A pretrained DIEN is grafted with
``Trainer.init_subtree_from_export(state, export_dir, "trunk")`` and frozen
with ``TrainConfig.freeze_prefixes=('trunk',)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tpurec_torch.core import trace
from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.models.base import Inputs, Outputs, stack_ids
from tpurec_torch.models.din import DIEN, _SeqBase
from tpurec_torch.ops.attention import MultiHeadAttention
from tpurec_torch.ops.hashing import (
    gather_steps,
    hamming_similarity,
    lsh_attention,
    make_projections,
    simhash_bits,
    topk_select,
)
from tpurec_torch.ops.mlp import MLP, Dense
from tpurec_torch.ops.sequence import MaskedGRU


class _LongSeqBase(_SeqBase):
    """DIN's base (the shared ``emb``, the profile, the query and the keys)
    with the long-sequence models' widths and their two-class heads
    ``{name}_mlp`` → ``{name}_head``."""

    def __init__(self, *args, hidden_dims: Sequence[int] = (64, 32), **kw):
        super().__init__(*args, hidden_dims=hidden_dims, **kw)

    def _add_head(self, name: str, in_features: int) -> None:
        self.add_module(f"{name}_mlp", MLP(in_features, self.hidden_dims, dtype=self.dtype))
        self.add_module(f"{name}_head", Dense(self.hidden_dims[-1], 2, self.dtype))

    def _two_class_head(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_mlp")(x)
        return getattr(self, f"{name}_head")(h).to(torch.float32)

    def _dien_trunk(self) -> DIEN:
        return DIEN(
            self.user_features, self.item_features, self.sequence_features, self.query_features,
            vocab_size=self.vocab_size, embed_dim=self.embed_dim, padding_index=self.padding_index,
            aux_weight=0.0, dtype=self.dtype,
        )

    @property
    def trunk_dim(self) -> int:
        """The width of the DIEN trunk's ``trunk_features``."""
        return self.profile_dim + 2 * self.key_dim

    def _mha(self, num_heads: int) -> MultiHeadAttention:
        """The query's attention over (B, L, d) steps (d the key width)."""
        d = self.key_dim
        return MultiHeadAttention(d, num_heads, max(1, d // num_heads), dtype=self.dtype)


def _short_mask(mask: torch.Tensor, short_len: int) -> torch.Tensor:
    """The mask of the valid steps at positions ≥ (the row's valid count −
    ``short_len``): its most recent steps when the valid steps are a
    prefix."""
    idx = torch.arange(mask.shape[1], device=mask.device)[None, :]
    lengths = mask.sum(dim=-1, keepdim=True)
    return mask * (idx >= lengths - short_len).to(mask.dtype)


class SIM(_LongSeqBase):
    """Search-based interest model. GSU: inner-product attention of the query
    over the full sequence (fp32 scores, a softmax over the valid steps, 0
    for a row with none) pools it for ``gsu_logits``; its scores pick the
    top-``topk`` steps (``topk_select``). ESU: ``esu_rnn`` (``MaskedGRU``,
    fp32 states) over the picked steps and ``esu_mha`` of the query over
    them, then profile ∥ query ∥ att ∥ query⊙att (∥ the DIEN trunk's
    features) → ``esu_logits``."""

    def __init__(self, *args, topk: int = 16, num_heads: int = 2, use_dien_trunk: bool = False, **kw):
        super().__init__(*args, **kw)
        d, p = self.key_dim, self.profile_dim
        self.topk = topk
        self.use_dien_trunk = use_dien_trunk
        self._add_head("gsu", p + 3 * d)
        self.esu_rnn = MaskedGRU(d, d, self.dtype)
        self.esu_mha = self._mha(num_heads)
        esu_in = p + 3 * d
        if use_dien_trunk:
            self.trunk = self._dien_trunk()
            esu_in += self.trunk_dim
        self._add_head("esu", esu_in)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        # GSU: inner-product attention over the full sequence
        scores = torch.einsum("bld,bd->bl", keys.to(torch.float32), query.to(torch.float32))
        w = torch.softmax(torch.where(mask.bool(), scores, -1e9), dim=-1)
        w = w * (mask.sum(dim=-1, keepdim=True) > 0)
        gsu_pool = torch.einsum("bl,bld->bd", w.to(keys.dtype), keys)
        gsu_logits = self._two_class_head(
            torch.cat([profile, query, gsu_pool, query * gsu_pool], dim=-1), "gsu")
        # soft search: the top-k steps by the GSU scores
        top_idx, sub_mask = topk_select(scores, mask, min(self.topk, keys.shape[1]))
        sub = gather_steps(keys, top_idx)
        # ESU: the recurrent trunk and the query's attention over the picks
        states = self.esu_rnn(sub, sub_mask)
        att = self.esu_mha(query[:, None, :], kv=states, mask=sub_mask)[:, 0]
        esu_in = [profile, query, att, query * att]
        if self.use_dien_trunk:
            esu_in.append(self.trunk(inputs)["trunk_features"])
        esu_logits = self._two_class_head(torch.cat(esu_in, dim=-1), "esu")
        return {
            "gsu_logits": gsu_logits,
            "esu_logits": esu_logits,
            "output": torch.softmax(esu_logits, dim=-1)[:, 1],
            "topk_indices": top_idx,
        }


class CoActionUnit(nn.Module):
    """CAN's co-action: the induction feature's embedding is the packed
    weights of a micro-MLP applied to the feed features (B, L, D) and their
    element-wise powers 1…``orders``: per layer of width w, a (in, w) weight
    and a (w,) bias sliced from the embedding, tanh; the result (masked)
    sum-pooled over L → (B, orders·w_last). No parameters of its own."""

    def __init__(self, layer_dims: Sequence[int] = (4, 4), orders: int = 2):
        super().__init__()
        self.layer_dims = tuple(layer_dims)
        self.orders = orders

    @staticmethod
    def packed_dim(feed_dim: int, layer_dims: Sequence[int]) -> int:
        total, in_dim = 0, feed_dim
        for width in layer_dims:
            total += in_dim * width + width
            in_dim = width
        return total

    def forward(self, induction: torch.Tensor, feed: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, _, d = feed.shape
        outs = []
        for order in range(1, self.orders + 1):
            x = feed ** order
            offset, in_dim = 0, d
            for width in self.layer_dims:
                w = induction[:, offset: offset + in_dim * width].reshape(b, in_dim, width)
                offset += in_dim * width
                bias = induction[:, offset: offset + width]
                offset += width
                x = torch.tanh(torch.einsum("bld,bdw->blw", x, w.to(x.dtype))
                               + bias[:, None, :].to(x.dtype))
                in_dim = width
            if mask is not None:
                x = x * mask[..., None].to(x.dtype)
            outs.append(x.sum(dim=1))
        return torch.cat(outs, dim=-1)


class CAN(_LongSeqBase):
    """Co-action network: a base trunk (``trunk_rnn``, a ``MaskedGRU`` with
    a masked mean pool, or the DIEN ``trunk``'s features) for the GSU head,
    and per (query field, behavior series) pair a ``CoActionUnit`` whose
    weights are the query id's row of its own table ``induction_emb_{field}``
    (V, packed), applied to the series (masked) and to the user fields as a
    length-U sequence (unmasked); profile ∥ query ∥ pooled ∥ co-actions →
    the ESU head."""

    def __init__(self, *args, co_layer_dims: Sequence[int] = (4, 4), co_orders: int = 2,
                 use_dien_trunk: bool = False, **kw):
        super().__init__(*args, **kw)
        d, p = self.key_dim, self.profile_dim
        self.use_dien_trunk = use_dien_trunk
        if use_dien_trunk:
            self.trunk = self._dien_trunk()
            pooled_dim = self.trunk_dim
        else:
            self.trunk_rnn = MaskedGRU(d, d, self.dtype)
            pooled_dim = d
        self._add_head("gsu", p + d + pooled_dim)
        packed = CoActionUnit.packed_dim(self.embed_dim, co_layer_dims)
        self.pairs = list(zip(self.query_features, self.sequence_features))
        self.unit = CoActionUnit(co_layer_dims, co_orders)
        for qf, _ in self.pairs:
            self.add_module(f"induction_emb_{qf}", SharedEmbedding(self.vocab_size, packed, dtype=self.dtype))
        co_dim = 2 * len(self.pairs) * co_orders * tuple(co_layer_dims)[-1]
        self._add_head("esu", p + d + pooled_dim + co_dim)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        if self.use_dien_trunk:
            pooled = self.trunk(inputs)["trunk_features"]
        else:
            states = self.trunk_rnn(keys, mask)
            w_mask = mask[..., None].to(states.dtype)
            pooled = (states * w_mask).sum(dim=1) / w_mask.sum(dim=1).clamp_min(1.0)
        gsu_logits = self._two_class_head(torch.cat([profile, query, pooled], dim=-1), "gsu")
        user_feed = self.emb(stack_ids(inputs, self.user_features))  # (B, U, D)
        co_parts = []
        for qf, sname in self.pairs:
            induction = getattr(self, f"induction_emb_{qf}")(inputs[qf].reshape(-1))
            series = self.emb(inputs[sname])  # (B, L, D)
            co_parts.append(self.unit(induction, series, mask))
            co_parts.append(self.unit(induction, user_feed, None))
        esu_logits = self._two_class_head(
            torch.cat([profile, query, pooled, torch.cat(co_parts, dim=-1)], dim=-1), "esu")
        return {
            "gsu_logits": gsu_logits,
            "esu_logits": esu_logits,
            "output": torch.softmax(esu_logits, dim=-1)[:, 1],
        }


class ETA(_LongSeqBase):
    """End-to-end target attention: SimHash codes of the fp32 query and keys
    under ``hash_proj``, the top-``topk`` steps by Hamming similarity,
    ``long_mha`` of the query over them (``gsu_logits``), and ``short_mha``
    over the ``short_len`` most recent valid steps (``esu_logits``). With
    ``lsh_self_attention`` the keys first get a residual of bucketed LSH
    self-attention under ``lsh_self_proj`` (masked steps get none). Spans
    (``core.trace``): ``eta.search`` (the codes, their similarity, the
    top-k and the gather of the picks) and ``eta.attend`` (both
    attentions)."""

    def __init__(self, *args, topk: int = 16, short_len: int = 8, n_hash_bits: int = 16,
                 num_heads: int = 2, lsh_self_attention: bool = False, lsh_self_bits: int = 4, **kw):
        super().__init__(*args, **kw)
        d, p = self.key_dim, self.profile_dim
        self.topk, self.short_len = topk, short_len
        self.lsh_self_attention = lsh_self_attention
        if lsh_self_attention:
            self.register_buffer("lsh_self_proj", make_projections(11, 1, d, lsh_self_bits)[0])
        self.register_buffer("hash_proj", make_projections(3, 1, d, n_hash_bits)[0])
        self.long_mha = self._mha(num_heads)
        self._add_head("gsu", p + 2 * d)
        self.short_mha = self._mha(num_heads)
        self._add_head("esu", p + 3 * d)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        f32 = torch.float32
        if self.lsh_self_attention:
            ctx = lsh_attention(keys.to(f32), keys.to(f32), self.lsh_self_proj, mask).to(keys.dtype)
            keys = keys + ctx * mask[..., None].to(keys.dtype)
        # long term: Hamming top-k retrieval against the candidate's code
        with trace.span("eta.search"):
            sim = hamming_similarity(simhash_bits(query.to(f32), self.hash_proj),
                                     simhash_bits(keys.to(f32), self.hash_proj)).to(f32)
            top_idx, top_mask = topk_select(sim, mask, min(self.topk, keys.shape[1]))
            sub = gather_steps(keys, top_idx)
        with trace.span("eta.attend"):
            long_att = self.long_mha(query[:, None, :], kv=sub, mask=top_mask)[:, 0]
            # short term: attention over the most recent valid steps
            short_att = self.short_mha(query[:, None, :], kv=keys,
                                       mask=_short_mask(mask, self.short_len))[:, 0]
        gsu_logits = self._two_class_head(torch.cat([profile, query, long_att], dim=-1), "gsu")
        esu_logits = self._two_class_head(
            torch.cat([profile, query, long_att, short_att], dim=-1), "esu")
        return {
            "gsu_logits": gsu_logits,
            "esu_logits": esu_logits,
            "output": torch.softmax(esu_logits, dim=-1)[:, 1],
            "topk_indices": top_idx,
        }
