"""DMR, DMT, FinalMLP and SDIM (counterpart of ``tpurec/models/dmr.py``).

- DMR: item-to-item and user-to-item matching networks over the behavior
  sequence with learned positions, a binary head, and in training an
  auxiliary in-batch retrieval loss.
- DMT: a transformer per behavior channel with the candidate as the
  decoder's query, an expert bank with a gate and a tower per task
  (``multi_task`` loss), and position-bias towers whose logit is added in
  training only.
- FinalMLP: two sigmoid-gated views of the embeddings through two MLP
  streams, fused by a multi-head bilinear term (binary head).
- SDIM: multi-group SimHash sketch pooling of the long sequence and
  short-term attention, with SIM's two-head contract (``gsu_esu`` loss).
  Its projections are the flax ``constants`` ``hash_projections`` (G, D,
  n_bits): a persistent buffer here, drawn as the JAX module draws it
  (``jax.random.normal`` of key 11, through ``jax_normal``), loaded exactly
  by ``params_from_jax``. The serving-time store of the sketches is
  ``tpurec_torch.serving.sketch_store``.

Child modules and raw parameters keep the flax names, so weights map across
by path. DMR's ``pos`` and DMT's ``pos_{i}`` are sized by the sequence
length, which flax reads off the first batch: the builders pass
``max_seq_length`` from ``DataInfo``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from tpurec_torch.core.collectives import data_mean_share, gather_batch
from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.models.base import Inputs, Outputs, binary_output, series_mask, stack_ids
from tpurec_torch.models.din import _SeqBase
from tpurec_torch.models.multitask import ExpertBank, _mix, _softmax_gate
from tpurec_torch.models.sim import _LongSeqBase, _short_mask
from tpurec_torch.ops.attention import MultiHeadAttention
from tpurec_torch.ops.hashing import make_projections, sketch_pool
from tpurec_torch.ops.mlp import MLP, Dense
from tpurec_torch.ops.sequence import LearnedPositionEmbedding


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """A softmax over the valid steps (−1e9 elsewhere), 0 for a row with
    none."""
    w = torch.softmax(torch.where(mask.bool(), scores, -1e9), dim=-1)
    return w * (mask.sum(dim=-1, keepdim=True) > 0)


class DMR(_SeqBase):
    """Deep match to rank. I2I: a(t) = ``i2i_z``·tanh(``i2i_wc``·cand +
    ``i2i_we``·e_t + ``i2i_wp``·pos_t); its masked softmax pools the
    sequence, and the sum of the raw scores over the valid steps is a
    feature. U2I: position-only scores (``u2i_wp``, ``u2i_z``) pool the
    sequence into a user vector (``u2i_proj``, tanh) scored against the
    candidate by inner product. Profile ∥ query ∥ pool ∥ query⊙pool ∥ both
    scores → ``mlp`` → ``head``.

    In training (``aux_weight`` > 0), ``auxiliary_loss`` = ``aux_weight`` ×
    the mean over rows with more than one valid step of the softmax cross
    entropy of the prefix user vector (U2I weights over the valid steps
    before index count − 1) against the (B, B) in-batch logits with the
    step at index count − 1 of every row. On a mesh (``batch_mesh``, set
    by ``models.registry.place_on_mesh``) the columns are the global
    batch's last steps and the mean is over its rows."""

    def __init__(self, *args, hidden_dims: Sequence[int] = (80, 40), attention_dim: int = 32,
                 aux_weight: float = 0.1, max_seq_length: int = 0, **kw):
        super().__init__(*args, hidden_dims=hidden_dims, **kw)
        if max_seq_length <= 0:
            raise ValueError("DMR needs max_seq_length (its position table is sized by L)")
        d, a, dtype = self.key_dim, attention_dim, self.dtype
        self.aux_weight = aux_weight
        self.batch_mesh = None  # the mesh whose 'data' axis splits the batch
        self.pos = LearnedPositionEmbedding(max_seq_length, d, dtype)
        self.i2i_wc = Dense(d, a, dtype)
        self.i2i_we = Dense(d, a, dtype)
        self.i2i_wp = Dense(d, a, dtype)
        self.i2i_z = Dense(a, 1, dtype, use_bias=False)
        self.u2i_wp = Dense(d, a, dtype)
        self.u2i_z = Dense(a, 1, dtype, use_bias=False)
        self.u2i_proj = Dense(d, d, dtype)
        self.mlp = MLP(self.profile_dim + 3 * d + 2, self.hidden_dims, dtype=dtype)
        self.head = Dense(self.hidden_dims[-1], 1, dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        b, l, _ = keys.shape
        f32 = torch.float32
        pos = self.pos(l)
        # I2I attention
        h = self.i2i_wc(query)[:, None, :] + self.i2i_we(keys) + self.i2i_wp(pos)[None]
        scores = self.i2i_z(torch.tanh(h)).reshape(b, l).to(f32)
        w = _masked_softmax(scores, mask)
        i2i_pool = torch.einsum("bl,bld->bd", w.to(keys.dtype), keys)
        rel_feature = torch.where(mask.bool(), scores, 0.0).sum(dim=-1, keepdim=True)
        # U2I: position-only attention → the user vector
        u_scores = self.u2i_z(torch.tanh(self.u2i_wp(pos))).reshape(1, l).to(f32)
        u_scores = torch.where(mask.bool(), u_scores, -1e9)
        uw = _masked_softmax(u_scores, mask)
        user_vec = torch.einsum("bl,bld->bd", uw.to(keys.dtype), keys)
        user_vec = torch.tanh(self.u2i_proj(user_vec))
        u2i_score = (user_vec.to(f32) * query.to(f32)).sum(dim=-1, keepdim=True)
        x = torch.cat([profile, query, i2i_pool, query * i2i_pool,
                       rel_feature.to(profile.dtype), u2i_score.to(profile.dtype)], dim=-1)
        out = binary_output(self.head(self.mlp(x)))
        if self.training and self.aux_weight > 0:
            out["auxiliary_loss"] = self.aux_weight * self._aux_loss(keys, mask, u_scores,
                                                                     self.batch_mesh)
        return out

    @staticmethod
    def _aux_loss(keys, mask, u_scores, mesh=None) -> torch.Tensor:
        """The prefix user vector (the steps before the last one) should
        retrieve that last step against the other rows' last steps: on a
        mesh those of the global batch (gathered over 'data'), with the
        count of rows of two valid steps or more summed over 'data'."""
        b, l, _ = keys.shape
        f32 = torch.float32
        lengths = mask.sum(dim=-1).to(torch.int32)
        last_idx = (lengths - 1).clamp_min(0)
        last_emb = torch.take_along_dim(keys, last_idx.to(torch.int64)[:, None, None], dim=1)[:, 0]
        prefix_mask = mask * (torch.arange(l, device=mask.device)[None, :] < last_idx[:, None]).to(mask.dtype)
        pw = _masked_softmax(u_scores, prefix_mask)
        prefix_vec = torch.einsum("bl,bld->bd", pw.to(keys.dtype), keys)
        logits = prefix_vec.to(f32) @ gather_batch(last_emb.to(f32), mesh).T
        offset = mesh.data_index * b if mesh is not None else 0
        labels = torch.arange(offset, offset + b, device=keys.device)
        ce = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
        valid = (lengths > 1).to(f32)
        return data_mean_share((ce * valid).sum(), valid.sum(), mesh)


class DMT(_SeqBase):
    """Deep multi-interest transformer. Per behavior channel i (each series
    its own channel): the series plus ``pos_{i}`` through the encoder
    ``enc_{i}`` (``MultiHeadAttention``), then the decoder ``dec_{i}``
    (no residual) of the candidate's query over the encoded steps; profile
    ∥ query ∥ the decoders → ``experts`` (``ExpertBank``); per task a
    softmax gate ``{task}_gate``, ``{task}_tower`` and ``{task}_head``. With
    ``bias_features``, each task's ``{task}_bias_tower`` (MLP (16, 1),
    linear out) over their embeddings adds its logit in training only (its
    parameters exist in every mode)."""

    def __init__(self, *args, task_names: Sequence[str] = ("ctr", "cvr"), bias_features: Sequence[str] = (),
                 num_heads: int = 2, num_experts: int = 4, expert_dims: Sequence[int] = (64, 32),
                 tower_dims: Sequence[int] = (32,), max_seq_length: int = 0, **kw):
        super().__init__(*args, **kw)
        if max_seq_length <= 0:
            raise ValueError("DMT needs max_seq_length (its position tables are sized by L)")
        d, q, dtype = self.embed_dim, len(self.query_features) * self.embed_dim, self.dtype
        self.task_names = list(task_names)
        self.bias_features = list(bias_features)
        for i in range(len(self.sequence_features)):
            self.add_module(f"pos_{i}", LearnedPositionEmbedding(max_seq_length, d, dtype))
            self.add_module(f"enc_{i}", MultiHeadAttention(d, num_heads, max(1, d // num_heads), dtype=dtype))
            self.add_module(f"dec_{i}", MultiHeadAttention(q, num_heads, max(1, d // num_heads), kv_dim=d,
                                                           dtype=dtype, use_residual=False))
        in_dim = self.profile_dim + q * (1 + len(self.sequence_features))
        self.experts = ExpertBank(in_dim, num_experts, expert_dims)
        tower_dims = tuple(tower_dims)
        for task in self.task_names:
            self.add_module(f"{task}_gate", Dense(in_dim, num_experts, dtype))
            self.add_module(f"{task}_tower", MLP(tuple(expert_dims)[-1], tower_dims, dtype=dtype))
            self.add_module(f"{task}_head", Dense(tower_dims[-1], 1, dtype))
            if self.bias_features:
                self.add_module(f"{task}_bias_tower", MLP(len(self.bias_features) * d, (16, 1),
                                                          out_activation="linear", dtype=dtype))

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        channel_outs = []
        for i, name in enumerate(self.sequence_features):
            mask = series_mask(inputs, name, self.padding_index)
            keys = self.emb(inputs[name])
            pos = getattr(self, f"pos_{i}")(keys.shape[1])
            enc = getattr(self, f"enc_{i}")(keys + pos[None].to(keys.dtype), mask=mask)
            channel_outs.append(getattr(self, f"dec_{i}")(query[:, None, :], kv=enc, mask=mask)[:, 0])
        x = torch.cat([profile, query] + channel_outs, dim=-1)
        experts = self.experts(x)
        out: Dict[str, torch.Tensor] = {}
        for task in self.task_names:
            gate = _softmax_gate(getattr(self, f"{task}_gate")(x), experts.dtype)
            h = getattr(self, f"{task}_tower")(_mix(gate, experts))
            logit = getattr(self, f"{task}_head")(h).reshape(-1).to(torch.float32)
            if self.bias_features:
                bias_in = self.emb(stack_ids(inputs, self.bias_features))
                bias = getattr(self, f"{task}_bias_tower")(bias_in.reshape(bias_in.shape[0], -1))
                if self.training:
                    logit = logit + bias.reshape(-1).to(torch.float32)
            out[f"{task}_logit"] = logit
            out[f"{task}_output"] = torch.sigmoid(logit)
        return out


class FinalMLP(nn.Module):
    """Two sigmoid-gated views of the flattened embeddings (x·2σ(``v{i}_gate``
    (x))) through ``stream1`` and ``stream2``; their outputs cut into
    ``num_fusion_heads`` heads and fused by the bilinear ``w12`` (h, d1, d2)
    in fp32, plus ``lin1`` and ``lin2`` → a binary head."""

    def __init__(self, feature_names: Sequence[str], vocab_size: int, embed_dim: int = 8,
                 stream_dims: Sequence[int] = (64, 32), num_fusion_heads: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_names = list(feature_names)
        self.num_fusion_heads = num_fusion_heads
        width = len(self.feature_names) * embed_dim
        out = tuple(stream_dims)[-1]
        h = num_fusion_heads
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        self.v1_gate = Dense(width, width, dtype)
        self.v2_gate = Dense(width, width, dtype)
        self.stream1 = MLP(width, stream_dims, dtype=dtype)
        self.stream2 = MLP(width, stream_dims, dtype=dtype)
        self.w12 = nn.Parameter(torch.empty(h, out // h, out // h))
        self.lin1 = Dense(out, 1, dtype)
        self.lin2 = Dense(out, 1, dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        glorot_uniform_(self.w12, generator)  # flax's fans of (h, d1, d2): h·d1 and h·d2

    def forward(self, inputs: Inputs) -> Outputs:
        emb = self.emb(stack_ids(inputs, self.feature_names))
        flat = emb.reshape(emb.shape[0], -1)
        s1 = self.stream1(flat * (2.0 * torch.sigmoid(self.v1_gate(flat))))
        s2 = self.stream2(flat * (2.0 * torch.sigmoid(self.v2_gate(flat))))
        b, h = s1.shape[0], self.num_fusion_heads
        f32 = torch.float32
        s1h = s1.reshape(b, h, -1).to(f32)
        s2h = s2.reshape(b, h, -1).to(f32)
        bilinear = torch.einsum("bhd,hde,bhe->b", s1h, self.w12, s2h)
        lin = self.lin1(s1).reshape(-1).to(f32) + self.lin2(s2).reshape(-1).to(f32)
        return binary_output(bilinear + lin)


class SDIM(_LongSeqBase):
    """Sampling-based deep interest model: ``sketch_pool`` of the fp32 keys
    by the fp32 query's bucket in each of the ``num_hash_groups`` groups
    (the long-term interest, returned as ``long_term_interest``) for the GSU
    head, and ``short_mha`` of the query over the ``short_len`` most recent
    valid steps for the ESU head."""

    def __init__(self, *args, num_hash_groups: int = 4, n_hash_bits: int = 6, short_len: int = 8,
                 num_heads: int = 2, **kw):
        super().__init__(*args, **kw)
        d, p = self.key_dim, self.profile_dim
        self.short_len = short_len
        self.register_buffer("hash_projections", make_projections(11, num_hash_groups, d, n_hash_bits))
        self._add_head("gsu", p + 3 * d)
        self.short_mha = self._mha(num_heads)
        self._add_head("esu", p + 4 * d)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        f32 = torch.float32
        long_term = sketch_pool(keys.to(f32), mask, self.hash_projections, query.to(f32)).to(keys.dtype)
        gsu_logits = self._two_class_head(torch.cat([profile, query, long_term, query * long_term], dim=-1), "gsu")
        short = self.short_mha(query[:, None, :], kv=keys, mask=_short_mask(mask, self.short_len))[:, 0]
        esu_logits = self._two_class_head(
            torch.cat([profile, query, long_term, short, query * short], dim=-1), "esu")
        return {
            "gsu_logits": gsu_logits,
            "esu_logits": esu_logits,
            "output": torch.softmax(esu_logits, dim=-1)[:, 1],
            "long_term_interest": long_term,
        }
