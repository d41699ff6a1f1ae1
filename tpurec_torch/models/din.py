"""Behavior-sequence ranking: DIN, DIEN and DSIN (counterpart of
``tpurec/models/din.py``).

Input contract: ``sequence_features`` are (B, L) padded id tensors aligned
1:1 with ``query_features`` (the candidate's corresponding ids); the other
user/item categorical features form the profile. Masks come from the padding
index. The top ``mlp`` of each is tensor parallel over a mesh's 'model'
axis (``tp_axis``), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.core.collectives import data_mean_share, gather_batch
from tpurec_torch.core.mesh import MODEL_AXIS
from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.models.base import Inputs, Outputs, binary_output, series_mask, stack_ids
from tpurec_torch.ops.attention import DinTargetAttention, MultiHeadAttention
from tpurec_torch.ops.mlp import MLP, Dense, LayerNorm
from tpurec_torch.ops.sequence import AttentionGRU, MaskedBiLSTM, MaskedGRU


class _SeqBase(nn.Module):
    def __init__(
        self,
        user_features: Sequence[str],
        item_features: Sequence[str],
        sequence_features: Sequence[str],
        query_features: Sequence[str] = ("item_id",),
        vocab_size: int = 0,
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (200, 80),
        padding_index: int = 0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.user_features = list(user_features)
        self.item_features = list(item_features)
        self.sequence_features = list(sequence_features)
        self.query_features = list(query_features)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_dims = tuple(hidden_dims)
        self.padding_index = padding_index
        self.dtype = dtype
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def _profile(self, inputs: Inputs) -> torch.Tensor:
        e = self.emb(stack_ids(inputs, self.user_features + self.item_features))
        return e.reshape(e.shape[0], -1)

    def _query(self, inputs: Inputs) -> torch.Tensor:
        """(B, Fq·D) candidate embedding aligned with the sequence features."""
        e = self.emb(stack_ids(inputs, self.query_features))
        return e.reshape(e.shape[0], -1)

    def _keys(self, inputs: Inputs):
        """(B, L, Fs·D) behavior embeddings + (B, L) mask."""
        mask = series_mask(inputs, self.sequence_features[0], self.padding_index)
        embs = [self.emb(inputs[n], padding_index=self.padding_index) for n in self.sequence_features]
        keys = torch.cat(embs, dim=-1) if len(embs) > 1 else embs[0]
        return keys, mask

    @property
    def key_dim(self) -> int:
        """Fs·D, the width of a behavior step; the query must have it too."""
        key_dim = len(self.sequence_features) * self.embed_dim
        if len(self.query_features) * self.embed_dim != key_dim:
            raise ValueError(
                f"query features {self.query_features} and sequence features "
                f"{self.sequence_features} must align 1:1"
            )
        return key_dim

    @property
    def profile_dim(self) -> int:
        return (len(self.user_features) + len(self.item_features)) * self.embed_dim


class DIN(_SeqBase):
    """Deep Interest Network: activation-unit target attention over the
    behavior sequence, masked weighted sum-pool, concat with the profile →
    MLP → head."""

    def __init__(self, *args, attention_hidden_dims: Sequence[int] = (36,), **kw):
        super().__init__(*args, **kw)
        key_dim = self.key_dim
        self.att = DinTargetAttention(
            key_dim, hidden_dims=tuple(attention_hidden_dims), dtype=self.dtype
        )
        self.mlp = MLP(self.profile_dim + 2 * key_dim, self.hidden_dims, dtype=self.dtype,
                       tp_axis=MODEL_AXIS)
        self.head = Dense(self.hidden_dims[-1], 1, dtype=self.dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        pooled, _ = self.att(query, keys, mask)
        x = torch.cat([profile, query, pooled], dim=-1)
        return binary_output(self.head(self.mlp(x)))


class DIEN(_SeqBase):
    """Deep Interest Evolution: the ``extractor`` GRU over the behavior
    sequence, DIN's target attention (``att``) scoring each interest state
    against the candidate (only its scores are used), their softmax over the
    live steps, the ``evolution`` ``AttentionGRU`` ('augru', 'agru' or
    'aigru') gated by it, then profile ∥ query ∥ final state → ``mlp`` →
    ``head``. ``trunk_features`` is that concatenation.

    In training, ``auxiliary_loss`` = ``aux_weight`` × the next-behavior
    loss: each interest h_t scores the next behavior e_{t+1} above a
    negative, which is the embedded ``neg_<series>`` column at t+1 when the
    batch carries every such column, else the positive of the previous row
    (the batch rolled by one row). On a mesh
    (``batch_mesh``, set by ``models.registry.place_on_mesh``) both are the
    global batch's: row 0 of data rank r takes the last row of rank r − 1
    (rank 0 that of the last rank), gathered over 'data' with the borrowed
    row's cotangent returned to its owner, and the masked mean's count is
    summed over 'data' (``data_mean_share``)."""

    def __init__(self, *args, gru_mode: str = "augru", aux_weight: float = 1.0,
                 attention_hidden_dims: Sequence[int] = (36,), **kw):
        super().__init__(*args, **kw)
        d = self.key_dim
        self.aux_weight = aux_weight
        self.extractor = MaskedGRU(d, d, self.dtype)
        self.att = DinTargetAttention(d, hidden_dims=tuple(attention_hidden_dims), dtype=self.dtype)
        self.evolution = AttentionGRU(d, d, gru_mode, self.dtype)
        self.mlp = MLP(self.profile_dim + 2 * d, self.hidden_dims, dtype=self.dtype,
                       tp_axis=MODEL_AXIS)
        self.head = Dense(self.hidden_dims[-1], 1, dtype=self.dtype)
        self.batch_mesh = None  # the mesh whose 'data' axis splits the batch

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        interests = self.extractor(keys, mask)
        _, scores = self.att(query, interests, mask)
        norm = torch.where(mask.bool(), scores, -1e9)
        norm = torch.softmax(norm, dim=-1) * (mask.sum(dim=-1, keepdim=True) > 0)
        final = self.evolution(interests, norm.to(interests.dtype), mask)
        x = torch.cat([profile, query, final], dim=-1)
        out = binary_output(self.head(self.mlp(x)))
        out["trunk_features"] = x
        if self.training and self.aux_weight > 0:
            out["auxiliary_loss"] = self.aux_weight * self._aux_loss(
                interests, keys, mask, self._neg_keys(inputs)
            )
        return out

    def _neg_keys(self, inputs: Inputs) -> Optional[torch.Tensor]:
        names = [f"neg_{n}" for n in self.sequence_features]
        if not all(n in inputs for n in names):
            return None
        embs = [self.emb(inputs[n]) for n in names]
        return torch.cat(embs, dim=-1) if len(embs) > 1 else embs[0]

    def _aux_loss(self, interests, keys, mask, neg_keys=None) -> torch.Tensor:
        f32 = torch.float32
        mesh = self.batch_mesh
        h = interests[:, :-1].to(f32)
        pos = keys[:, 1:].to(f32)
        if neg_keys is not None:
            neg = neg_keys[:, 1:].to(f32)
        else:  # the roll over the global batch: the previous row's positive
            last = pos[-1:]
            if mesh is not None:
                last = gather_batch(last, mesh).narrow(0, (mesh.data_index - 1) % mesh.n_data, 1)
            neg = torch.cat([last, pos[:-1]], dim=0)
        m = (mask[:, 1:] * mask[:, :-1]).to(f32)
        loss = F.softplus(-(h * pos).sum(dim=-1)) + F.softplus((h * neg).sum(dim=-1))
        return data_mean_share((loss * m).sum(), m.sum(), mesh)


class DSIN(_SeqBase):
    """Deep Session Interest Network: the history cut into ``num_sessions``
    sessions of L / S steps; each session plus the learned biases
    ``bias_sess`` (S, 1, 1), ``bias_pos`` (1, L/S, 1) and ``bias_dim`` (1, 1,
    D) through the shared ``session_encoder`` (``MultiHeadAttention``),
    ``ffn`` and ``ffn_ln``; a masked mean pool a session; the session
    interests through ``bilstm`` (``MaskedBiLSTM`` over the sessions with a
    live step) and ``bilstm_proj``; DIN's target attention over both
    (``att_interest``, ``att_evolved``); profile ∥ query ∥ both pools →
    ``mlp`` → ``head``. ``max_seq_length`` (L) sizes ``bias_pos`` (the
    builder takes it from ``DataInfo``); L must be a multiple of S."""

    def __init__(self, *args, num_sessions: int = 5, num_heads: int = 2, lstm_dim: int = 16,
                 attention_hidden_dims: Sequence[int] = (36,), max_seq_length: int = 0, **kw):
        super().__init__(*args, **kw)
        d, s = self.key_dim, num_sessions
        if max_seq_length <= 0 or max_seq_length % s:
            raise ValueError(f"sequence length {max_seq_length} not divisible by sessions {s}")
        self.num_sessions, self.session_len = s, max_seq_length // s
        self.bias_sess = nn.Parameter(torch.empty(s, 1, 1))
        self.bias_pos = nn.Parameter(torch.empty(1, self.session_len, 1))
        self.bias_dim = nn.Parameter(torch.empty(1, 1, d))
        self.session_encoder = MultiHeadAttention(d, num_heads, max(1, d // num_heads), dtype=self.dtype)
        self.ffn = Dense(d, d, self.dtype)
        self.ffn_ln = LayerNorm(d, self.dtype)
        self.bilstm = MaskedBiLSTM(d, lstm_dim, self.dtype)
        self.bilstm_proj = Dense(2 * lstm_dim, d, self.dtype)
        att = tuple(attention_hidden_dims)
        self.att_interest = DinTargetAttention(d, hidden_dims=att, dtype=self.dtype)
        self.att_evolved = DinTargetAttention(d, hidden_dims=att, dtype=self.dtype)
        self.mlp = MLP(self.profile_dim + 3 * d, self.hidden_dims, dtype=self.dtype,
                       tp_axis=MODEL_AXIS)
        self.head = Dense(self.hidden_dims[-1], 1, dtype=self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.bias_sess, self.bias_pos, self.bias_dim):
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, inputs: Inputs) -> Outputs:
        profile = self._profile(inputs)
        query = self._query(inputs)
        keys, mask = self._keys(inputs)
        b, l, d = keys.shape
        s, n = self.num_sessions, self.session_len
        if l != s * n:
            raise ValueError(f"sequence length {l}: the model was built for {s} sessions of {n}")
        bias = (self.bias_sess + self.bias_pos + self.bias_dim).to(keys.dtype)
        flat = (keys.reshape(b, s, n, d) + bias[None]).reshape(b * s, n, d)
        flat_mask = mask.reshape(b * s, n)
        enc = self.session_encoder(flat, mask=flat_mask)
        enc = self.ffn_ln(enc + self.ffn(F.relu(enc)))
        w = flat_mask[..., None].to(enc.dtype)
        pooled = (enc * w).sum(dim=1) / w.sum(dim=1).clamp_min(1.0)
        interests = pooled.reshape(b, s, d)
        sess_valid = (mask.reshape(b, s, n).sum(dim=-1) > 0).to(torch.float32)
        evolved = self.bilstm_proj(self.bilstm(interests, sess_valid))
        att_i, _ = self.att_interest(query, interests, sess_valid)
        att_e, _ = self.att_evolved(query, evolved, sess_valid)
        x = torch.cat([profile, query, att_i, att_e], dim=-1)
        return binary_output(self.head(self.mlp(x)))
