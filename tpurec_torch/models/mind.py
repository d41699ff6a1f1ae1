"""Multi-interest retrieval (counterpart of ``tpurec/models/mind.py``): MIND,
SDM, ComiRec ('sa' and 'dr') and SINE.

Each model maps a behavior history (and a profile) to one or more interest
vectors and scores the candidate item by inner product; training uses
``in_batch_softmax``. Outputs carry ``user_embedding``, ``item_embedding``
and, where the model has them, ``interest_capsules`` (the offline indexer's
multi-interest tower) and ``capsule_mask``. Child modules keep the flax
names (``emb``, ``routing``, ``capsule_mlp``, ``short_lstm``,
``short_mha``, ``w1``, ``w2``, ``intent_proj``...), so weights map across
by path.

Sampled-softmax negatives (``num_sampled_negatives``) are drawn in training
mode from the generator ``sampling_generator(model, generator)`` hands the
model (the trainer hands over ``TrainState.generator``, where the JAX
package uses its ``'sampling'`` rng); the draw (``sample_negative_ids``) is
apart from the scoring (``sampled_logits``).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.initializers import glorot_uniform_
from tpurec_torch.models.base import Inputs, Outputs, embed_series, stack_ids
from tpurec_torch.ops.attention import MultiHeadAttention
from tpurec_torch.ops.capsule import CapsuleRouting, LabelAwareAttention
from tpurec_torch.ops.hashing import gather_steps
from tpurec_torch.ops.mlp import MLP, Dense
from tpurec_torch.ops.sequence import MaskedLSTM, sinusoidal_positions
from tpurec_torch.ops.topk import top_k


@contextlib.contextmanager
def sampling_generator(model: nn.Module, generator: Optional[torch.Generator]):
    """In the body, every retrieval model under ``model`` draws its sampled
    negatives from ``generator``."""
    mods = [m for m in model.modules() if isinstance(m, _RetrievalBase)]
    for m in mods:
        m.generator = generator
    try:
        yield
    finally:
        for m in mods:
            m.generator = None


def _unit(x: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return x32 / (torch.linalg.vector_norm(x32, dim=-1, keepdim=True) + 1e-6)


class _RetrievalBase(nn.Module):
    """The shared embedding ``emb``, the behavior/target/profile lookups and
    the output post-pass (``tpurec/models/mind.py:29-148``)."""

    def __init__(
        self,
        user_features: Sequence[str],
        sequence_features: Sequence[str],
        query_features: Sequence[str] = ("item_id",),
        vocab_size: int = 0,
        embed_dim: int = 16,
        padding_index: int = 0,
        num_sampled_negatives: int = 0,
        query_feature_ranges: Sequence[Sequence[int]] = (),
        normalize_logits: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.user_features = list(user_features)
        self.sequence_features = list(sequence_features)
        self.query_features = list(query_features)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.padding_index = padding_index
        self.num_sampled_negatives = num_sampled_negatives
        self.query_feature_ranges = [tuple(r) for r in query_feature_ranges]
        self.normalize_logits = normalize_logits
        self.dtype = dtype
        self.generator: Optional[torch.Generator] = None  # set by sampling_generator
        self.batch_mesh = None  # the mesh whose 'data' axis splits the batch
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)
        if normalize_logits:
            self.logit_scale = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.normalize_logits:
            nn.init.constant_(self.logit_scale, 10.0)

    @property
    def behavior_dim(self) -> int:
        return len(self.sequence_features) * self.embed_dim

    def _behavior(self, inputs: Inputs):
        """(B, L, F·D) concat-embedded parallel series + (B, L) mask."""
        return embed_series(self.emb, inputs, self.sequence_features, self.padding_index)

    def _target(self, inputs: Inputs) -> torch.Tensor:
        """(B, F·D) candidate embedding aligned with the behavior block."""
        e = self.emb(stack_ids(inputs, self.query_features))
        return e.reshape(e.shape[0], -1)

    def _profile_vec(self, inputs: Inputs) -> Optional[torch.Tensor]:
        if not self.user_features:
            return None
        e = self.emb(stack_ids(inputs, self.user_features))
        return e.reshape(e.shape[0], -1)

    def _finalize(self, out: Outputs, inputs: Inputs) -> Outputs:
        """Cosine-logit normalisation (``normalize_logits``: unit user, item
        and capsule vectors, the user side times softplus(``logit_scale``))
        and, in training, the sampled-negative logits."""
        out = dict(out)
        if self.normalize_logits:
            scale = F.softplus(self.logit_scale)
            u = _unit(out["user_embedding"]) * scale
            i = _unit(out["item_embedding"])
            out["user_embedding"], out["item_embedding"] = u, i
            if "interest_capsules" in out:
                out["interest_capsules"] = _unit(out["interest_capsules"]) * scale
            out["output"] = (u * i).sum(dim=-1)
        if self.training and self.num_sampled_negatives > 0:
            b = out["user_embedding"].shape[0]
            neg_ids = self.sample_negative_ids(b, out["user_embedding"].device)
            out["logits"] = self.sampled_logits(
                out["user_embedding"], out["item_embedding"], neg_ids, inputs
            )
        return out

    def sample_negative_ids(self, batch: int, device: torch.device) -> torch.Tensor:
        """(B, N, F) candidate ids, the j-th uniform over the j-th query
        feature's range (``query_feature_ranges``, else [1, vocab)), never the
        padding id; drawn from the generator ``sampling_generator`` set. On
        a mesh (``batch_mesh``, set by ``models.registry.place_on_mesh``)
        every data rank draws the global batch's (n_data·B, N) ids a column
        from the same generator state and keeps its block of rows, so the
        mesh's negatives are the one-device run's."""
        if self.generator is None:
            raise RuntimeError(
                "sampled negatives need a generator: run the model under "
                "sampling_generator(model, generator) (the Trainer does)"
            )
        f = len(self.query_features)
        ranges = self.query_feature_ranges or [(1, self.vocab_size)] * f
        mesh = self.batch_mesh
        n_data, start = (mesh.n_data, mesh.data_index * batch) if mesh is not None else (1, 0)
        cols = []
        for lo, hi in ranges:
            lo, hi = int(lo), int(hi)
            if lo <= self.padding_index < hi:
                lo = self.padding_index + 1
            cols.append(torch.randint(
                lo, hi, (n_data * batch, self.num_sampled_negatives), device=device,
                generator=self.generator,
            )[start : start + batch])
        return torch.stack(cols, dim=-1)

    def sampled_logits(
        self, user_vec: torch.Tensor, target: torch.Tensor, neg_ids: torch.Tensor,
        inputs: Optional[Inputs] = None,
    ) -> torch.Tensor:
        """[positive ∥ N negatives] inner-product logits, (B, 1+N) fp32;
        a negative whose id tuple equals the row's positive (an accidental
        hit) gets -1e9 (``tpurec/models/mind.py:114-148``)."""
        if self.emb.sparse_rows is not None:
            raise ValueError(
                "sampled negatives index the whole table: train with the dense engine"
            )
        b, n = neg_ids.shape[:2]
        neg_emb = self.emb(neg_ids).reshape(b, n, -1).to(torch.float32)
        if self.normalize_logits:
            neg_emb = neg_emb / (torch.linalg.vector_norm(neg_emb, dim=-1, keepdim=True) + 1e-6)
        u = user_vec.to(torch.float32)
        pos = (u * target.to(torch.float32)).sum(dim=-1, keepdim=True)
        negs = torch.einsum("bd,bnd->bn", u, neg_emb)
        if inputs is not None:
            pos_ids = stack_ids(inputs, self.query_features)
            hit = (neg_ids == pos_ids[:, None, :]).all(dim=-1)
            negs = torch.where(hit, -1e9, negs)
        return torch.cat([pos, negs], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(torch.float32) * b.to(torch.float32)).sum(dim=-1)


class MIND(_RetrievalBase):
    """Multi-interest network with dynamic routing: 'shared' capsule routing
    over the behavior sequence (kernel #7 outside training, #8 for its
    gradient), the profile concatenated to each capsule through
    ``capsule_mlp``, label-aware attention → user vector."""

    def __init__(
        self,
        *args,
        num_interests: int = 4,
        hidden_dims: Sequence[int] = (64,),
        attention_power: float = 2.0,
        **kw,
    ):
        super().__init__(*args, **kw)
        cap_dim = self.behavior_dim  # F·D
        self.routing = CapsuleRouting(cap_dim, num_interests, cap_dim, mode="shared", dtype=self.dtype)
        self.capsule_mlp = None
        if self.user_features:
            self.capsule_mlp = MLP(
                cap_dim + len(self.user_features) * self.embed_dim,
                tuple(hidden_dims) + (cap_dim,), out_activation="linear", dtype=self.dtype,
            )
        self.label_att = LabelAwareAttention(attention_power)

    def forward(self, inputs: Inputs) -> Outputs:
        behavior, mask = self._behavior(inputs)
        capsules, cap_mask = self.routing(behavior, mask)
        profile = self._profile_vec(inputs)
        if profile is not None:
            b, k, _ = capsules.shape
            prof = profile[:, None, :].expand(b, k, profile.shape[-1])
            capsules = self.capsule_mlp(torch.cat([capsules, prof], dim=-1))
        target = self._target(inputs)
        user_vec = self.label_att(capsules, cap_mask, target)
        out: Outputs = {
            "user_embedding": user_vec,
            "item_embedding": target,
            "interest_capsules": capsules,
            "capsule_mask": cap_mask,
            "output": _dot(user_vec, target),
        }
        return self._finalize(out, inputs)


def _attn_pool(user_q: torch.Tensor, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product pooling of x (B, L, D) by the user query (B, D):
    fp32 logits times JAX's fp32 1/√D, a softmax over the live steps (0 for
    a row with none), the weights in x's dtype for the sum."""
    scale = float(np.float32(1.0) / np.sqrt(np.float32(x.shape[-1])))
    logits = torch.einsum("bld,bd->bl", x.to(torch.float32), user_q.to(torch.float32)) * scale
    logits = torch.where(m.bool(), logits, -1e9)
    w = torch.softmax(logits, dim=-1) * (m.sum(dim=-1, keepdim=True) > 0)
    return torch.einsum("bl,bld->bd", w.to(x.dtype), x)


class SDM(_RetrievalBase):
    """Sequential deep matching: a short-term channel (the last
    ``short_len`` live steps of the concat-embedded history through
    ``short_lstm``, ``lstm_layers`` stacked LSTMs, then ``short_mha`` under
    the valid×valid mask, pooled by ``user_to_short``'s query) and a
    long-term channel (each series pooled by ``user_to_long``'s query, then
    ``long_proj``), fused by the gate σ(``gate_user``(u) + ``gate_long``(p) +
    ``gate_short``(s)): user = (1 − g)·p + g·s. Needs user features."""

    def __init__(self, *args, short_len: int = 10, num_heads: int = 2, lstm_layers: int = 2, **kw):
        super().__init__(*args, **kw)
        if not self.user_features:
            raise ValueError("SDM needs user features for its channel queries")
        d, e = self.behavior_dim, self.embed_dim
        self.short_len = short_len
        profile = len(self.user_features) * e
        self.user_to_short = Dense(profile, d, self.dtype)
        self.user_to_long = Dense(profile, e, self.dtype)
        self.short_lstm = MaskedLSTM(d, d, num_layers=lstm_layers, dtype=self.dtype)
        self.short_mha = MultiHeadAttention(d, num_heads, max(1, d // num_heads), dtype=self.dtype)
        self.long_proj = Dense(len(self.sequence_features) * e, d, self.dtype)
        self.gate_user = Dense(d, d, self.dtype)
        self.gate_long = Dense(d, d, self.dtype)
        self.gate_short = Dense(d, d, self.dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        behavior, mask = self._behavior(inputs)
        l = behavior.shape[1]
        profile = self._profile_vec(inputs)
        user_short = torch.tanh(self.user_to_short(profile))
        user_long = torch.tanh(self.user_to_long(profile))
        # the last s live steps (histories are oldest first, tail-padded)
        s = min(self.short_len, l)
        lengths = mask.sum(dim=-1, keepdim=True)
        win_pos = lengths - s + torch.arange(s, device=mask.device)[None, :]
        win_mask = (win_pos >= 0).to(mask.dtype)
        short_seq = gather_steps(behavior, win_pos.clamp(0, l - 1).to(torch.int64))
        short_seq = short_seq * win_mask[..., None].to(short_seq.dtype)
        states = self.short_lstm(short_seq, win_mask)
        rect = win_mask[:, :, None] * win_mask[:, None, :]
        states = self.short_mha(states, mask=rect)
        s_t = _attn_pool(user_short, states, win_mask)
        pooled = [_attn_pool(user_long, self.emb(inputs[n]), mask) for n in self.sequence_features]
        p_t = torch.tanh(self.long_proj(torch.cat(pooled, dim=-1)))
        gate = torch.sigmoid(self.gate_user(user_short) + self.gate_long(p_t) + self.gate_short(s_t))
        user_vec = (1.0 - gate) * p_t + gate * s_t
        target = self._target(inputs)
        out: Outputs = {
            "user_embedding": user_vec,
            "item_embedding": target,
            "output": _dot(user_vec, target),
        }
        return self._finalize(out, inputs)


class ComiRec(_RetrievalBase):
    """Controllable multi-interest retrieval: ``variant='dr'`` (dynamic
    routing with per-position maps, no kernel) or ``'sa'`` (self-attentive
    capsules over the behavior plus sinusoidal positions). The user vector
    is the capsule with the largest inner product with the target (its
    cosine under ``normalize_logits``). ``max_seq_length`` sizes the 'dr'
    maps (the builder takes it from ``DataInfo``)."""

    def __init__(
        self,
        *args,
        variant: str = "sa",
        num_interests: int = 4,
        attention_dim: int = 32,
        max_seq_length: int = 0,
        **kw,
    ):
        super().__init__(*args, **kw)
        if variant not in ("sa", "dr"):
            raise ValueError(f"unknown ComiRec variant {variant!r}")
        self.variant = variant
        self.num_interests = num_interests
        d = self.behavior_dim
        if variant == "dr":
            self.routing = CapsuleRouting(
                d, num_interests, d, mode="per_pos", max_length=max_seq_length, dtype=self.dtype
            )
        else:
            self.w1 = Dense(d, attention_dim, self.dtype, use_bias=False)
            self.w2 = Dense(attention_dim, num_interests, self.dtype, use_bias=False)

    def forward(self, inputs: Inputs) -> Outputs:
        behavior, mask = self._behavior(inputs)
        b, l, d = behavior.shape
        if self.variant == "dr":
            capsules, cap_mask = self.routing(behavior, mask)
        else:
            pos = torch.as_tensor(sinusoidal_positions(l, d), device=behavior.device)
            a = torch.tanh(self.w1(behavior + pos[None].to(behavior.dtype)))
            a = torch.where(mask[:, :, None].bool(), self.w2(a).to(torch.float32), -1e9)
            a = torch.softmax(a, dim=1)  # (B, L, K)
            capsules = torch.einsum("blk,bld->bkd", a.to(behavior.dtype), behavior)
            cap_mask = behavior.new_ones((b, self.num_interests), dtype=torch.float32)
        target = self._target(inputs)
        sel = capsules.to(torch.float32)
        if self.normalize_logits:
            sel = sel / (torch.linalg.vector_norm(sel, dim=-1, keepdim=True) + 1e-6)
        scores = torch.einsum("bkd,bd->bk", sel, target.to(torch.float32))
        scores = torch.where(cap_mask.bool(), scores, -1e9)
        best = scores.argmax(dim=-1)
        user_vec = torch.take_along_dim(capsules, best[:, None, None], dim=1)[:, 0]
        out: Outputs = {
            "user_embedding": user_vec,
            "item_embedding": target,
            "interest_capsules": capsules,
            "capsule_mask": cap_mask,
            "output": scores.max(dim=-1).values,
        }
        return self._finalize(out, inputs)


class SINE(_RetrievalBase):
    """Sparse interest network: the top-K prototypes of a global
    ``interest_pool`` (P, D) activate per user, behavior steps are assigned
    to them, the per-prototype interests are aggregated with a tau-softmax
    against a predicted next intention; in training the pool's covariance
    penalty comes out as ``auxiliary_loss``."""

    def __init__(
        self,
        *args,
        pool_size: int = 32,
        num_active: int = 4,
        tau: float = 0.1,
        cov_weight: float = 0.01,
        **kw,
    ):
        super().__init__(*args, **kw)
        self.pool_size = pool_size
        self.num_active = num_active
        self.tau = tau
        self.cov_weight = cov_weight
        d = self.behavior_dim
        self.interest_pool = nn.Parameter(torch.empty(pool_size, d))
        self.intent_proj = Dense(d, d, self.dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        glorot_uniform_(self.interest_pool, generator)

    def forward(self, inputs: Inputs) -> Outputs:
        behavior, mask = self._behavior(inputs)
        f32 = torch.float32
        live = mask.bool()
        pool = self.interest_pool.to(behavior.dtype)
        w_mask = mask[..., None].to(behavior.dtype)
        summary = (behavior * w_mask).sum(dim=1) / w_mask.sum(dim=1).clamp_min(1.0)
        act = summary.to(f32) @ pool.to(f32).T
        topk_val, topk_idx = top_k(act, self.num_active)
        active = pool[topk_idx] * torch.sigmoid(topk_val)[..., None].to(pool.dtype)  # (B, K, D)
        assign = torch.einsum("bld,bkd->blk", behavior.to(f32), active.to(f32))
        p_lk = torch.softmax(torch.where(live[:, :, None], assign, -1e9), dim=-1)
        attn = torch.einsum("bld,bd->bl", behavior.to(f32), summary.to(f32))
        attn = torch.softmax(torch.where(live, attn, -1e9), dim=-1)
        w_blk = (p_lk * attn[:, :, None] * mask[:, :, None]).to(behavior.dtype)
        interests = torch.einsum("blk,bld->bkd", w_blk, behavior)
        norm = torch.linalg.vector_norm(interests.to(f32), dim=-1, keepdim=True) + 1e-8
        interests = interests / norm.to(interests.dtype)
        c_apt = torch.tanh(self.intent_proj(summary))
        agg = torch.einsum("bkd,bd->bk", interests.to(f32), c_apt.to(f32))
        e_k = torch.softmax(agg / self.tau, dim=-1)
        user_vec = torch.einsum("bk,bkd->bd", e_k.to(interests.dtype), interests)
        target = self._target(inputs)
        out: Outputs = {
            "user_embedding": user_vec,
            "item_embedding": target,
            "interest_capsules": interests,
            "output": _dot(user_vec, target),
        }
        if self.training and self.cov_weight > 0:
            p = pool.to(f32)
            p = p - p.mean(dim=0, keepdim=True)
            cov = (p.T @ p) / self.pool_size
            off_diag = cov - torch.diag(torch.diag(cov))
            out["auxiliary_loss"] = self.cov_weight * 0.5 * torch.square(off_diag).sum()
        return self._finalize(out, inputs)
