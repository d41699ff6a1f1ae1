"""Personalization-gate models (counterpart of ``tpurec/models/poso.py``):
POSO for an MLP, for multi-head attention and for MMOE, and PEPNet.

POSO scales every module by a gate computed from personalization features
(the ``gate_features``' embeddings, by default the first feature's):
gate = 2·sigmoid(fc2(relu(fc1(pc)))) ∈ [0, 2] (``GateNU``). The shared
table is looked up twice a forward, on all fields and on the gate fields;
each engine sums both lookups' gradients into the table, as the JAX
package's two VJPs do, and the lazy-sparse engine counts both lookups'
used-id L2 terms. Child modules keep the flax names (``emb``, ``fc1``,
``fc2``, ``poso_mlp``, ``gate_{i}``, ``q``/``k``/``v``, ``ln``,
``experts``, ``ep_gate``, ``{task}_pptower``...).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.models.base import Inputs, Outputs, binary_output, stack_ids
from tpurec_torch.models.multitask import ExpertBank, _mix, _softmax_gate
from tpurec_torch.ops.attention import scaled_dot_attention
from tpurec_torch.ops.mlp import MLP, Dense, LayerNorm


class GateNU(nn.Module):
    """gate = ``scale``·sigmoid(fc2(relu(fc1(pc))))."""

    def __init__(self, in_features: int, out_dim: int, hidden_dim: int = 32, scale: float = 2.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = scale
        self.fc1 = Dense(in_features, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, out_dim, dtype)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return self.scale * torch.sigmoid(self.fc2(torch.relu(self.fc1(pc))))


class PosoMLP(nn.Module):
    """Dense stack whose layer ``dense_{i}`` (relu) is scaled by its own
    gate ``gate_{i}`` of the personalization input."""

    def __init__(self, in_features: int, pc_features: int, hidden_dims: Sequence[int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        width_in = in_features
        for i, width in enumerate(self.hidden_dims):
            self.add_module(f"dense_{i}", Dense(width_in, width, dtype))
            self.add_module(f"gate_{i}", GateNU(pc_features, width, dtype=dtype))
            width_in = width

    def forward(self, x: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden_dims)):
            x = torch.relu(getattr(self, f"dense_{i}")(x)) * getattr(self, f"gate_{i}")(pc)
        return x


class _PosoBase(nn.Module):
    """The shared embedding ``emb`` and the personalization input ``pc``:
    the gate features' embeddings, flattened (the first feature's when
    ``gate_features`` is empty)."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        gate_features: Sequence[str] = (),
        embed_dim: int = 8,
        hidden_dims: Sequence[int] = (64, 32),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.gate_names = list(gate_features) or [self.feature_names[0]]
        self.embed_dim = embed_dim
        self.hidden_dims = tuple(hidden_dims)
        self.dtype = dtype
        self.num_fields = len(self.feature_names)
        self.pc_features = len(self.gate_names) * embed_dim
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def embed(self, inputs: Inputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """((B, F, D) field embeddings, (B, G·D) personalization input);
        the gate fields are looked up first, as in the JAX package."""
        pc = self.emb(stack_ids(inputs, self.gate_names))
        emb = self.emb(stack_ids(inputs, self.feature_names))
        return emb, pc.reshape(pc.shape[0], -1)


class PosoMLPModel(_PosoBase):
    """Binary ranking with a POSO-gated MLP trunk ``poso_mlp`` → ``head``."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.poso_mlp = PosoMLP(self.num_fields * self.embed_dim, self.pc_features,
                                self.hidden_dims, self.dtype)
        self.head = Dense(self.hidden_dims[-1], 1, self.dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        emb, pc = self.embed(inputs)
        h = self.poso_mlp(emb.reshape(emb.shape[0], -1), pc)
        return binary_output(self.head(h))


class PosoMHAModel(_PosoBase):
    """Self-attention over the fields with POSO-gated keys and values: the
    keys are the embeddings scaled per dimension by ``k_gate``; the values a
    mixture of ``n_value_candidates`` projections ``v_proj_{i}`` weighted by
    the softmax of ``v_gate`` (scale 1). Bias-free ``q``/``k``/``v``
    projections over ``num_heads`` heads of max(1, D // heads), then
    ``ln``(``out``(attention) + embeddings) → ``mlp`` → ``head``."""

    def __init__(self, *args, num_heads: int = 2, n_value_candidates: int = 2, **kw):
        super().__init__(*args, **kw)
        d, dt = self.embed_dim, self.dtype
        self.num_heads = num_heads
        self.n_value_candidates = n_value_candidates
        self.head_dim = max(1, d // num_heads)
        width = num_heads * self.head_dim
        self.k_gate = GateNU(self.pc_features, d, dtype=dt)
        for i in range(n_value_candidates):
            self.add_module(f"v_proj_{i}", Dense(d, d, dt))
        self.v_gate = GateNU(self.pc_features, n_value_candidates, scale=1.0, dtype=dt)
        self.q = Dense(d, width, dt, use_bias=False)
        self.k = Dense(d, width, dt, use_bias=False)
        self.v = Dense(d, width, dt, use_bias=False)
        self.out = Dense(width, d, dt)
        self.ln = LayerNorm(d, dt)
        self.mlp = MLP(self.num_fields * d, self.hidden_dims, dtype=dt)
        self.head = Dense(self.hidden_dims[-1], 1, dt)

    def _heads(self, proj: Dense, x: torch.Tensor) -> torch.Tensor:
        b, f, _ = x.shape
        return proj(x).reshape(b, f, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, inputs: Inputs) -> Outputs:
        emb, pc = self.embed(inputs)
        b, f, _ = emb.shape
        keys = emb * self.k_gate(pc)[:, None, :]
        v_gate = torch.softmax(self.v_gate(pc).to(torch.float32), dim=-1)
        values = sum(
            getattr(self, f"v_proj_{i}")(emb) * v_gate[:, i, None, None].to(emb.dtype)
            for i in range(self.n_value_candidates)
        )
        att = scaled_dot_attention(self._heads(self.q, emb), self._heads(self.k, keys),
                                   self._heads(self.v, values))
        att = att.transpose(1, 2).reshape(b, f, self.num_heads * self.head_dim)
        att = self.ln(self.out(att) + emb)
        logit = self.head(self.mlp(att.reshape(b, -1)))
        return binary_output(logit)


class PosoMMOEModel(_PosoBase):
    """MMOE whose expert outputs are scaled by a personalization gate
    ``poso_gate`` (one value an expert)."""

    def __init__(self, *args, task_names: Sequence[str] = ("ctr", "cvr"), num_experts: int = 4,
                 expert_dims: Sequence[int] = (64, 32), tower_dims: Sequence[int] = (32,), **kw):
        super().__init__(*args, **kw)
        self.task_names = list(task_names)
        width, dt = self.num_fields * self.embed_dim, self.dtype
        self.experts = ExpertBank(width, num_experts, expert_dims)
        self.poso_gate = GateNU(self.pc_features, num_experts, dtype=dt)
        for task in self.task_names:
            self.add_module(f"{task}_gate", Dense(width, num_experts, dt))
            self.add_module(f"{task}_tower", MLP(expert_dims[-1], tower_dims, dtype=dt))
            self.add_module(f"{task}_head", Dense(tower_dims[-1], 1, dt))

    def forward(self, inputs: Inputs) -> Outputs:
        emb, pc = self.embed(inputs)
        x = emb.reshape(emb.shape[0], -1)
        experts = self.experts(x) * self.poso_gate(pc)[..., None]  # (B, E, H)
        out: Dict[str, torch.Tensor] = {}
        for task in self.task_names:
            gate = _softmax_gate(getattr(self, f"{task}_gate")(x), experts.dtype)
            h = getattr(self, f"{task}_tower")(_mix(gate, experts))
            logit = getattr(self, f"{task}_head")(h).reshape(-1).to(torch.float32)
            out[f"{task}_logit"] = logit
            out[f"{task}_output"] = torch.sigmoid(logit)
        return out


class PEPNet(_PosoBase):
    """EPNet: per-field scalar gates ``ep_gate`` on the embeddings; PPNet: a
    POSO-gated tower ``{task}_pptower`` on a detached copy of the gated
    embeddings, beside a plain ``{task}_base`` MLP, both into
    ``{task}_head``."""

    def __init__(self, *args, task_names: Sequence[str] = ("ctr", "cvr"),
                 tower_dims: Sequence[int] = (64, 32), **kw):
        super().__init__(*args, **kw)
        self.task_names = list(task_names)
        width, dt = self.num_fields * self.embed_dim, self.dtype
        self.ep_gate = GateNU(self.pc_features, self.num_fields, dtype=dt)
        for task in self.task_names:
            self.add_module(f"{task}_pptower", PosoMLP(width, self.pc_features, tower_dims, dt))
            self.add_module(f"{task}_base", MLP(width, tower_dims, dtype=dt))
            self.add_module(f"{task}_head", Dense(2 * tower_dims[-1], 1, dt))

    def forward(self, inputs: Inputs) -> Outputs:
        emb, pc = self.embed(inputs)
        b = emb.shape[0]
        x = (emb * self.ep_gate(pc)[:, :, None]).reshape(b, -1)
        x_sg = x.detach()  # PPNet: no gradient into the embeddings through its towers
        out: Dict[str, torch.Tensor] = {}
        for task in self.task_names:
            h = getattr(self, f"{task}_pptower")(x_sg, pc)
            base = getattr(self, f"{task}_base")(x)
            logit = getattr(self, f"{task}_head")(torch.cat([base, h], dim=-1))
            logit = logit.reshape(-1).to(torch.float32)
            out[f"{task}_logit"] = logit
            out[f"{task}_output"] = torch.sigmoid(logit)
        return out
