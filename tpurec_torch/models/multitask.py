"""Multi-task stack (counterpart of ``tpurec/models/multitask.py``): MMOE,
ESMM, PLE, ESM2, ESCM2 (IPS/DR) and FDN.

Expert banks run as one batched product per layer (the experts share an
(E, in, out) weight), as in the JAX package. Gates are softmaxed once, in
fp32, and cast back to the experts' dtype (the reference's MMOE/ESMM double
softmax is not replicated, as in the JAX package). ESM2, ESCM2 and FDN
compute their total loss in the model (``loss='model_loss'``).

Child modules and raw parameters keep the flax names (``emb``, ``experts``,
``{task}_gate``, ``{task}_tower``, ``{task}_head``, ``L{level}_...``,
``trunk``, ``imputation``, FDN's ``L{level}_{task}_aux_w``/``_aux_b``), so
weights map across by path. ``ExpertBank`` is tensor parallel over a
mesh's 'model' axis (``ExpertBank.place``), as the JAX package partitions
it: that changes where its weights live, not what they compute.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from tpurec_torch.embedding.modules import SharedEmbedding
from tpurec_torch.core.collectives import psum, replicated_input
from tpurec_torch.initializers import draw_share_, glorot_uniform_
from tpurec_torch.models.base import Inputs, Outputs, stack_continuous, stack_ids
from tpurec_torch.ops.mlp import MLP, Dense, gather_columns, share, split_over_model, tp_input

_EPS = 1e-7


def _bce(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Per-example BCE on probabilities clipped to [1e-7, 1 − 1e-7], fp32."""
    p = probs.to(torch.float32).clamp(_EPS, 1 - _EPS)
    y = labels.to(torch.float32)
    return -(y * torch.log(p) + (1 - y) * torch.log1p(-p))


def _softmax_gate(gate: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gate's softmax in fp32, cast to the experts' ``dtype``."""
    return torch.softmax(gate.to(torch.float32), dim=-1).to(dtype)


def _mix(gate: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    """(B, E) gate · (B, E, H) experts → (B, H)."""
    return torch.einsum("be,beh->bh", gate, experts)


class ExpertBank(nn.Module):
    """E parallel MLPs as batched products: weights ``w_{i}`` (E, in, out)
    (glorot uniform over flax's receptive-field fans: in·E and out·E) and
    biases ``b_{i}`` (E, out), fp32; each layer ``relu(x·w + b)`` in x's
    dtype with the weights cast to it. A (B, in) input is broadcast over the
    experts; a (B, E, in) input gives each expert its own stream. (The JAX
    module's ``dtype`` field is unused there too: the input sets the
    compute dtype.)

    On a mesh (``place``) the layers are tensor parallel over 'model' as
    ``tpurec/models/multitask.py:52-60`` partitions them: even layers split
    ``w_{i}`` over out and ``b_{i}`` with it (``'column'``), odd layers
    split ``w_{i}`` over in and keep ``b_{i}`` whole, added once after the
    sum over the axis (``'row'``); a width that does not divide stays
    whole. The collectives are ``ops.mlp.Dense``'s."""

    def __init__(self, in_features: int, num_experts: int, hidden_dims: Sequence[int]):
        super().__init__()
        self.num_experts = num_experts
        self.hidden_dims = tuple(hidden_dims)
        width_in = in_features
        for i, width in enumerate(self.hidden_dims):
            self.register_parameter(f"w_{i}", nn.Parameter(torch.empty(num_experts, width_in, width)))
            self.register_parameter(f"b_{i}", nn.Parameter(torch.empty(num_experts, width)))
            width_in = width
        self.mesh = None
        self.splits = [None] * len(self.hidden_dims)
        self.shard_dims: Dict[str, int] = {}

    def place(self, mesh) -> None:
        """Hold this rank's share of each layer over ``mesh``'s 'model' axis.
        Call before ``init_weights``."""
        for i in range(len(self.hidden_dims)):
            w, b = getattr(self, f"w_{i}"), getattr(self, f"b_{i}")
            dim = 2 if i % 2 == 0 else 1
            if not split_over_model(w.shape[dim], mesh):
                continue
            self.mesh = mesh
            self.splits[i] = "column" if dim == 2 else "row"
            shape = list(w.shape)
            shape[dim] //= mesh.n_model
            self.register_parameter(f"w_{i}", nn.Parameter(w.new_empty(shape)))
            self.shard_dims[f"w_{i}"] = dim
            if dim == 2:
                self.register_parameter(f"b_{i}", nn.Parameter(b.new_empty(shape[0], shape[2])))
                self.shard_dims[f"b_{i}"] = 1

    def init_weights(self, generator: torch.Generator) -> None:
        for i in range(len(self.hidden_dims)):
            name = f"w_{i}"
            split = share(self.mesh, self.shard_dims[name]) if name in self.shard_dims else None
            draw_share_(getattr(self, name), lambda t: glorot_uniform_(t, generator), split)
            nn.init.zeros_(getattr(self, f"b_{i}"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, None, :].expand(x.shape[0], self.num_experts, x.shape[-1])
        sharded = False  # x's last axis is this rank's share over 'model'
        for i, split in enumerate(self.splits):
            w, b = getattr(self, f"w_{i}"), getattr(self, f"b_{i}")
            x = tp_input(x, split, sharded, self.mesh)
            if split == "column":
                x = replicated_input(x, self.mesh.model_group)
            y = torch.einsum("bed,edh->beh", x, w.to(x.dtype))
            if split == "row":
                y = psum(y, self.mesh.model_group)
            x = torch.relu(y + b.to(x.dtype))
            sharded = split == "column"
        return gather_columns(x, self.mesh) if sharded else x  # (B, E, out)


class _MultiTaskBase(nn.Module):
    """The shared embedding ``emb`` over the categorical features, the trunk
    input [flattened embeddings ∥ continuous features], and the task towers
    ``{name}_tower`` (MLP) → ``{name}_head`` (Dense(1))."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        task_names: Sequence[str] = ("ctr", "cvr"),
        num_experts: int = 4,
        expert_dims: Sequence[int] = (64, 32),
        tower_dims: Sequence[int] = (32,),
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.feature_names = list(feature_names)
        self.continuous_names = list(continuous_names)
        self.task_names = list(task_names)
        self.num_experts = num_experts
        self.expert_dims = tuple(expert_dims)
        self.tower_dims = tuple(tower_dims)
        self.dtype = dtype
        self.input_dim = len(self.feature_names) * embed_dim + len(self.continuous_names)
        self.emb = SharedEmbedding(vocab_size, embed_dim, dtype=dtype)

    def trunk_input(self, inputs: Inputs) -> torch.Tensor:
        emb = self.emb(stack_ids(inputs, self.feature_names))
        parts = [emb.reshape(emb.shape[0], -1)]
        cont = stack_continuous(inputs, self.continuous_names)
        if cont is not None:
            parts.append(cont.to(parts[0].dtype))
        return torch.cat(parts, dim=-1)

    def add_tower(self, name: str, in_features: int) -> None:
        self.add_module(f"{name}_tower", MLP(in_features, self.tower_dims, dtype=self.dtype))
        self.add_module(f"{name}_head", Dense(self.tower_dims[-1], 1, self.dtype))

    def tower_logit(self, x: torch.Tensor, name: str) -> torch.Tensor:
        h = getattr(self, f"{name}_tower")(x)
        return getattr(self, f"{name}_head")(h).reshape(-1).to(torch.float32)


class MMOE(_MultiTaskBase):
    """Multi-gate mixture of experts: one expert bank, a softmax gate
    ``{task}_gate`` and a tower per task."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.experts = ExpertBank(self.input_dim, self.num_experts, self.expert_dims)
        for task in self.task_names:
            self.add_module(f"{task}_gate", Dense(self.input_dim, self.num_experts, self.dtype))
            self.add_tower(task, self.expert_dims[-1])

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.trunk_input(inputs)
        experts = self.experts(x)  # (B, E, H)
        out: Dict[str, torch.Tensor] = {}
        for task in self.task_names:
            gate = _softmax_gate(getattr(self, f"{task}_gate")(x), experts.dtype)
            logit = self.tower_logit(_mix(gate, experts), task)
            out[f"{task}_logit"] = logit
            out[f"{task}_output"] = torch.sigmoid(logit)
        return out


class ESMM(_MultiTaskBase):
    """Entire-space multi-task: pCTCVR = pCTR × pCVR over the experts' mean;
    the CVR tower is supervised only through the ctcvr product."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.experts = ExpertBank(self.input_dim, self.num_experts, self.expert_dims)
        for task in ("ctr", "cvr"):
            self.add_tower(task, self.expert_dims[-1])

    def forward(self, inputs: Inputs) -> Outputs:
        shared = self.experts(self.trunk_input(inputs)).mean(dim=1)
        ctr_logit = self.tower_logit(shared, "ctr")
        ctr = torch.sigmoid(ctr_logit)
        cvr = torch.sigmoid(self.tower_logit(shared, "cvr"))
        return {"ctr_logit": ctr_logit, "ctr_output": ctr, "cvr_output": cvr, "ctcvr_output": ctr * cvr}


class PLE(_MultiTaskBase):
    """Progressive layered extraction: ``num_levels`` CGC levels of
    task-specific (``L{l}_{task}_experts``) and shared
    (``L{l}_shared_experts``) expert banks. Each task's gate mixes
    [its experts ∥ the shared ones]; every level but the last also mixes
    [all tasks' experts ∥ shared] into the next shared stream."""

    def __init__(self, *args, num_levels: int = 2, experts_per_task: int = 2,
                 shared_experts: int = 2, return_cgc_output: bool = False, **kw):
        super().__init__(*args, **kw)
        self.num_levels = num_levels
        self.return_cgc_output = return_cgc_output
        hidden = self.expert_dims[-1]
        n_tasks = len(self.task_names)
        for level in range(num_levels):
            width = self.input_dim if level == 0 else hidden
            for t in self.task_names:
                self.add_module(f"L{level}_{t}_experts",
                                ExpertBank(width, experts_per_task, self.expert_dims))
            self.add_module(f"L{level}_shared_experts",
                            ExpertBank(width, shared_experts, self.expert_dims))
            for t in self.task_names:
                self.add_module(f"L{level}_{t}_gate",
                                Dense(width, experts_per_task + shared_experts, self.dtype))
            if level < num_levels - 1:
                self.add_module(f"L{level}_shared_gate",
                                Dense(width, n_tasks * experts_per_task + shared_experts, self.dtype))
        for t in self.task_names:
            self.add_tower(t, hidden)

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.trunk_input(inputs)
        tasks = self.task_names
        streams = {t: x for t in tasks}
        shared_stream = x
        for level in range(self.num_levels):
            task_outs = {t: getattr(self, f"L{level}_{t}_experts")(streams[t]) for t in tasks}
            shared_outs = getattr(self, f"L{level}_shared_experts")(shared_stream)
            new_streams = {}
            for t in tasks:
                cands = torch.cat([task_outs[t], shared_outs], dim=1)
                gate = _softmax_gate(getattr(self, f"L{level}_{t}_gate")(streams[t]), cands.dtype)
                new_streams[t] = _mix(gate, cands)
            if level < self.num_levels - 1:
                all_outs = torch.cat([task_outs[t] for t in tasks] + [shared_outs], dim=1)
                sgate = _softmax_gate(getattr(self, f"L{level}_shared_gate")(shared_stream),
                                      all_outs.dtype)
                shared_stream = _mix(sgate, all_outs)
            streams = new_streams
        out: Dict[str, torch.Tensor] = {}
        for t in tasks:
            logit = self.tower_logit(streams[t], t)
            out[f"{t}_logit"] = logit
            out[f"{t}_output"] = torch.sigmoid(logit)
            if self.return_cgc_output:
                out[f"{t}_cgc"] = streams[t]
        return out


# ESM2's eight conditional tasks, in the JAX package's order
_ESM2_TASKS = (
    "click", "cart_given_click", "collect_given_no_cart", "none_given_no_action",
    "order_given_cart", "order_given_collect", "order_given_none", "pay_given_order",
)
_ESM2_NODES = ("click", "cart", "collect", "none", "order", "pay")


class ESM2(_MultiTaskBase):
    """Full probability-graph multi-task: an eight-task gated expert trunk
    whose conditional heads compose

        click   = t0
        cart    = click · t1
        collect = click · (1−t1) · t2
        none    = click · (1−t1) · (1−t2) · t3
        order   = cart·t4 + collect·t5 + none·t6
        pay     = order · t7

    with one weighted BCE per labelled node (``loss_weights`` in node
    order). Labels 'click'…'pay' where present; 'ctr'/'cvr' stand for
    click/pay when those are absent. ``ctr_logit`` is the log-odds of the
    clipped click; ``cvr_output`` = pay / clip(click, 1e-7, 1)."""

    def __init__(self, *args, loss_weights: Sequence[float] = (1.0,) * 6, **kw):
        super().__init__(*args, **kw)
        self.loss_weights = tuple(loss_weights)
        self.experts = ExpertBank(self.input_dim, self.num_experts, self.expert_dims)
        for name in _ESM2_TASKS:
            self.add_module(f"{name}_gate", Dense(self.input_dim, self.num_experts, self.dtype))
            self.add_tower(name, self.expert_dims[-1])

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.trunk_input(inputs)
        experts = self.experts(x)  # (B, E, H)
        t = {}
        for name in _ESM2_TASKS:
            gate = _softmax_gate(getattr(self, f"{name}_gate")(x), experts.dtype)
            t[name] = torch.sigmoid(self.tower_logit(_mix(gate, experts), name))
        click = t["click"]
        no_cart = 1 - t["cart_given_click"]
        cart = click * t["cart_given_click"]
        collect = click * no_cart * t["collect_given_no_cart"]
        none = click * no_cart * (1 - t["collect_given_no_cart"]) * t["none_given_no_action"]
        order = (cart * t["order_given_cart"] + collect * t["order_given_collect"]
                 + none * t["order_given_none"])
        pay = order * t["pay_given_order"]
        clipped = click.clamp(_EPS, 1 - _EPS)
        out = {
            "ctr_logit": torch.log(clipped) - torch.log1p(-clipped),
            "ctr_output": click,
            "cart_output": cart,
            "collect_output": collect,
            "none_output": none,
            "order_output": order,
            "pay_output": pay,
            # pCTCVR = p(pay | impression); cvr_output = p(pay | click)
            "cvr_output": pay / click.clamp(_EPS, 1.0),
            "ctcvr_output": pay,
        }
        probs = dict(zip(_ESM2_NODES, (click, cart, collect, none, order, pay)))
        labels = {k: inputs[k] for k in _ESM2_NODES if k in inputs}
        if "click" not in labels and "ctr" in inputs:
            labels["click"] = inputs["ctr"]
        if "pay" not in labels and "cvr" in inputs:
            labels["pay"] = inputs["cvr"]
        if labels:
            loss = torch.zeros((), dtype=torch.float32, device=click.device)
            for w, node in zip(self.loss_weights, _ESM2_NODES):
                if node in labels:
                    loss = loss + w * _bce(labels[node].reshape(-1), probs[node]).mean()
            out["loss"] = loss
        return out


class ESCM2(nn.Module):
    """Entire-space counterfactual multi-task: a ``trunk`` (PLE returning its
    CGC outputs, or MMOE) plus a counterfactual CVR term, IPS (the clipped
    CTR propensity, detached) or DR (an ``imputation`` MLP (32, 1) on the CVR
    CGC output). The total loss is computed in the model."""

    def __init__(
        self,
        feature_names: Sequence[str],
        vocab_size: int,
        continuous_names: Sequence[str] = (),
        embed_dim: int = 8,
        counterfact_mode: str = "ips",
        ctr_weight: float = 1.0,
        cvr_weight: float = 0.5,
        ctcvr_weight: float = 1.0,
        propensity_clip: float = 0.05,
        trunk: str = "ple",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.counterfact_mode = counterfact_mode
        self.ctr_weight, self.cvr_weight, self.ctcvr_weight = ctr_weight, cvr_weight, ctcvr_weight
        self.propensity_clip = propensity_clip
        common = dict(feature_names=feature_names, vocab_size=vocab_size,
                      continuous_names=continuous_names, embed_dim=embed_dim,
                      task_names=("ctr", "cvr"), dtype=dtype)
        if trunk == "ple":
            self.trunk = PLE(return_cgc_output=True, **common)
        else:
            self.trunk = MMOE(**common)
        if counterfact_mode != "ips":
            self.imputation = MLP(self.trunk.expert_dims[-1], (32, 1), out_activation="linear",
                                  dtype=dtype)

    def forward(self, inputs: Inputs) -> Outputs:
        trunk_out = self.trunk(inputs)
        p_ctr, p_cvr = trunk_out["ctr_output"], trunk_out["cvr_output"]
        ctcvr = p_ctr * p_cvr
        out = dict(trunk_out, ctcvr_output=ctcvr)
        if "ctr" in inputs:
            o = inputs["ctr"].reshape(-1).to(torch.float32)  # click indicator
            r = inputs["cvr"].reshape(-1).to(torch.float32)  # conversion
            loss_ctr = _bce(o, p_ctr).mean()
            loss_ctcvr = _bce(r, ctcvr).mean()
            p_hat = p_ctr.detach().clamp(self.propensity_clip, 1.0)
            e = _bce(r, p_cvr)  # per-example CVR error
            if self.counterfact_mode == "ips":
                loss_cvr = (o * e / p_hat).mean()
            else:  # doubly robust
                e_hat = self.imputation(trunk_out.get("cvr_cgc")).reshape(-1).to(torch.float32)
                loss_err = (e_hat + o * (e - e_hat) / p_hat).mean()
                loss_imp = (o * torch.square(e - e_hat) / p_hat).mean()
                loss_cvr = loss_err + loss_imp
            out["loss"] = (self.ctr_weight * loss_ctr + self.cvr_weight * loss_cvr
                           + self.ctcvr_weight * loss_ctcvr)
        return out


class FDN(_MultiTaskBase):
    """Feature-decomposition network: PLE whose task-specific experts are
    paired 1:1 with shared ones (shared = ``experts_per_task`` × tasks) and
    pushed orthogonal per level (the batch mean of Σ_pairs ⟨specific,
    shared⟩² on the raw outputs, fp32), with a sigmoid auxiliary head per
    task-specific expert (raw ``L{l}_{task}_aux_w`` (E, H), ``_aux_b`` (E,)
    at the model's root) supervised by the task's label. The total loss
    (main + ``aux_weight``·aux + ``orth_weight``·orth) and the orthogonality
    term (``orth_loss_value``) are computed in the model."""

    def __init__(self, *args, num_levels: int = 2, experts_per_task: int = 2,
                 orth_weight: float = 0.01, aux_weight: float = 0.1, **kw):
        super().__init__(*args, **kw)
        self.num_levels = num_levels
        self.experts_per_task = experts_per_task
        self.orth_weight, self.aux_weight = orth_weight, aux_weight
        hidden = self.expert_dims[-1]
        n_tasks = len(self.task_names)
        shared_count = experts_per_task * n_tasks
        for level in range(num_levels):
            width = self.input_dim if level == 0 else hidden
            for t in self.task_names:
                self.add_module(f"L{level}_{t}_experts",
                                ExpertBank(width, experts_per_task, self.expert_dims))
            self.add_module(f"L{level}_shared_experts",
                            ExpertBank(width, shared_count, self.expert_dims))
            for t in self.task_names:
                self.register_parameter(f"L{level}_{t}_aux_w",
                                        nn.Parameter(torch.empty(experts_per_task, hidden)))
                self.register_parameter(f"L{level}_{t}_aux_b",
                                        nn.Parameter(torch.empty(experts_per_task)))
            for t in self.task_names:
                self.add_module(f"L{level}_{t}_gate",
                                Dense(width, experts_per_task + shared_count, self.dtype))
            if level < num_levels - 1:
                self.add_module(f"L{level}_sgate",
                                Dense(width, experts_per_task * n_tasks + shared_count, self.dtype))
        for t in self.task_names:
            self.add_tower(t, hidden)

    def init_weights(self, generator: torch.Generator) -> None:
        for level in range(self.num_levels):
            for t in self.task_names:
                glorot_uniform_(getattr(self, f"L{level}_{t}_aux_w"), generator)
                nn.init.zeros_(getattr(self, f"L{level}_{t}_aux_b"))

    def forward(self, inputs: Inputs) -> Outputs:
        x = self.trunk_input(inputs)
        tasks = self.task_names
        streams = {t: x for t in tasks}
        shared_stream = x
        orth_terms, aux_logits = [], []  # aux: (task, (B, E) per-expert logits)
        for level in range(self.num_levels):
            task_outs = {t: getattr(self, f"L{level}_{t}_experts")(streams[t]) for t in tasks}
            shared_outs = getattr(self, f"L{level}_shared_experts")(shared_stream)
            specific = torch.cat([task_outs[t] for t in tasks], dim=1).to(torch.float32)
            dots = torch.einsum("bmh,bmh->bm", specific, shared_outs.to(torch.float32))
            orth_terms.append(torch.square(dots).sum(dim=1).mean())
            for t in tasks:
                w, b = getattr(self, f"L{level}_{t}_aux_w"), getattr(self, f"L{level}_{t}_aux_b")
                aux = torch.einsum("beh,eh->be", task_outs[t].to(torch.float32), w) + b
                aux_logits.append((t, aux))
            new_streams = {}
            for t in tasks:
                cands = torch.cat([task_outs[t], shared_outs], dim=1)
                gate = _softmax_gate(getattr(self, f"L{level}_{t}_gate")(streams[t]), cands.dtype)
                new_streams[t] = _mix(gate, cands)
            if level < self.num_levels - 1:
                all_outs = torch.cat([task_outs[t] for t in tasks] + [shared_outs], dim=1)
                sgate = _softmax_gate(getattr(self, f"L{level}_sgate")(shared_stream), all_outs.dtype)
                shared_stream = _mix(sgate, all_outs)
            streams = new_streams
        out: Dict[str, torch.Tensor] = {}
        for t in tasks:
            logit = self.tower_logit(streams[t], t)
            out[f"{t}_logit"] = logit
            out[f"{t}_output"] = torch.sigmoid(logit)
        if "ctr" in inputs:
            labels = {"ctr": inputs["ctr"].reshape(-1), "cvr": inputs["cvr"].reshape(-1)}
            main = sum(_bce(labels[t], out[f"{t}_output"]).mean() for t in tasks) / len(tasks)
            aux = sum(_bce(labels[t][:, None], torch.sigmoid(logit)).mean()
                      for t, logit in aux_logits) / max(1, len(aux_logits))
            orth = sum(orth_terms) / max(1, len(orth_terms))
            out["loss"] = main + self.aux_weight * aux + self.orth_weight * orth
            out["orth_loss_value"] = orth
        return out
