"""Training runtime (counterpart of ``tpurec/train/trainer.py``): the dense,
lazy-sparse and fused embedding engines on one device.

One ``Trainer`` builds a registry model, trains it (forward, backward, the
optimizer chain, the streaming metric update), evaluates, keeps checkpoints,
stops early, exports for serving and infers, for every model the port has,
selected by config. The JAX package's names and call shapes are kept:
``train_step(state, batch, metric_state) -> (state, metric_state, logs)``.

- PyTorch runs eagerly: a step is a sequence of launches on the current
  stream, and nothing in it waits for the device (the loss and metrics stay
  on the device until a caller reads them); ``host_adam`` is the exception,
  its moments live on the host.
- The model and the optimizer are updated in place; the ``TrainState`` a step
  returns holds the same objects with the step count advanced.
- Dense compute runs in ``TrainConfig.compute_dtype`` (bf16 by default);
  parameters, optimizer state, the DIN attention and the loss stay fp32.
- The train step runs the model in training mode and eval and inference in
  eval mode; ops whose kernel the JAX package launches at inference only
  (the FM cross term) read that mode where the JAX package reads its
  training-phase flag (``trainer.py:1271``).
- Engines (``train_step`` dispatches as the JAX property does,
  ``trainer.py:1359-1368``): ``sparse_embedding=False`` is the dense engine
  whatever ``embedding_optimizer`` says. With ``sparse_embedding=True`` the
  tables stay the modules' ``embedding`` parameters but leave the optimizer
  chain; ``TrainState.table_opt`` holds their optimizer state and the step
  updates them in place. ``embedding_optimizer='fused_adam'`` is the fused
  engine (``_fused_step``: one id sort, identity positions, the aggregated
  gradient from kernel #9, Adam on every row as dense Adam does); ``'adam'``,
  ``'rowwise_adam'``, ``'rowwise_adagrad'`` and ``'host_adam'`` are the
  lazy-sparse engine (``_sparse_step``: unique ids, row-sparse updates).
- A mesh (``MeshConfig`` over a ``torch.distributed`` world, through
  ``core.mesh.make_mesh``): every rank is one process with one device.
  Each data rank steps on its block of the batch's rows
  (``device_batch``); the tables and their optimizer state hold this
  rank's rows over 'model' (``row_sharded_lookup`` in the dense engine,
  ``_sparse_step``'s row-sharded take of the global batch's unique ids in
  the lazy-sparse ones, ``_fused_step_sharded`` in the fused one), and the
  tensor-parallel weights (an ``MLP`` with ``tp_axis``, ``ExpertBank``,
  ``MultiHeadAttention``) their share over 'model'
  (``models.registry.place_on_mesh``). The gradients are averaged over
  'data', so they are the global batch's, as GSPMD's are in the JAX
  package; so are the logged loss and terms, the used-id L2 (each row
  the global batch touches counts once), the global-norm clip, the
  ``BatchNorm`` moments and the metrics (a batch whose rows do not divide
  over 'data' is whole on every rank and counted once). The terms that
  couple the batch's rows read the global batch over 'data'
  (``core.collectives.gather_batch``, whose backward returns every rank's
  cotangent to the rows' owner): the in-batch softmax's items and its
  accuracy (``losses.tower_logits``), DIEN's rolled negatives and DMR's
  auxiliary softmax, each masked mean's count (``data_mean_share``), and
  the sampled negatives (each rank keeps its block of the global draw).
  Every model trains on every mesh in every engine the JAX package
  allows there: ``host_adam`` on more than one device raises its error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import math
import os
import re
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from tpurec_torch.config import ExperimentConfig, OptimizerConfig
from tpurec_torch.core.collectives import all_reduce_, gather_rows, local_share
from tpurec_torch.core.early_stop import EarlyStopper
from tpurec_torch.core.mesh import MeshContext, make_mesh
from tpurec_torch.core.metrics import AUC, Mean, MetricBundle
from tpurec_torch.core.summary import NullSummaryWriter, SummaryWriter
from tpurec_torch.core import trace
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.embedding import sparse as sparse_ops
from tpurec_torch.embedding.host_offload import HostAdamState, HostAdamStore
from tpurec_torch.embedding.modules import (
    EmbeddingTable,
    embedding_tables,
    record_used_id_l2,
    sparse_rows,
)
from tpurec_torch.embedding.ops import pad_vocab, row_sharded_lookup
from tpurec_torch.models import build_model
from tpurec_torch.models.registry import replicated_batch, sharded_weights
from tpurec_torch.models.mind import sampling_generator
from tpurec_torch.ops.mlp import dropout_generator
from tpurec_torch.ops import embedding_update as eu
from tpurec_torch.train import checkpoint as ckpt_lib
from tpurec_torch.train.losses import add_auxiliary, get_loss, tower_logits

# table optimizers of the sparse engines, with their state's init
_TABLE_OPT_INIT = {
    "adam": sparse_ops.init_sparse_adam,
    "fused_adam": sparse_ops.init_sparse_adam,  # dense-parity moments
    "rowwise_adagrad": sparse_ops.init_sparse_adagrad,
    "rowwise_adam": sparse_ops.init_sparse_row_adam,
    "host_adam": None,  # moments in a HostAdamStore
}
_FUSED_BACKWARDS = ("permute", "sort_payload", "xla_packed")


class DeviceBatch(dict):
    """A batch on the device (``Trainer.device_batch``), its columns by name.
    ``replicated``: on a mesh with data > 1, every data rank holds the
    whole batch (its rows do not divide over the axis), not its block."""

    replicated = False


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: "ChainOptimizer"
    generator: torch.Generator  # for stochastic layers (dropout, sampling)
    # sparse engines: the table optimizer state by table parameter name
    # (``sparse.SparseAdamState`` | ``SparseAdagradState`` |
    # ``SparseRowAdamState`` | ``HostAdamState``), and for host_adam the
    # store holding the moments
    table_opt: Optional[Dict[str, Any]] = None
    host_store: Optional[HostAdamStore] = None


def resolve_embedding_engine(
    config: ExperimentConfig, info: DataInfo, n_model: int = 1
) -> ExperimentConfig:
    """``embedding_optimizer='auto'`` resolves to the dense engine, as in the
    JAX package (``trainer.py:105-123``, a rule from TPU measurements, whose
    ``n_model`` does not enter it either; its H100 form is ROADMAP Queue 1
    item 11)."""
    oc = config.train.optimizer
    if oc.embedding_optimizer != "auto":
        return config
    train = config.train.replace(
        sparse_embedding=False, optimizer=oc.replace(embedding_optimizer="adam")
    )
    return config.replace(train=train)


def _check_engine(config: ExperimentConfig, info: DataInfo, mesh: MeshContext) -> None:
    """Refuse what the configured engine cannot train, as the JAX package
    does (``trainer.py:397-401``, ``:633-643``; ``host_adam`` on a mesh,
    ``:441-445``), and nothing else."""
    train = config.train
    oc = train.optimizer
    if not train.sparse_embedding:
        return
    if oc.embedding_optimizer not in _TABLE_OPT_INIT:
        raise KeyError(
            f"unknown embedding_optimizer {oc.embedding_optimizer!r}; known: "
            f"{sorted(_TABLE_OPT_INIT)}"
        )
    if mesh.n_devices > 1 and oc.embedding_optimizer == "host_adam":
        raise ValueError(
            "embedding_optimizer='host_adam' requires a single "
            "device (per-shard host callbacks are not wired yet)"
        )
    if oc.embedding_optimizer != "fused_adam":
        return
    if oc.fused_backward not in _FUSED_BACKWARDS:
        raise ValueError(f"unknown fused_backward {oc.fused_backward!r}; known: {_FUSED_BACKWARDS}")
    if info.sequence_names and info.padding_index != 0:
        raise ValueError(
            "embedding_optimizer='fused_adam' sequence support assumes "
            "padding_index == 0 (mask overrides are keyed off id 0)"
        )
    if train.loss == "in_batch_softmax":
        raise ValueError(
            "embedding_optimizer='fused_adam' cannot train in_batch_softmax losses "
            "(raw-id equality checks don't survive the position rewrite); use "
            "'adam'/'rowwise_adam'"
        )


def _table_names(model: nn.Module) -> List[str]:
    """The parameter name of each table of ``embedding_tables(model)``."""
    return [
        f"{name}.embedding" if name else "embedding"
        for name, m in model.named_modules()
        if isinstance(m, EmbeddingTable)
    ]


def shard_layouts(model: nn.Module) -> Dict[str, Tuple[Callable, Callable]]:
    """``{name: (whole, fit)}`` for every parameter of ``model`` that a mesh
    splits: the tables (``EmbeddingTable.whole``/``fit``) and the
    tensor-parallel weights (``models.registry.sharded_weights``).
    ``whole(local)`` gathers a tensor of this rank's share over 'model' (a
    collective); ``fit(current, whole)`` gives this rank's share of a whole
    one."""
    out = {n: (t.whole, lambda cur, whole, t=t: t.fit(cur, whole))
           for n, t in zip(_table_names(model), embedding_tables(model))}
    for n, (dim, mesh) in sharded_weights(model).items():
        out[n] = (
            lambda x, d=dim, m=mesh: gather_rows(x, m.model_group, m.model_index, m.n_model, d),
            lambda cur, whole, d=dim, m=mesh: local_share(whole, d, m).to(cur),
        )
    return out


def whole_tensors(model: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict[str, torch.Tensor]:
    """``tensors`` by parameter name (default: ``model``'s parameters, or
    their gradients, as the caller passes them), each split one gathered
    whole over 'model' (a collective on a mesh: every rank calls it),
    detached."""
    layouts = shard_layouts(model)
    if tensors is None:
        tensors = dict(model.named_parameters())
    return {n: layouts[n][0](t) if n in layouts else t.detach() for n, t in tensors.items()}


def _flat_ids(x: torch.Tensor) -> torch.Tensor:
    """A batch id column, flattened: (B, L) sequences column-major, so that
    after the fused step's transposed position rewrite every column of a
    lookup's ids is a contiguous run (``contiguous_take``'s contract)."""
    return (x.T if x.dim() == 2 else x).reshape(-1)


class ChainOptimizer(torch.optim.Optimizer):
    """The optimizer chain of ``tpurec/train/trainer.py:167-286``, in its
    order, over the trainable parameters (each its own group, with its name):

    1. global-norm clip as optax computes it: ``g·max/‖g‖`` when
       ‖g‖ ≥ max (``clip_grad_norm_`` adds 1e-6 to the norm);
    2. coupled L2 on ``embedding*`` tables, ``g += λ·w``, with order-1 tables
       (under a ``w`` module) taking ``embedding_l2_order1`` when it is ≥ 0;
    3. per-feature row coefficients on second-order tables
       (``embedding_l2_overrides``, a delta on top of ``embedding_l2``);
    4. adam | adamw | sgd with optax's update order, the learning rate from
       the cosine schedule as ``optax.cosine_decay_schedule`` steps it.

    Frozen parameters (``TrainConfig.freeze_prefixes``) are not in the
    optimizer: no update and no moments, as ``optax.set_to_zero`` gives them.
    They take no gradient either (``Trainer._make_optimizer`` turns their
    ``requires_grad`` off), as XLA drops the frozen branch's gradient from
    the JAX package's compiled step: a frozen DIEN trunk runs no backward,
    kernel #5 included.
    State per parameter: ``mu``, ``nu`` (Adam moments); ``count`` (updates
    applied) is kept in every group. The learning rate is computed on the
    host from ``count``, so a step never waits for the device.
    On a mesh the parameters named in ``sharded`` (tables and
    tensor-parallel weights split over 'model') enter the clip's global norm
    with every model rank's share (``model_group``); every other parameter,
    whole on each rank, counts once."""

    def __init__(
        self,
        named_params: List[Tuple[str, nn.Parameter]],
        config: OptimizerConfig,
        decay: Dict[str, float],
        row_decay: Dict[str, torch.Tensor],
        sharded: Tuple[str, ...] = (),
        model_group=None,
    ):
        if config.name not in ("adam", "adamw", "sgd"):
            raise KeyError(f"unknown optimizer {config.name!r}")
        if config.lr_schedule and not (
            config.lr_schedule == "cosine" and config.schedule_steps > 0
        ):
            raise KeyError(f"unknown lr_schedule {config.lr_schedule!r}")
        groups = [{"params": [p], "name": n, "count": 0} for n, p in named_params]
        super().__init__(groups, {})
        self.config = config
        self.decay = decay
        self.row_decay = row_decay
        self.sharded = {n for n, _ in named_params if n in sharded and model_group is not None}
        self.model_group = model_group

    def learning_rate(self, count: int) -> float:
        """The learning rate of the update after ``count`` updates."""
        oc = self.config
        if oc.lr_schedule == "cosine":
            c = min(count, oc.schedule_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / oc.schedule_steps))
            return oc.learning_rate * ((1.0 - oc.schedule_alpha) * cosine + oc.schedule_alpha)
        return oc.learning_rate

    @torch.no_grad()
    def step(self, closure=None):
        if not self.param_groups:
            return None
        oc = self.config
        names = [g["name"] for g in self.param_groups]
        params = [g["params"][0] for g in self.param_groups]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if oc.grad_clip_norm > 0:
            norms = torch._foreach_norm(grads)
            if self.sharded:
                split = [n in self.sharded for n in names]
                local = torch.stack([nm for nm, sh in zip(norms, split) if sh]).square().sum()
                whole = all_reduce_(local, self.model_group)
                rest = [nm for nm, sh in zip(norms, split) if not sh]
                norm = (whole + (torch.stack(rest).square().sum() if rest else 0.0)).sqrt()
            else:
                norm = torch.linalg.vector_norm(torch.stack(norms))
            keep = norm < oc.grad_clip_norm
            grads = [torch.where(keep, g, g / norm * oc.grad_clip_norm) for g in grads]
        for i, (name, p) in enumerate(zip(names, params)):
            if name in self.decay:
                grads[i] = grads[i] + self.decay[name] * p
            if name in self.row_decay:
                grads[i] = grads[i] + self.row_decay[name] * p
        count = self.param_groups[0]["count"]
        lr = self.learning_rate(count)
        count += 1
        for g in self.param_groups:
            g["count"] = count
        if oc.name == "sgd":
            torch._foreach_add_(params, grads, alpha=-lr)
            return None
        for p in params:
            st = self.state[p]
            if "mu" not in st:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        torch._foreach_mul_(mus, oc.b1)
        torch._foreach_add_(mus, grads, alpha=1.0 - oc.b1)
        torch._foreach_mul_(nus, oc.b2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - oc.b2)
        # optax scale_by_adam: mu_hat / (sqrt(nu_hat) + eps), eps_root = 0
        denom = torch._foreach_div(nus, 1.0 - oc.b2**count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, oc.eps)
        updates = torch._foreach_div(mus, 1.0 - oc.b1**count)
        torch._foreach_div_(updates, denom)
        if oc.name == "adamw" and oc.weight_decay:
            torch._foreach_add_(updates, params, alpha=oc.weight_decay)
        torch._foreach_add_(params, updates, alpha=-lr)
        return None


class Trainer:
    """``Trainer(config, info)`` trains on ``cuda`` unless the caller passes
    ``device="cpu"``; asking for ``cuda`` where there is none raises.
    ``mesh_ctx`` defaults to ``make_mesh(config.mesh)`` over the
    ``torch.distributed`` world (the (1, 1) mesh without one); every rank of
    a mesh runs the same calls, each on its own device."""

    def __init__(self, config: ExperimentConfig, info: DataInfo, device: DeviceLike = "cuda",
                 mesh_ctx: Optional[MeshContext] = None):
        self.device = resolve_device(device)
        self.info = info
        self.mesh_ctx = mesh_ctx or make_mesh(config.mesh)
        config = resolve_embedding_engine(config, info, self.mesh_ctx.n_model)
        _check_engine(config, info, self.mesh_ctx)
        self.config = config
        self.loss_fn = get_loss(config.train.loss)
        self.metrics = self._make_metrics()
        self.ckpt = (
            ckpt_lib.CheckpointManager(config.train.checkpoint_dir, config.train.max_to_keep)
            if config.train.checkpoint_dir
            else None
        )
        # for measurement only: a sink called with the mark's name
        # ("forward", "backward", "optimizer", "metrics", "end") at each
        # boundary of train_step's child spans (``_mark``), so a caller can
        # record CUDA events between them; training leaves it None
        self.step_marks: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------ setup
    def _make_optimizer(self, model: nn.Module) -> ChainOptimizer:
        oc = self.config.train.optimizer
        prefixes = tuple(self.config.train.freeze_prefixes)

        def frozen(name: str) -> bool:
            path = name.replace(".", "/")
            return any(path == p or path.startswith(p + "/") for p in prefixes)

        for n, p in model.named_parameters():
            if frozen(n):
                p.requires_grad_(False)
        # the sparse engines update the tables themselves
        tables = set(_table_names(model)) if self.config.train.sparse_embedding else set()
        named = [
            (n, p) for n, p in model.named_parameters() if not frozen(n) and n not in tables
        ]
        decay: Dict[str, float] = {}
        row_decay: Dict[str, torch.Tensor] = {}
        # the first global row of each table split over 'model'
        offsets = {
            n: t.row_offset
            for n, t in zip(_table_names(model), embedding_tables(model))
            if self.mesh_ctx.n_model > 1
        }
        if oc.embedding_l2 > 0 or oc.embedding_l2_order1 > 0:
            split = oc.embedding_l2_order1 >= 0
            lam = None
            if oc.embedding_l2_overrides:
                # (V,) coefficient deltas over the shared id space
                lam = np.zeros((self.info.total_dims,), np.float32)
                for name, off, dim in zip(
                    self.info.feature_names, self.info.feature_offsets, self.info.feature_dims
                ):
                    if name in oc.embedding_l2_overrides:
                        lam[off : off + dim] = oc.embedding_l2_overrides[name] - oc.embedding_l2
            for n, p in named:
                keys = n.split(".")
                is_emb = keys[-1].startswith("embedding")
                is_order1 = "w" in keys[:-1]
                if not is_emb:
                    continue
                if oc.embedding_l2 > 0 and not (split and is_order1):
                    decay[n] = oc.embedding_l2
                elif split and is_order1 and oc.embedding_l2_order1 > 0:
                    decay[n] = oc.embedding_l2_order1
                if lam is not None and not is_order1:
                    # this rank's rows of the (V,) coefficients
                    lo = offsets.get(n, 0)
                    rows = np.zeros((p.shape[0],), np.float32)
                    part = lam[lo : lo + p.shape[0]]
                    rows[: part.shape[0]] = part
                    shape = (p.shape[0],) + (1,) * (p.dim() - 1)
                    row_decay[n] = torch.as_tensor(rows, device=p.device).reshape(shape)
        sharded = tuple(offsets) + tuple(sharded_weights(model))
        return ChainOptimizer(named, oc, decay, row_decay, sharded, self.mesh_ctx.model_group)

    def _make_metrics(self) -> MetricBundle:
        loss_name = self.config.train.loss
        metrics: Dict[str, Any] = {"loss": Mean()}
        names = self.config.train.metrics
        if not names:
            names = {
                "bce": ("auc",),
                "gsu_esu": ("auc",),
                "multi_task": ("ctr_auc", "cvr_auc"),
                "in_batch_softmax": ("accuracy",),
                "model_loss": (),
            }[loss_name]
        for n in names:
            metrics[n] = Mean() if n == "accuracy" else AUC()
        return MetricBundle(metrics, device=self.device, group=self.mesh_ctx.data_group)

    def _batch_mesh(self, batch) -> Optional[MeshContext]:
        """The mesh whose 'data' axis splits ``batch``'s rows; None when
        this rank holds the whole batch (one data rank, or a replicated
        batch)."""
        m = self.mesh_ctx
        return m if m.n_data > 1 and not getattr(batch, "replicated", False) else None

    def _forward_context(self, model: nn.Module, batch, generator) -> contextlib.ExitStack:
        """A training forward's context: the sampled negatives and the
        dropout masks drawn from ``generator``, and on a replicated batch
        the modules that read the global batch over 'data' reading this
        rank's, which is whole."""
        stack = contextlib.ExitStack()
        stack.enter_context(sampling_generator(model, generator))
        stack.enter_context(dropout_generator(model, generator))
        if getattr(batch, "replicated", False):
            stack.enter_context(replicated_batch(model))
        return stack

    def _counted_elsewhere(self, batch) -> bool:
        """Whether this rank's rows of ``batch`` are counted by another rank:
        a replicated batch's rows count once, on data rank 0."""
        return getattr(batch, "replicated", False) and self.mesh_ctx.data_index != 0

    def _metric_updates(self, outputs, batch) -> Dict[str, tuple]:
        """The row-valued metric updates (AUC histograms, accuracy, each row
        weighted by ``__weight__`` when there is one); none on a rank whose
        rows another rank counts."""
        loss_name = self.config.train.loss
        upd: Dict[str, tuple] = {}
        if self._counted_elsewhere(batch):
            return upd
        weight = batch.get("__weight__")  # wrap-padded eval batches
        configured = set(self.metrics.metrics) - {"loss"}
        if loss_name == "model_loss":
            if "ctr_auc" in configured and "ctr_output" in outputs:
                upd["ctr_auc"] = (batch["ctr"].reshape(-1), outputs["ctr_output"].reshape(-1))
            if "cvr_auc" in configured and ("cvr_output" in outputs or "ctcvr_output" in outputs):
                cvr_out = outputs.get("ctcvr_output", outputs.get("cvr_output"))
                upd["cvr_auc"] = (batch["cvr"].reshape(-1), cvr_out.reshape(-1))
            if "auc" in configured and "output" in outputs:
                upd["auc"] = (batch["label"].reshape(-1), outputs["output"].reshape(-1))
        elif loss_name == "bce":
            upd["auc"] = (batch["label"].reshape(-1), outputs["output"].reshape(-1))
        elif loss_name == "gsu_esu":
            p = torch.softmax(outputs["esu_logits"].to(torch.float32), dim=-1)[:, 1]
            upd["auc"] = (batch["label"].reshape(-1), p)
        elif loss_name == "multi_task":
            upd["ctr_auc"] = (batch["ctr"].reshape(-1), outputs["ctr_output"].reshape(-1))
            cvr_out = outputs.get("ctcvr_output", outputs.get("cvr_output"))
            upd["cvr_auc"] = (batch["cvr"].reshape(-1), cvr_out.reshape(-1))
        elif loss_name == "in_batch_softmax":
            if "logits" in outputs:
                hit = (outputs["logits"].argmax(dim=-1) == 0).to(torch.float32)
            else:  # the loss's logits over the global batch's items
                logits, labels = tower_logits(outputs, self._batch_mesh(batch))
                hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
            upd["accuracy"] = (hit,)
        if weight is not None:
            upd = {k: v + (weight.reshape(-1),) for k, v in upd.items()}
        return upd

    # ------------------------------------------------------------- state init
    def init_state(
        self, sample_batch: Optional[Dict[str, np.ndarray]] = None, seed: Optional[int] = None
    ) -> TrainState:
        """A fresh model (weights from ``seed``, default ``TrainConfig.seed``),
        its optimizer and a generator seeded alike. ``sample_batch`` is taken
        for the JAX call shape; the port's modules need no sample to build."""
        seed = self.config.train.seed if seed is None else seed
        mc = self.config.model
        params = dict(mc.params)
        params.setdefault("dtype", self.config.train.compute_dtype)
        model = build_model(mc.replace(params=params), self.info, self.device, seed,
                            self.mesh_ctx)
        table_opt = store = None
        if self.config.train.sparse_embedding:
            opt_name = self.config.train.optimizer.embedding_optimizer
            tables = [t.embedding.detach() for t in embedding_tables(model)]
            if opt_name == "fused_adam" and len({t.shape[0] for t in tables}) > 1:
                raise ValueError("embedding_optimizer='fused_adam' expects one shared id space")
            if opt_name == "host_adam":
                store = HostAdamStore(pin_memory=self.device.type == "cuda")
                states = [HostAdamState(store.register(tuple(t.shape))) for t in tables]
            else:
                states = [_TABLE_OPT_INIT[opt_name](t) for t in tables]
            table_opt = dict(zip(_table_names(model), states))
        return TrainState(
            step=0,
            model=model,
            optimizer=self._make_optimizer(model),
            generator=torch.Generator(device=self.device).manual_seed(seed),
            table_opt=table_opt,
            host_store=store,
        )

    def device_batch(self, batch: Dict[str, Any]) -> DeviceBatch:
        """Host → device: each column through pinned memory with a
        non-blocking copy on the card (a plain tensor on the CPU). On a mesh
        with data > 1 ``batch`` is the global batch, and this rank keeps its
        contiguous block of rows over 'data' (the whole batch, alike on
        every rank and ``replicated``, when its rows do not divide over the
        axis, as the JAX package places such a batch replicated:
        ``trainer.py:450-452``). Spans: ``feed``, with ``feed.pin`` (the
        pinned copies, on the card) and ``feed.copy`` (the copies' enqueue)."""
        with trace.span("feed"):
            m = self.mesh_ctx
            n = len(next(iter(batch.values())))
            out = DeviceBatch()
            if m.n_data > 1 and n % m.n_data == 0:
                k = n // m.n_data
                batch = {key: v[m.data_index * k : (m.data_index + 1) * k] for key, v in batch.items()}
            else:
                out.replicated = m.n_data > 1
            cols = {k: torch.as_tensor(v) for k, v in batch.items()}
            if self.device.type == "cuda":
                with trace.span("feed.pin"):
                    cols = {k: t.pin_memory() if t.device.type == "cpu" else t for k, t in cols.items()}
            with trace.span("feed.copy"):
                out.update({k: t.to(self.device, non_blocking=True) for k, t in cols.items()})
            return out

    # ------------------------------------------------------------------ steps
    def _mark(self, name: str) -> None:
        """A boundary of the step: the ``step_marks`` sink's call, the end
        of the open child span of ``step`` and the start of ``step.<name>``
        (``end`` starts none)."""
        if self.step_marks is not None:
            self.step_marks(name)
        trace.phase(None if name == "end" else f"step.{name}")

    @property
    def _id_features(self) -> List[str]:
        """Every id-valued batch column the sparse engines rewrite, the
        sampled negative series (``neg_<series>``) included."""
        seqs = list(self.info.sequence_names)
        return list(self.info.feature_names) + seqs + [f"neg_{s}" for s in seqs]

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor], metric_state
    ) -> Tuple[TrainState, Any, Dict[str, torch.Tensor]]:
        """One step of the configured engine (dense, lazy-sparse or fused),
        in the span ``step``, whose children are ``step.forward`` (the model
        and the loss), ``step.backward`` (the backward and the average over
        'data'), ``step.optimizer`` (the chain and the sparse engines' table
        update) and ``step.metrics``; the engines' parts are spans named
        ``engine.*`` where they run."""
        train = self.config.train
        with trace.span("step", ends_step=True):
            if not train.sparse_embedding:
                return self._dense_step(state, batch, metric_state)
            if train.optimizer.embedding_optimizer == "fused_adam":
                if self.mesh_ctx.n_devices > 1:
                    return self._fused_step_sharded(state, batch, metric_state)
                return self._fused_step(state, batch, metric_state)
            return self._sparse_step(state, batch, metric_state)

    def _loss(self, outputs, inputs, batch):
        """The loss of ``outputs`` on ``inputs`` (the model's batch, ids
        rewritten by a sparse engine); ``batch`` is the step's batch as
        ``device_batch`` gave it."""
        loss, logs = self.loss_fn(outputs, inputs, mesh=self._batch_mesh(batch))
        loss, aux_logs = add_auxiliary(loss, outputs)
        logs.update(aux_logs)
        return loss, logs

    def _update_params(self, state: TrainState, loss: torch.Tensor) -> None:
        self._mark("backward")
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        self._average_over_data([p.grad for p in state.model.parameters() if p.grad is not None])
        self._mark("optimizer")
        state.optimizer.step()

    def _average_over_data(self, tensors: List[torch.Tensor]) -> None:
        """Average ``tensors`` (each rank's gradients of its own loss) over
        'data', in place: the gradients of the global batch's loss, as every
        rank's batch is the same size. One all-reduce of one flat buffer."""
        m = self.mesh_ctx
        if m.n_data == 1 or not tensors:
            return
        flat = torch.cat([t.reshape(-1) for t in tensors])
        all_reduce_(flat, m.data_group).div_(m.n_data)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()

    def _finish(self, state, metric_state, loss, logs, outputs, batch):
        """The step's end: the logged loss and terms (the global batch's)
        and the metric updates. ``batch`` is the step's batch as
        ``device_batch`` gave it; the loss ``Mean`` takes every rank's loss,
        so every batch, replicated or not, weighs n_data there."""
        self._mark("metrics")
        loss = loss.detach()
        logs = {k: v.detach() for k, v in logs.items()}
        if self.mesh_ctx.n_data > 1:
            # each rank's loss and terms (the used-id L2 is global already),
            # averaged in one all-reduce: the global batch's
            local = [k for k in logs if k != "used_id_l2"]
            flat = torch.stack([loss] + [logs[k].reshape(()) for k in local])
            flat = all_reduce_(flat, self.mesh_ctx.data_group) / self.mesh_ctx.n_data
            loss = flat[0]
            logs.update(zip(local, flat[1:]))
        outputs = {k: v.detach() for k, v in outputs.items()}
        metric_state = self.metrics.update(
            metric_state, loss=(loss,), **self._metric_updates(outputs, batch)
        )
        self._mark("end")
        return dataclasses.replace(state, step=state.step + 1), metric_state, logs | {"loss": loss}

    def _dense_step(self, state, batch, metric_state):
        model = state.model.train()
        l2_coeff = self.config.model.embedding.used_id_l2
        self._mark("forward")
        with self._forward_context(model, batch, state.generator), (
            record_used_id_l2(model) if l2_coeff > 0 else contextlib.nullcontext()
        ) as reg:
            outputs = model(batch)
        loss, logs = self._loss(outputs, batch, batch)
        if reg:
            penalty = torch.stack(reg).sum()
            loss = loss + l2_coeff * penalty
            logs["used_id_l2"] = penalty
        self._update_params(state, loss)
        return self._finish(state, metric_state, loss, logs, outputs, batch)

    def _sparse_step(self, state, batch, metric_state):
        """The lazy-sparse engine (``trainer.py:471-602``): the step's unique
        ids (``unique_with_positions``; slot 0 is id 0, repeats go to the
        sacrificial last row), their rows gathered outside autograd, the
        batch's ids rewritten into slots, and a row-sparse update of each
        table with its (U, D) gradient ((U, F, D) for a field-aware table;
        the row-wise optimizers reduce over every trailing axis).

        On a mesh it is one step over the global batch, as GSPMD runs the
        JAX step: the unique ids are the global batch's (each data rank's
        block gathered over 'data', so every rank holds the same slots), a
        rank's rows come from the row-sharded take (its own rows, summed
        over 'model'), each data rank's forward and backward run on its
        block, the (U, D) gradients are averaged over 'data', and each model
        rank updates the unique rows it owns, a run of the sorted unique
        ids found with one read of two positions back to the host. The
        sacrificial row is the global ``pad_vocab(V, n_model)`` table's
        last, which the last model rank owns; the used-id L2 counts each
        row the global batch touches once (``EmbeddingTable.forward``)."""
        model = state.model.train()
        tables = embedding_tables(model)
        mesh = self.mesh_ctx
        oc = self.config.train.optimizer
        l2_coeff = self.config.model.embedding.used_id_l2
        self._mark("forward")
        present = [n for n in self._id_features if n in batch]
        gathered = mesh.n_data > 1 and not getattr(batch, "replicated", False)
        ids = [gather_rows(batch[n], mesh.data_group, mesh.data_index, mesh.n_data)
               if gathered else batch[n] for n in present]
        ids_all = torch.cat([x.reshape(-1) for x in ids])
        v_loc = tables[0].embedding.shape[0]
        pad_id = v_loc * mesh.n_model - 1  # the spare row of pad_vocab
        with trace.span("engine.unique"):
            uniq, positions = sparse_ops.unique_with_positions(ids_all, pad_id)
        with torch.no_grad(), trace.span("engine.gather"):
            rows = [row_sharded_lookup(t.embedding, uniq, mesh) if mesh.n_model > 1
                    else t.embedding.detach().index_select(0, uniq) for t in tables]
        rows = [r.requires_grad_() for r in rows]
        inputs = dict(batch)
        offset = 0
        for name, x in zip(present, ids):
            pos = positions[offset : offset + x.numel()].reshape(x.shape)
            offset += x.numel()
            k = batch[name].shape[0]
            inputs[name] = pos[mesh.data_index * k : (mesh.data_index + 1) * k] if gathered else pos
        with sparse_rows(model, rows, "unique"), self._forward_context(model, batch, state.generator), (
            record_used_id_l2(model) if l2_coeff > 0 else contextlib.nullcontext()
        ) as reg:
            outputs = model(inputs)
        loss, logs = self._loss(outputs, inputs, batch)
        if reg:
            penalty = torch.stack(reg).sum()
            loss = loss + l2_coeff * penalty
            logs["used_id_l2"] = penalty
        self._update_params(state, loss)
        step = state.step + 1
        hp = (oc.b1, oc.b2, oc.eps)
        grads = [r.grad if r.grad is not None else torch.zeros_like(r) for r in rows]
        self._average_over_data(grads)
        with trace.span("engine.update"):
            if mesh.n_model > 1:
                # the unique ids this rank owns, a run of the sorted ids
                lo = tables[0].row_offset
                a, b = torch.searchsorted(uniq, uniq.new_tensor([lo, lo + v_loc])).tolist()
                uniq, grads = uniq[a:b] - lo, [g[a:b] for g in grads]
            for name, table, g in zip(_table_names(model), tables, grads):
                opt = state.table_opt[name]
                t = table.embedding
                if isinstance(opt, HostAdamState):
                    state.host_store.update(t, opt, uniq, g, step, oc.learning_rate, *hp)
                elif isinstance(opt, sparse_ops.SparseAdagradState):
                    sparse_ops.sparse_rowwise_adagrad(t, opt, uniq, g, oc.learning_rate)
                elif isinstance(opt, sparse_ops.SparseRowAdamState):
                    sparse_ops.sparse_rowwise_adam(t, opt, uniq, g, step, oc.learning_rate, *hp)
                else:
                    sparse_ops.sparse_adam(t, opt, uniq, g, step, oc.learning_rate, *hp)
        return self._finish(state, metric_state, loss, logs, outputs, batch)

    def _identity_positions(self, batch, present):
        """``batch`` with each id column of ``present`` rewritten to its
        occurrences' positions in the concatenated stream (``_flat_ids``'
        order; a (B, L) sequence's positions transposed, so every column of
        a lookup is a contiguous run, and its validity mask shipped as
        ``__mask__<name>``)."""
        seq_cols = set(self._id_features) - set(self.info.feature_names)
        batch = dict(batch)
        offset = 0
        for name in present:
            x = batch[name]
            pos = torch.arange(offset, offset + x.numel(), device=x.device)
            if name in seq_cols and x.dim() == 2:
                batch[f"__mask__{name}"] = (x != self.info.padding_index).to(torch.float32)
                pos = pos.reshape(x.shape[1], x.shape[0]).T
            else:
                pos = pos.reshape(x.shape)
            batch[name] = pos
            offset += x.numel()
        return batch

    def _fused_step(self, state, batch, metric_state):
        """The fused engine (``trainer.py:604-980``, one device): numerically
        dense Adam on every table without a table-shaped gradient in
        autograd.

        The step's ids (sequences column-major) are sorted once
        (``make_scatter_plan``); each occurrence gets its own row
        (``rows = table[ids]``) and the batch's id columns are rewritten to
        identity positions (transposed for (B, L) sequences, whose validity
        masks ship as ``__mask__<name>``), so every lookup is a
        ``contiguous_take``. After ``backward()`` each table's per-occurrence
        gradient is permuted into id order and summed into the dense (V, D)
        gradient by kernel #9 (``fused_scatter_add``), and Adam updates every
        row; a field-aware (V, F, D) table and its moments go through both
        as (V, F·D) views. ``fused_backward``: ``'permute'`` (the default) counts the
        used-id L2 in row space with a first-occurrence mask;
        ``'sort_payload'`` moves it to table space (``G += l2·table`` on
        touched rows, an occurrence count from the kernel); ``'xla_packed'``
        builds G with an unsorted ``index_add_``, no sort. All three give the
        same numbers. ``fused_forward`` and ``fused_sort`` choose TPU gather
        and sort strategies of equal results: the port has one of each (an
        ``index_select`` per table, one stable sort)."""
        model = state.model.train()
        tables = embedding_tables(model)
        names = _table_names(model)
        oc = self.config.train.optimizer
        l2_coeff = self.config.model.embedding.used_id_l2
        self._mark("forward")
        present = [n for n in self._id_features if n in batch]
        ids_all = torch.cat([_flat_ids(batch[n]) for n in present]).to(torch.int32)
        n_ids = ids_all.shape[0]
        v_rows = tables[0].embedding.shape[0]
        plan = None
        if oc.fused_backward == "permute":
            with trace.span("engine.plan"):
                plan = eu.make_scatter_plan(ids_all, v_rows)
        with trace.span("engine.gather"):
            rows = [t.embedding.detach().index_select(0, ids_all).requires_grad_() for t in tables]
        first_orig = None
        if l2_coeff > 0 and plan is not None:
            # used-id L2 counts each id once: its first occurrence in the
            # sorted stream, mapped back to the original order
            first = torch.ones(n_ids, 1, device=ids_all.device)
            first[1:, 0] = (plan.sids[1:] != plan.sids[:-1]).to(torch.float32)
            first_orig = eu.unpermute_rows(first, plan)[:, 0]
        inputs = self._identity_positions(batch, present)
        with sparse_rows(model, rows, "direct"), self._forward_context(model, batch, state.generator):
            outputs = model(inputs)
        loss, logs = self._loss(outputs, inputs, batch)
        if first_orig is not None:
            reg = sum(
                0.5 * (first_orig * r.reshape(n_ids, -1).to(torch.float32).square().sum(-1)).sum()
                for r in rows
            )
            loss = loss + l2_coeff * reg
            logs["used_id_l2"] = reg
        self._update_params(state, loss)
        step = state.step + 1
        lr, hp = oc.learning_rate, (oc.b1, oc.b2, oc.eps)
        grads = [(r.grad if r.grad is not None else torch.zeros_like(r)).reshape(n_ids, -1)
                 for r in rows]
        t2 = [t.embedding.detach().reshape(v_rows, -1) for t in tables]
        ms = [state.table_opt[n].m.reshape(v_rows, -1) for n in names]
        vs = [state.table_opt[n].v.reshape(v_rows, -1) for n in names]
        table_l2 = l2_coeff > 0 and oc.fused_backward != "permute"
        with torch.no_grad():
            if oc.fused_backward == "xla_packed":
                with trace.span("engine.scatter"):
                    gds = [eu.packed_scatter_add(v_rows, ids_all, g) for g in grads]
                    count = eu.packed_count_rows(v_rows, ids_all) if table_l2 else None
            else:
                if plan is None:  # sort_payload sorts after the backward
                    with trace.span("engine.plan"):
                        plan = eu.make_scatter_plan(ids_all, v_rows)
                gs = [g.index_select(0, plan.order) for g in grads]
                if not table_l2:
                    eu.scatter_adam_grouped(t2, ms, vs, plan, gs, step, lr, *hp)
                    gds = []
                else:
                    with trace.span("engine.scatter"):
                        ones = torch.ones(n_ids, 1, device=ids_all.device)
                        count = eu.fused_scatter_add(v_rows, 1, plan, ones)
                        gds = [eu.fused_scatter_add(v_rows, g.shape[1], plan, g) for g in gs]
            if table_l2:
                # the rows-space term's exact gradient, each touched id once,
                # and its value, from the tables before their update
                touched = (count > 0).to(torch.float32)
                reg = sum(0.5 * (touched[:, 0] * t.square().sum(-1)).sum() for t in t2)
                gds = [gd + l2_coeff * touched * t for gd, t in zip(gds, t2)]
                loss = loss.detach() + l2_coeff * reg
                logs["used_id_l2"] = reg
            for t, m, v, gd in zip(t2, ms, vs, gds):
                with trace.span("engine.adam"):
                    eu.adam_update_(t, m, v, gd, step, lr, *hp)
        return self._finish(state, metric_state, loss, logs, outputs, batch)

    def _fused_step_sharded(self, state, batch, metric_state):
        """The fused engine on a mesh (``trainer.py:982-1230``): the tables,
        their moments, kernel #9 and Adam run on each rank's rows.

        Each rank's lookup rows come from ``row_sharded_lookup`` (its own
        rows, summed over 'model'), outside autograd; the positions, the
        forward and the backward are the one-device step's, on the rank's
        block of the batch. Each rank sorts its block's ids once and maps
        them into its row range: ids below it become -1 and ids above it
        ``V_loc``, which keeps the order sorted, and kernel #9 drops ids
        outside [0, V_loc) (``csrc/embedding_update.cu``). #9 builds the
        rank's aggregated gradient (and, with ``used_id_l2``, its occurrence
        count); both are summed over 'data', the gradient averaged. The
        used-id L2 is in table space, each touched row once (``G +=
        l2·touched·table``, its value summed over 'model'), as the JAX
        package's sharded step has it whatever ``fused_backward`` says; then
        Adam on the rank's rows (``adam_update_``). The JAX step splits the
        flat id stream over 'data' rather than the batch's rows; the sum
        over 'data' is the same up to rounding."""
        model = state.model.train()
        tables = embedding_tables(model)
        names = _table_names(model)
        mesh = self.mesh_ctx
        oc = self.config.train.optimizer
        l2_coeff = self.config.model.embedding.used_id_l2
        self._mark("forward")
        present = [n for n in self._id_features if n in batch]
        ids_all = torch.cat([_flat_ids(batch[n]) for n in present])
        n_ids = ids_all.shape[0]
        v_loc = tables[0].embedding.shape[0]
        with torch.no_grad(), trace.span("engine.gather"):
            rows = [row_sharded_lookup(t.embedding, ids_all, mesh) for t in tables]
        rows = [r.requires_grad_() for r in rows]
        inputs = self._identity_positions(batch, present)
        with sparse_rows(model, rows, "direct"), self._forward_context(model, batch, state.generator):
            outputs = model(inputs)
        loss, logs = self._loss(outputs, inputs, batch)
        self._update_params(state, loss)
        step = state.step + 1
        lr, hp = oc.learning_rate, (oc.b1, oc.b2, oc.eps)
        with torch.no_grad():
            with trace.span("engine.plan"):
                sids, order = torch.sort(ids_all.to(torch.int32), stable=True)
                lo = tables[0].row_offset
                local = torch.where(sids < lo, -1, torch.clamp_max(sids - lo, v_loc))
                plan = eu.ScatterPlan(local.to(torch.int32), order, n_ids, v_loc)
            touched = None
            if l2_coeff > 0:
                with trace.span("engine.scatter"):
                    ones = torch.ones(n_ids, 1, device=ids_all.device)
                    count = all_reduce_(eu.fused_scatter_add(v_loc, 1, plan, ones), mesh.data_group)
                touched = (count > 0).to(torch.float32)
            reg = None
            for name, t, r in zip(names, tables, rows):
                g = (r.grad if r.grad is not None else torch.zeros_like(r)).reshape(n_ids, -1)
                t2 = t.embedding.detach().reshape(v_loc, -1)
                with trace.span("engine.scatter"):
                    gd = eu.fused_scatter_add(v_loc, t2.shape[1], plan, g.index_select(0, order))
                    self._average_over_data([gd])
                if touched is not None:
                    part = 0.5 * (touched[:, 0] * t2.square().sum(-1)).sum()
                    reg = part if reg is None else reg + part
                    gd = gd + l2_coeff * touched * t2
                st = state.table_opt[name]
                with trace.span("engine.adam"):
                    eu.adam_update_(t2, st.m.reshape(v_loc, -1), st.v.reshape(v_loc, -1), gd,
                                    step, lr, *hp)
            if reg is not None:
                reg = all_reduce_(reg, mesh.model_group)
                loss = loss.detach() + l2_coeff * reg
                logs["used_id_l2"] = reg
        return self._finish(state, metric_state, loss, logs, outputs, batch)

    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor], metric_state):
        """The metric updates of one batch in eval mode, as the JAX
        package's: the loss ``Mean`` takes the batch's loss, weighted by
        its rows' ``__weight__`` sum when there is one. On a data axis an
        unweighted batch weighs n_data (every rank adds its loss, replicated
        or not); a weighted one its rows' weights, each rank's taken with
        the global batch's loss, a replicated batch's on data rank 0."""
        model = state.model.eval()
        m = self.mesh_ctx
        with torch.no_grad():
            outputs = model(batch)
            loss, _ = self.loss_fn(outputs, batch, mesh=self._batch_mesh(batch))
            loss, _ = add_auxiliary(loss, outputs)
            updates = self._metric_updates(outputs, batch)
            w = batch.get("__weight__")
            if w is None:
                updates["loss"] = (loss,)
            elif not self._counted_elsewhere(batch):
                if m.n_data > 1 and not getattr(batch, "replicated", False):
                    loss = all_reduce_(loss.clone(), m.data_group) / m.n_data
                updates["loss"] = (loss, w.sum())
            return self.metrics.update(metric_state, **updates)

    # ------------------------------------------------------------------ loops
    def _start_profile(self):
        """The operator's profiler, with the steps' spans on as its
        ``record_function`` ranges (unless a caller traces already; no sync
        counter); returns it and the spans' recording (None then)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        rec = None
        if trace.recording() is None:
            rec = trace.start(record_function=True, count_syncs=False)
        return prof, rec

    def _stop_profile(self, prof, rec) -> None:
        if rec is not None and trace.recording() is rec:
            trace.stop()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.config.train.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.train.profile_dir, "trace.json"))

    def train_epoch(
        self,
        state: TrainState,
        batches: Iterable[Dict[str, np.ndarray]],
        writer=None,
        epoch: int = 0,
        eval_hook: Optional[Callable[[TrainState], None]] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        writer = writer or NullSummaryWriter()
        metric_state = self.metrics.init()
        cfg = self.config.train
        log_every = cfg.log_every_steps
        eval_every = cfg.eval_every_steps
        prof = rec = None
        t0 = time.time()
        n = 0
        try:
            for batch in batches:
                n += 1
                if cfg.profile_dir and epoch == 0:
                    if n == cfg.profile_start_step:
                        prof, rec = self._start_profile()
                    elif prof is not None and n == cfg.profile_start_step + cfg.profile_num_steps:
                        self._stop_profile(prof, rec)
                        prof = None
                batch = self.device_batch(batch)
                state, metric_state, logs = self.train_step(state, batch, metric_state)
                if eval_hook is not None and eval_every and n % eval_every == 0:
                    eval_hook(state)
                if log_every and n % log_every == 0:
                    results = {k: float(v) for k, v in self.metrics.result(metric_state).items()}
                    for k, v in results.items():
                        writer.scalar(f"train/{k}", v, state.step)
                    rate = n * next(iter(batch.values())).shape[0] / (time.time() - t0)
                    print(
                        f"epoch {epoch} step {state.step}: "
                        + " ".join(f"{k}={v:.4f}" for k, v in results.items())
                        + f" ({rate:.0f} ex/s)"
                    )
        finally:
            if prof is not None:  # an epoch shorter than the profile window, or a step that raised
                self._stop_profile(prof, rec)
        results = {k: float(v) for k, v in self.metrics.result(metric_state).items()}
        return state, results

    def evaluate(
        self, state: TrainState, batches: Iterable[Dict[str, np.ndarray]]
    ) -> Dict[str, float]:
        metric_state = self.metrics.init()
        for batch in batches:
            metric_state = self.eval_step(state, self.device_batch(batch), metric_state)
        return {k: float(v) for k, v in self.metrics.result(metric_state).items()}

    def _selection_metric(self, eval_results: Dict[str, float]) -> float:
        """The early-stop / keep-best criterion: AUC for ranking, mean AUC for
        multi-task, −loss otherwise."""
        if "auc" in eval_results:
            return eval_results["auc"]
        aucs = [v for k, v in eval_results.items() if k.endswith("auc")]
        if aucs:
            return float(np.mean(aucs))
        return -eval_results["loss"]

    def run(
        self,
        train_data: Callable[[], Iterable[Dict[str, np.ndarray]]],
        eval_data: Callable[[], Iterable[Dict[str, np.ndarray]]],
        state: Optional[TrainState] = None,
        restore: bool = False,
    ) -> Tuple[TrainState, Dict[str, Any]]:
        """Train and evaluate each epoch, with early stopping and a checkpoint
        of every new best (``tpurec/train/trainer.py:1443-1509``)."""
        cfg = self.config.train
        if state is None:
            state = self.init_state(next(iter(train_data())))
        if restore and self.ckpt is not None and self.ckpt.latest_step() is not None:
            state = self.restore(state)
        writer = SummaryWriter(cfg.tensorboard_dir) if cfg.tensorboard_dir else NullSummaryWriter()
        stopper = EarlyStopper(
            num_trials=cfg.early_stop.num_trials,
            criterion=cfg.early_stop.criterion,
            mode=cfg.early_stop.mode,
        )
        history = []
        best_eval: Dict[str, float] = {}
        # mid-epoch eval keeps the best checkpoint at step granularity; early
        # stopping still decides on epoch-end evals
        best_mid = [-np.inf]

        def eval_hook(s: TrainState) -> None:
            res = self.evaluate(s, eval_data())
            for k, v in res.items():
                writer.scalar(f"eval/{k}", v, s.step)
            metric = self._selection_metric(res)
            if metric > best_mid[0]:
                best_mid[0] = metric
                if self.ckpt is not None:
                    self.save(s)

        hook = eval_hook if cfg.eval_every_steps > 0 else None
        for epoch in range(cfg.epochs):
            state, train_results = self.train_epoch(
                state, train_data(), writer, epoch, eval_hook=hook
            )
            eval_results = self.evaluate(state, eval_data())
            for k, v in eval_results.items():
                writer.scalar(f"eval/{k}", v, state.step)
            writer.flush()
            history.append({"epoch": epoch, "train": train_results, "eval": eval_results})
            print(f"epoch {epoch} eval: " + " ".join(f"{k}={v:.4f}" for k, v in eval_results.items()))
            metric = self._selection_metric(eval_results)
            best_mid[0] = max(best_mid[0], metric)
            cont = stopper.is_continuable(metric)
            if stopper.is_new_best:
                best_eval = eval_results
                if self.ckpt is not None:
                    self.save(state)
            if not cont:
                break
        writer.close()
        best_epoch, metric_history = stopper.check_record()
        return state, {
            "history": history,
            "best_epoch": best_epoch,
            "best_eval": best_eval,
            "metric_history": metric_history,
        }

    # ------------------------------------------------------------- ckpt/infer
    def _tables(self, model: nn.Module) -> Dict[str, EmbeddingTable]:
        return dict(zip(_table_names(model), embedding_tables(model)))

    def _state_tree(self, state: TrainState) -> Dict[str, Any]:
        """The checkpoint's tree, in one layout on every mesh: whole tables,
        whole tensor-parallel weights and their whole moments (gathered
        over 'model'; a collective, so every rank builds it)."""
        layouts = shard_layouts(state.model)
        tables = self._tables(state.model)
        model = whole_tensors(state.model, state.model.state_dict())
        optimizer = state.optimizer.state_dict()
        for i, group in enumerate(optimizer["param_groups"]):
            if group["name"] in layouts and i in optimizer["state"]:
                whole = layouts[group["name"]][0]
                optimizer["state"][i] = {
                    k: whole(v) if k in ("mu", "nu") else v
                    for k, v in optimizer["state"][i].items()
                }
        tree = {
            "step": state.step,
            "model": model,
            "optimizer": optimizer,
            "generator": state.generator.get_state(),
        }
        if state.table_opt is not None:
            tree["table_opt"] = {
                n: {f: tables[n].whole(v) if isinstance(v, torch.Tensor) else v
                    for f, v in st._asdict().items()}
                for n, st in state.table_opt.items()
            }
        return tree

    def _fit(self, model: nn.Module, saved: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``saved`` (a state dict with whole tables and weights of any mesh)
        with each table and tensor-parallel weight replaced by this rank's
        share (``shard_layouts``)."""
        layouts = shard_layouts(model)
        current = model.state_dict()
        return {
            k: layouts[k][1](current[k], v) if k in layouts else v
            for k, v in saved.items()
        }

    def _barrier(self) -> None:
        if self.mesh_ctx.n_devices > 1:
            dist.barrier()

    def _sidecar(self, step: int) -> str:
        return os.path.join(self.ckpt.directory, f"host_moments_{step}.npz")

    def save(self, state: TrainState) -> None:
        """Checkpoint ``state``. With ``host_adam`` the host moments go to a
        ``host_moments_<step>.npz`` sidecar beside the checkpoint; sidecars
        of steps the manager no longer keeps are removed (each is twice the
        size of the fp32 tables). On a mesh every rank takes part and rank
        0 writes whole tables (``_state_tree``)."""
        tree = self._state_tree(state)
        if self.mesh_ctx.rank == 0:
            self.ckpt.save(state.step, tree)
        self._barrier()
        if state.host_store is None:
            return
        state.host_store.save(self._sidecar(state.step))
        kept = set(self.ckpt.all_steps())
        for path in glob.glob(os.path.join(self.ckpt.directory, "host_moments_*.npz")):
            m = re.match(r"host_moments_(\d+)\.npz$", os.path.basename(path))
            if m and int(m.group(1)) not in kept:
                os.remove(path)

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the latest when ``step`` is None) into
        ``state_like``'s model, optimizer, table optimizer state and
        generator, in place; with ``host_adam`` the host moments come from
        the step's sidecar (a warning, and zero moments, when it is
        missing). A checkpoint moves between meshes: each table, and each
        table moment, takes this rank's rows of the saved whole table
        (``EmbeddingTable.fit``), and each tensor-parallel weight and its
        moments this rank's share."""
        tree = self.ckpt.restore(step, map_location="cpu")
        tables = self._tables(state_like.model)
        layouts = shard_layouts(state_like.model)
        current = state_like.model.state_dict()
        state_like.model.load_state_dict(self._fit(state_like.model, tree["model"]))
        optimizer = tree["optimizer"]
        for i, group in enumerate(optimizer["param_groups"]):
            name = group["name"]
            if name in layouts and i in optimizer["state"]:
                fit = layouts[name][1]
                optimizer["state"][i] = {
                    k: fit(torch.zeros_like(current[name]), v) if k in ("mu", "nu") else v
                    for k, v in optimizer["state"][i].items()
                }
        state_like.optimizer.load_state_dict(optimizer)
        state_like.generator.set_state(tree["generator"])
        restored_step = int(tree["step"])
        if state_like.table_opt is not None:
            saved = tree["table_opt"]
            if set(saved) != set(state_like.table_opt):
                raise KeyError(
                    f"checkpoint tables {sorted(saved)} != {sorted(state_like.table_opt)}"
                )
            with torch.no_grad():
                for name, st in state_like.table_opt.items():
                    for field, value in st._asdict().items():
                        if isinstance(value, torch.Tensor):
                            value.copy_(tables[name].fit(value, saved[name][field]))
                        elif value != saved[name][field]:
                            raise ValueError(f"{name}.{field}: {saved[name][field]} != {value}")
        if state_like.host_store is not None:
            sidecar = self._sidecar(restored_step)
            if os.path.exists(sidecar):
                state_like.host_store.load(sidecar)
            else:
                # zero moments at a large step inflate the first steps'
                # effective learning rate: never silently
                warnings.warn(
                    f"host_adam sidecar missing for step {restored_step} ({sidecar}); "
                    "resuming with zero moments",
                    stacklevel=2,
                )
        return dataclasses.replace(state_like, step=restored_step)

    def load_from_export(self, state: TrainState, directory: str) -> TrainState:
        """Incremental retraining: the model's weights (and running
        statistics) from a frozen export, the optimizer kept as it is."""
        exported = ckpt_lib.load_exported_params(directory, map_location=str(self.device))
        state.model.load_state_dict(self._fit(state.model, exported))
        return state

    def init_subtree_from_export(
        self, state: TrainState, directory: str, dst_prefix: str
    ) -> TrainState:
        """Graft an export's parameters into the submodule at ``dst_prefix``
        (slash-separated path), e.g. a pretrained trunk; combine with
        ``TrainConfig.freeze_prefixes`` to keep it frozen. The submodule must
        match the exported model parameter for parameter (its running
        statistics are left as they are, as the JAX package grafts params
        only)."""
        sub = state.model.get_submodule(dst_prefix.replace("/", "."))
        loaded = ckpt_lib.load_exported_raw(directory)
        params = dict(sub.named_parameters())
        buffers = dict(sub.named_buffers())
        missing = sorted(set(params) - set(loaded))
        extra = sorted(set(loaded) - set(params) - set(buffers))
        if missing or extra:
            raise KeyError(
                f"export at {directory} does not match {dst_prefix!r}: "
                f"missing {missing}, unexpected {extra}"
            )
        loaded = self._fit(sub, loaded)  # this rank's share on a mesh
        with torch.no_grad():
            for name, p in params.items():
                if loaded[name].shape != p.shape:
                    raise ValueError(
                        f"{dst_prefix}/{name}: export shape {tuple(loaded[name].shape)}, "
                        f"model shape {tuple(p.shape)}"
                    )
                p.copy_(loaded[name])
        return state

    def export(self, state: TrainState, directory: str) -> None:
        """The frozen export ``load_servable`` reads: on a mesh every rank
        takes part, and rank 0 writes whole tensor-parallel weights and
        whole tables cut to the one-device row count, ``pad_vocab(V)`` (the
        rows past it are padding)."""
        tables = self._tables(state.model)
        params = {k: v[: pad_vocab(tables[k].vocab_size)] if k in tables else v
                  for k, v in whole_tensors(state.model, state.model.state_dict()).items()}
        if self.mesh_ctx.rank == 0:
            ckpt_lib.export_params(
                directory,
                params,
                meta={
                    "model": self.config.model.name,
                    "model_params": {
                        k: v for k, v in self.config.model.params.items() if k != "dtype"
                    },
                    "embedding": self.config.model.embedding.to_dict(),
                },
            )
        self._barrier()

    def infer(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Eval-mode forward on ``batch``; outputs come back as numpy arrays
        (bf16 outputs as fp32)."""
        model = state.model.eval()
        with torch.inference_mode():
            outputs = model(self.device_batch(batch))
            m = self.mesh_ctx
            n = len(next(iter(batch.values())))
            if m.n_data > 1 and n % m.n_data == 0:
                # each data rank scored its block: the whole batch's outputs
                outputs = {
                    k: gather_rows(v.float() if v.dtype == torch.bfloat16 else v,
                                   m.data_group, m.data_index, m.n_data)
                    if v.dim() and v.shape[0] == n // m.n_data else v
                    for k, v in outputs.items()
                }
        return {
            k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in outputs.items()
        }
