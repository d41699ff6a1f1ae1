"""Training runtime (counterpart of ``tpurec/train/trainer.py``): the dense
embedding engine on one device.

One ``Trainer`` builds a registry model, trains it (forward, backward, the
optimizer chain, the streaming metric update), evaluates, keeps checkpoints,
stops early, exports for serving and infers, for every model the port has,
selected by config. The JAX package's names and call shapes are kept:
``train_step(state, batch, metric_state) -> (state, metric_state, logs)``.

- PyTorch runs eagerly: a step is a sequence of launches on the current
  stream, and nothing in it waits for the device (the loss and metrics stay
  on the device until a caller reads them).
- The model and the optimizer are updated in place; the ``TrainState`` a step
  returns holds the same objects with the step count advanced.
- Dense compute runs in ``TrainConfig.compute_dtype`` (bf16 by default);
  parameters, optimizer state, the DIN attention and the loss stay fp32.
- The train step runs the model in training mode and eval and inference in
  eval mode; ops whose kernel the JAX package launches at inference only
  (the FM cross term) read that mode where the JAX package reads its
  training-phase flag (``trainer.py:1271``).
- The lazy-sparse and fused embedding engines and meshes of more than one
  device are not ported yet (ROADMAP slices 3 and 7); asking for them raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tpurec_torch.config import ExperimentConfig, OptimizerConfig
from tpurec_torch.core.early_stop import EarlyStopper
from tpurec_torch.core.metrics import AUC, Mean, MetricBundle
from tpurec_torch.core.summary import NullSummaryWriter, SummaryWriter
from tpurec_torch.data.schema import DataInfo
from tpurec_torch.device import DeviceLike, resolve_device
from tpurec_torch.embedding.modules import record_used_id_l2
from tpurec_torch.models import build_model
from tpurec_torch.train import checkpoint as ckpt_lib
from tpurec_torch.train.losses import add_auxiliary, get_loss

# table optimizers of the lazy-sparse and fused engines (ROADMAP slice 3)
_SPARSE_ENGINES = ("fused_adam", "rowwise_adagrad", "rowwise_adam", "host_adam")


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: "ChainOptimizer"
    generator: torch.Generator  # for stochastic layers (dropout, sampling)


def resolve_embedding_engine(config: ExperimentConfig, info: DataInfo) -> ExperimentConfig:
    """``embedding_optimizer='auto'`` resolves to the dense engine, as in the
    JAX package (``trainer.py:105-123``, a rule from TPU measurements; its
    H100 form is ROADMAP slice 3)."""
    oc = config.train.optimizer
    if oc.embedding_optimizer != "auto":
        return config
    train = config.train.replace(
        sparse_embedding=False, optimizer=oc.replace(embedding_optimizer="adam")
    )
    return config.replace(train=train)


def _refuse_unported(config: ExperimentConfig) -> None:
    train = config.train
    if train.sparse_embedding or train.optimizer.embedding_optimizer in _SPARSE_ENGINES:
        raise NotImplementedError(
            "the port trains with the dense embedding engine only: sparse_embedding="
            f"{train.sparse_embedding}, embedding_optimizer="
            f"{train.optimizer.embedding_optimizer!r} are ROADMAP slice 3"
        )
    if config.mesh.model != 1 or config.mesh.data not in (-1, 1):
        raise NotImplementedError(
            f"the port trains on one device; mesh {config.mesh} is ROADMAP slice 7"
        )


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
    State per parameter: ``mu``, ``nu`` (Adam moments); ``count`` (updates
    applied) is kept in every group. The learning rate is computed on the
    host from ``count``, so a step never waits for the device."""

    def __init__(
        self,
        named_params: List[Tuple[str, nn.Parameter]],
        config: OptimizerConfig,
        decay: Dict[str, float],
        row_decay: Dict[str, torch.Tensor],
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
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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
    ``device="cpu"``; asking for ``cuda`` where there is none raises."""

    def __init__(self, config: ExperimentConfig, info: DataInfo, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.info = info
        config = resolve_embedding_engine(config, info)
        _refuse_unported(config)
        self.config = config
        self.loss_fn = get_loss(config.train.loss)
        self.metrics = self._make_metrics()
        self.ckpt = (
            ckpt_lib.CheckpointManager(config.train.checkpoint_dir, config.train.max_to_keep)
            if config.train.checkpoint_dir
            else None
        )
        # for measurement only: a hook called with a phase name ("forward",
        # "backward", "optimizer", "metrics", "end") at each boundary of
        # train_step, so a profiling script can record CUDA events between
        # them (chip_smoke.py's step breakdown); training leaves it None
        self.step_marks: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------------ setup
    def _make_optimizer(self, model: nn.Module) -> ChainOptimizer:
        oc = self.config.train.optimizer
        prefixes = tuple(self.config.train.freeze_prefixes)

        def frozen(name: str) -> bool:
            path = name.replace(".", "/")
            return any(path == p or path.startswith(p + "/") for p in prefixes)

        named = [(n, p) for n, p in model.named_parameters() if not frozen(n)]
        decay: Dict[str, float] = {}
        row_decay: Dict[str, torch.Tensor] = {}
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
                    rows = np.zeros((p.shape[0],), np.float32)
                    m = min(p.shape[0], lam.shape[0])
                    rows[:m] = lam[:m]
                    shape = (p.shape[0],) + (1,) * (p.dim() - 1)
                    row_decay[n] = torch.as_tensor(rows, device=p.device).reshape(shape)
        return ChainOptimizer(named, oc, decay, row_decay)

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
        return MetricBundle(metrics, device=self.device)

    def _metric_updates(self, outputs, batch) -> Dict[str, tuple]:
        loss_name = self.config.train.loss
        upd: Dict[str, tuple] = {}
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
            else:
                u = outputs["user_embedding"].to(torch.float32)
                v = outputs["item_embedding"].to(torch.float32)
                logits = u @ v.T
                arange = torch.arange(logits.shape[0], device=logits.device)
                hit = (logits.argmax(dim=-1) == arange).to(torch.float32)
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
        model = build_model(mc.replace(params=params), self.info, self.device, seed)
        return TrainState(
            step=0,
            model=model,
            optimizer=self._make_optimizer(model),
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host → device: each column through pinned memory with a
        non-blocking copy on the card (a plain tensor on the CPU)."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            out[k] = t
        return out

    # ------------------------------------------------------------------ steps
    def _mark(self, name: str) -> None:
        if self.step_marks is not None:
            self.step_marks(name)

    def train_step(
        self, state: TrainState, batch: Dict[str, torch.Tensor], metric_state
    ) -> Tuple[TrainState, Any, Dict[str, torch.Tensor]]:
        model = state.model.train()
        l2_coeff = self.config.model.embedding.used_id_l2
        self._mark("forward")
        with record_used_id_l2(model) if l2_coeff > 0 else contextlib.nullcontext() as reg:
            outputs = model(batch)
        loss, logs = self.loss_fn(outputs, batch)
        loss, aux_logs = add_auxiliary(loss, outputs)
        logs.update(aux_logs)
        if reg:
            penalty = torch.stack(reg).sum()
            loss = loss + l2_coeff * penalty
            logs["used_id_l2"] = penalty
        self._mark("backward")
        model.zero_grad(set_to_none=True)
        loss.backward()
        self._mark("optimizer")
        state.optimizer.step()
        self._mark("metrics")
        loss = loss.detach()
        outputs = {k: v.detach() for k, v in outputs.items()}
        metric_state = self.metrics.update(
            metric_state, loss=(loss,), **self._metric_updates(outputs, batch)
        )
        self._mark("end")
        logs = {k: v.detach() for k, v in logs.items()}
        return dataclasses.replace(state, step=state.step + 1), metric_state, logs | {"loss": loss}

    def eval_step(self, state: TrainState, batch: Dict[str, torch.Tensor], metric_state):
        model = state.model.eval()
        with torch.no_grad():
            outputs = model(batch)
            loss, _ = self.loss_fn(outputs, batch)
            loss, _ = add_auxiliary(loss, outputs)
            w = batch.get("__weight__")
            loss_args = (loss,) if w is None else (loss, w.sum())
            return self.metrics.update(
                metric_state, loss=loss_args, **self._metric_updates(outputs, batch)
            )

    # ------------------------------------------------------------------ loops
    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def _stop_profile(self, prof) -> None:
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
        prof = None
        t0 = time.time()
        n = 0
        for batch in batches:
            n += 1
            if cfg.profile_dir and epoch == 0:
                if n == cfg.profile_start_step:
                    prof = self._profiler()
                    prof.__enter__()
                elif prof is not None and n == cfg.profile_start_step + cfg.profile_num_steps:
                    self._stop_profile(prof)
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
        if prof is not None:  # epoch shorter than the profile window
            self._stop_profile(prof)
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
    @staticmethod
    def _state_tree(state: TrainState) -> Dict[str, Any]:
        return {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
        }

    def save(self, state: TrainState) -> None:
        self.ckpt.save(state.step, self._state_tree(state))

    def restore(self, state_like: TrainState, step: Optional[int] = None) -> TrainState:
        """Load a checkpoint (the latest when ``step`` is None) into
        ``state_like``'s model, optimizer and generator, in place."""
        tree = self.ckpt.restore(step, map_location="cpu")
        state_like.model.load_state_dict(tree["model"])
        state_like.optimizer.load_state_dict(tree["optimizer"])
        state_like.generator.set_state(tree["generator"])
        return dataclasses.replace(state_like, step=int(tree["step"]))

    def load_from_export(self, state: TrainState, directory: str) -> TrainState:
        """Incremental retraining: the model's weights (and running
        statistics) from a frozen export, the optimizer kept as it is."""
        state.model.load_state_dict(
            ckpt_lib.load_exported_params(directory, map_location=str(self.device))
        )
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
        ckpt_lib.export_params(
            directory,
            state.model.state_dict(),
            meta={
                "model": self.config.model.name,
                "model_params": {
                    k: v for k, v in self.config.model.params.items() if k != "dtype"
                },
                "embedding": self.config.model.embedding.to_dict(),
            },
        )

    def infer(self, state: TrainState, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Eval-mode forward on ``batch``; outputs come back as numpy arrays
        (bf16 outputs as fp32)."""
        model = state.model.eval()
        with torch.inference_mode():
            outputs = model(self.device_batch(batch))
        return {
            k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in outputs.items()
        }
