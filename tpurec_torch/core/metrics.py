"""Streaming metrics (counterpart of ``tpurec/core/metrics.py``).

The same bucketed-histogram AUC and weighted mean, with the state a plain
dict of tensors that lives on the training device: an update is a few
device ops and never waits for the device; only ``result`` is read back
(``float(...)``) where the caller logs it. Updates are functional, as in the
JAX package: they return a new state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tpurec_torch.core.collectives import all_reduce_

State = Dict[str, torch.Tensor]


class AUC:
    """Streaming ROC-AUC via per-bucket positive/negative histograms
    (``num_buckets`` buckets over [0, 1], trapezoidal interpolation).
    Predictions must be probabilities in [0, 1]."""

    def __init__(self, num_buckets: int = 2048, dtype: torch.dtype = torch.float32):
        self.num_buckets = int(num_buckets)
        self.dtype = dtype

    def init(self, device=None) -> State:
        z = torch.zeros(self.num_buckets, dtype=self.dtype, device=device)
        return {"pos": z, "neg": z.clone()}

    def update(
        self,
        state: State,
        y_true: torch.Tensor,
        y_pred: torch.Tensor,
        weight: Optional[torch.Tensor] = None,
    ) -> State:
        y_true = y_true.reshape(-1).to(self.dtype)
        y_pred = y_pred.reshape(-1).to(self.dtype)
        w = torch.ones_like(y_pred) if weight is None else weight.reshape(-1).to(self.dtype)
        # the histogram update of tpurec/core/metrics.py:54-58; the cast to
        # int32 truncates toward zero, as jnp's astype does
        b = (y_pred * self.num_buckets).to(torch.int32).clamp(0, self.num_buckets - 1)
        pos = state["pos"].index_add(0, b, w * y_true)
        neg = state["neg"].index_add(0, b, w * (1.0 - y_true))
        return {"pos": pos, "neg": neg}

    def merge(self, a: State, b: State) -> State:
        return {"pos": a["pos"] + b["pos"], "neg": a["neg"] + b["neg"]}

    def result(self, state: State) -> torch.Tensor:
        # tp[k] / fp[k]: #pos / #neg predicted above bucket boundary k
        pos, neg = state["pos"], state["neg"]
        total_pos = pos.sum()
        total_neg = neg.sum()
        zero = pos.new_zeros(1)
        rev_tp = torch.cat([pos.flip(0).cumsum(0).flip(0), zero])
        rev_fp = torch.cat([neg.flip(0).cumsum(0).flip(0), zero])
        tpr = rev_tp / total_pos.clamp_min(1.0)
        fpr = rev_fp / total_neg.clamp_min(1.0)
        auc = ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) * 0.5).sum()
        valid = (total_pos > 0) & (total_neg > 0)
        return torch.where(valid, auc, 0.0)


class Mean:
    """Streaming weighted mean (Keras ``Mean`` equivalent)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.dtype = dtype

    def init(self, device=None) -> State:
        return {
            "total": torch.zeros((), dtype=self.dtype, device=device),
            "count": torch.zeros((), dtype=self.dtype, device=device),
        }

    def update(
        self, state: State, value: torch.Tensor, weight: Optional[torch.Tensor] = None
    ) -> State:
        value = torch.as_tensor(value, dtype=self.dtype).reshape(-1)
        w = torch.ones_like(value) if weight is None else torch.as_tensor(
            weight, dtype=self.dtype
        ).reshape(-1)
        return {
            "total": state["total"] + (value * w).sum(),
            "count": state["count"] + w.sum(),
        }

    def merge(self, a: State, b: State) -> State:
        return {"total": a["total"] + b["total"], "count": a["count"] + b["count"]}

    def result(self, state: State) -> torch.Tensor:
        return state["total"] / state["count"].clamp_min(1.0)


class MetricBundle:
    """Named collection of metrics with one state dict, kept on ``device``.

    ``bundle.update(state, auc=(y, p), loss=(value,))`` — each metric gets its
    update args as a tuple keyed by metric name. On a mesh, ``group`` is the
    'data' axis's: each rank updates its states with its own rows, and
    ``result`` sums the states over the axis first (every state is a sum),
    so the result is the global batch's.
    """

    def __init__(self, metrics: Mapping[str, object], device=None, group=None):
        self.metrics = dict(metrics)
        self.device = device
        self.group = group

    def init(self) -> Dict[str, State]:
        return {k: m.init(self.device) for k, m in self.metrics.items()}

    def update(self, state: Dict[str, State], **updates) -> Dict[str, State]:
        out = dict(state)
        for name, args in updates.items():
            out[name] = self.metrics[name].update(state[name], *args)
        return out

    def result(self, state: Dict[str, State]) -> Dict[str, torch.Tensor]:
        if self.group is not None:
            state = {
                k: {n: all_reduce_(t.clone(), self.group) for n, t in s.items()}
                for k, s in state.items()
            }
        return {k: m.result(state[k]) for k, m in self.metrics.items()}


def exact_auc(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Exact (non-streaming) ROC-AUC via the rank statistic; host-side, the
    oracle for the streaming AUC."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    order = np.argsort(y_pred, kind="mergesort")
    sorted_pred = y_pred[order]
    sorted_true = y_true[order]
    # average ranks over ties
    n = len(y_pred)
    ranks = np.empty(n, dtype=np.float64)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sorted_pred[j + 1] == sorted_pred[i]:
            j += 1
        ranks[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    n_pos = sorted_true.sum()
    n_neg = n - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    return float((ranks[sorted_true == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
