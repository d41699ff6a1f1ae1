"""Early stopping with 'best'/'better' criteria and metric history (a copy
of ``tpurec/core/early_stop.py``, which imports no JAX).

Re-implements the semantics of the reference ``EarlyStopper``
(2.FM/Tools.py:56-99, 1.MatrixCF/ModelBase.py:9-32):

- criterion 'best': stop after ``num_trials`` consecutive epochs without a
  new all-time best.
- criterion 'better': stop after ``num_trials`` consecutive epochs where the
  metric failed to improve on the immediately preceding epoch.
- ``check_record`` returns (best_epoch_index, history).
"""

from __future__ import annotations

from typing import List, Tuple


class EarlyStopper:
    def __init__(self, num_trials: int = 3, criterion: str = "best", mode: str = "max"):
        if criterion not in ("best", "better"):
            raise ValueError(f"unknown criterion {criterion!r}")
        if mode not in ("max", "min"):
            raise ValueError(f"unknown mode {mode!r}")
        self.num_trials = num_trials
        self.criterion = criterion
        self.mode = mode
        self.trial_counter = 0
        self.history: List[float] = []
        self.best_metric = float("-inf") if mode == "max" else float("inf")
        self.best_epoch = -1

    def _improved(self, new: float, old: float) -> bool:
        return new > old if self.mode == "max" else new < old

    def is_continuable(self, metric: float) -> bool:
        """Record this epoch's metric; return False when patience is spent."""
        metric = float(metric)
        prev = self.history[-1] if self.history else None
        self.history.append(metric)
        is_new_best = self._improved(metric, self.best_metric)
        if is_new_best:
            self.best_metric = metric
            self.best_epoch = len(self.history) - 1
        if self.criterion == "best":
            improved = is_new_best
        else:  # 'better': compare with the previous epoch only
            improved = prev is None or self._improved(metric, prev)
        if improved:
            self.trial_counter = 0
            return True
        self.trial_counter += 1
        return self.trial_counter < self.num_trials

    @property
    def is_new_best(self) -> bool:
        return self.best_epoch == len(self.history) - 1

    def check_record(self) -> Tuple[int, List[float]]:
        return self.best_epoch, list(self.history)
