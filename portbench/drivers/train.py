"""The training window: ``Trainer.device_batch`` then ``Trainer.train_step``
on the pool's batches in turn, the loop body of ``Trainer.train_epoch``
without logging or evaluation, and no synchronise between steps.

Set-up builds one trainer and one state, loads the benchmark's weights into
the model, runs the first ``CHECK_STEPS`` steps through the same feed and
call on the pool's first batches (their readings are the program's side of
the check), a few more to warm up, and hands that state to the window. The
window ends with a synchronise after its last step; its rate
(``train_examples_per_s.<config>``) is every example of every step over the
window's seconds.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from portbench.lib import check, program, spec, traffic

CHECK_STEPS = 3


class Driver:
    def __init__(self, cell: spec.Cell, seed: int, device, tracer):
        self.seed, self.device, self.tracer = seed, device, tracer
        self.cfg, self.mix = cell.config, cell.traffic
        self.reference = spec.load_module("reference", self.cfg["reference"])
        self.work = spec.load_module("work", self.cfg["work"])
        self.readings: Dict[str, Any] = {}
        self.steps = 0
        self.window_s = 0.0
        self.window_batches: List[int] = []
        self.profiled: List[int] = []

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from portbench.reference.common import make_weights

        self.pool = traffic.make_pool(self.cfg, self.mix, self.seed)
        self.stats = [traffic.batch_stats(self.cfg, b) for b in self.pool]
        self.trainer = program.trainer(self.cfg, self.mix, self.device)
        self.state = self.trainer.init_state(seed=self.seed % 2**31)
        weights = make_weights(self.reference.layout(self.cfg), self.seed, self.device)
        self.state.model.load_state_dict(weights)
        self.metric_state = self.trainer.metrics.init()
        losses = [self._step(0)["loss"]]
        first_grads = self._first_grads()
        grad_norms = {n: check.norm(g) for n, g in first_grads.items()}
        losses += [self._step(i)["loss"] for i in range(1, CHECK_STEPS)]
        self.readings = {
            "losses": [float(x) for x in losses],
            "grad_norms": grad_norms,
            "first_grads": {n: g.cpu() for n, g in first_grads.items()},
            "change_norms": {
                n: check.norm(p.detach() - weights[n]) for n, p in self.state.model.named_parameters()
            },
        }
        del weights
        for i in range(CHECK_STEPS, CHECK_STEPS + int(self.mix.get("warmup_steps", 0))):
            self._step(i)
        self.next = CHECK_STEPS + int(self.mix.get("warmup_steps", 0))
        check.sync(self.device)

    def _first_grads(self):
        """Each leaf's first gradient as the optimizer got it, from its state
        after one step (Adam's first moment is (1 - b1) g); zeros for a leaf
        with no state."""
        import torch

        b1 = self.cfg["optimizer"]["b1"]
        out = {}
        for name, p in self.state.model.named_parameters():
            st = self.state.optimizer.state.get(p, {})
            out[name] = st["mu"] / (1.0 - b1) if "mu" in st else torch.zeros_like(p)
        return out

    def _step(self, i: int):
        batch = self.pool[i % len(self.pool)]
        with self.tracer.span("feed"):
            dbatch = self.trainer.device_batch(batch)
        with self.tracer.span("step"):
            self.state, self.metric_state, logs = self.trainer.train_step(
                self.state, dbatch, self.metric_state)
        return logs

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> None:
        tracer = self.tracer
        self.trainer.step_marks = tracer.step_marks()
        k = int(self.mix.get("profile_steps", 20))
        t0 = time.perf_counter()
        profile_at = t0 + 0.4 * seconds if tracer.enabled else float("inf")
        deadline = t0 + seconds
        first = None
        # a traced window closes no earlier than its profiled steps' end,
        # which on a slow host can come after the deadline
        pending = tracer.enabled
        while time.perf_counter() < deadline or pending:
            if first is None and time.perf_counter() >= profile_at:
                tracer.start_profile()
                first = self.steps
            i = self.next + self.steps
            self._step(i)
            self.window_batches.append(i % len(self.pool))
            self.steps += 1
            if first is not None and self.steps - first == k:
                tracer.stop_profile()
                self.profiled = self.window_batches[first:]
                profile_at = float("inf")
                pending = False
        check.sync(self.device)
        self.window_s = time.perf_counter() - t0
        self.trainer.step_marks = None

    def end_to_end(self) -> Dict[str, float]:
        rows = sum(self.stats[i]["rows"] for i in self.window_batches)
        return {f"train_examples_per_s.{self.cfg['name']}": rows / self.window_s}

    def layer_context(self) -> Dict[str, Any]:
        return {
            "cfg": self.cfg, "work": self.work, "window_s": self.window_s,
            "window_stats": [self.stats[i] for i in self.window_batches],
            "profiled_stats": [self.stats[i] for i in self.profiled],
            "tracer": self.tracer,
        }

    def attempted(self) -> int:
        return self.steps

    # ----------------------------------------------------------------- check
    def release(self) -> None:
        self.trainer = self.state = self.metric_state = None

    def check(self, limits: Dict[str, float]):
        """The program's readings against three plain fp32 steps from the
        same weights on the same batches; returns (numbers, failed)."""
        from portbench.reference.common import make_weights, train_readings

        weights = make_weights(self.reference.layout(self.cfg), self.seed, self.device)
        ref = train_readings(self.reference.forward, self.cfg, weights, self.pool[:CHECK_STEPS],
                             self.device)
        numbers = check.train_numbers(self.readings, ref)
        return numbers, 0
