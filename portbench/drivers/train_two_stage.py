"""The training window of a two-stage long-sequence model (ETA): the window
of ``drivers/train.py`` (``Trainer.device_batch`` then ``Trainer.train_step``
on the pool's batches in turn, no synchronise between steps), for a model
trained with the configuration's own ``loss`` and holding a fixed SimHash
projection beside its parameters.

What differs from ``drivers/train.py``:
- the trainer's ``TrainConfig.loss`` is the configuration's ``loss``;
- set-up loads the seeded weights together with the projection
  (``reference.projection``, a Gaussian from the seed) into the model's
  ``hash_proj`` buffer; the reference takes the same projection as a
  constant, not as a parameter;
- the check runs three reference steps with the configuration's loss
  (``reference.loss``) and takes the readings ``train_readings`` takes;
- ``sides`` gives the readings ``calibrate.py`` prints (program, control,
  half, leaves), run by ``calibrate_two_stage.py``;
- the window's rate goes under the name of the training rate whose
  ``workloads`` in ``BENCHMARK.json`` name the cell, not necessarily
  ``train_examples_per_s.<config>``: ``eta_taobao.train_long`` reports
  ``train_examples_per_s.din_amazon``, the rate of DIN, ETA's sibling in the
  family of target attention over a behaviour series, under its 1 % bound
  (each cell is compared with itself alone);
- a traced run turns the program's tracing on while the profiler runs, with
  a CUDA event pair on each span where the program's tracing has them
  (``tpurec_torch.core.trace.start(device_events=True)``), and hands each
  span's device ms a profiled step to the metrics (``device_span_ms``): none
  where the program has no such spans.

Like ``lib/program.py`` this module imports the port (its ``Trainer`` and
its tracing).
"""

from __future__ import annotations

import inspect
from collections import defaultdict
from typing import Dict, List, Sequence

from portbench.drivers import train
from portbench.lib import check, program, traffic
from portbench.reference.common import (ROUNDINGS, adam_, device_batch, exact, make_weights, norm,
                                        plain_fp32)

CHECK_STEPS = train.CHECK_STEPS


def trainer(cfg, mix, device):
    """``program.trainer``'s ``Trainer`` with the configuration's loss."""
    from tpurec_torch.train.trainer import Trainer

    base = program.trainer(cfg, mix, device)
    config = base.config.replace(train=base.config.train.replace(loss=cfg["loss"]))
    return Trainer(config, base.info, device=device)


def readings(ref, cfg, weights, proj, batches: Sequence, device, rnd=exact,
             rows: slice = slice(None)) -> Dict[str, object]:
    """``reference.common.train_readings`` with the reference's own loss and
    its projection: each step's loss, every leaf's first gradient and its
    norm, every leaf's change norm after the last step."""
    import torch

    with plain_fp32():
        params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses: List[float] = []
        grad_norms: Dict[str, float] = {}
        first: Dict[str, object] = {}
        for step, host in enumerate(batches, 1):
            batch = device_batch(host, device, rows)
            loss = ref.loss(ref.forward(params, batch, cfg, rnd, proj), batch["label"], cfg)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if step == 1:
                grad_norms = {k: norm(g) for k, g in grads.items()}
                first = {k: g.detach() for k, g in grads.items()}
            adam_(params, grads, mu, nu, step, cfg["optimizer"])
            losses.append(float(loss.detach()))
            del grads, loss
        change = {k: norm(params[k].detach() - weights[k]) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "first_grads": first}


def start_program_tracing():
    """The program's tracing with a CUDA event pair a span, or None where
    the program's tracing takes no device events or a caller has it on
    already (``hostcost.py``)."""
    from tpurec_torch.core import trace

    takes_events = "device_events" in inspect.signature(trace.start).parameters
    if trace.recording() is not None or not takes_events:
        return None
    return trace.start(count_syncs=False, device_events=True)


class Driver(train.Driver):
    def __init__(self, cell, seed, device, tracer):
        super().__init__(cell, seed, device, tracer)
        self.recording = None
        rates = [m["name"] for m in cell.end_to_end if m["name"].startswith("train_examples_per_s.")]
        self.rate = rates[0] if rates else f"train_examples_per_s.{self.cfg['name']}"

    def end_to_end(self) -> Dict[str, float]:
        return {self.rate: next(iter(super().end_to_end().values()))}

    def _weights(self):
        return make_weights(self.reference.layout(self.cfg), self.seed, self.device)

    def _projection(self):
        return self.reference.projection(self.cfg, self.seed, self.device)

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        self.pool = traffic.make_pool(self.cfg, self.mix, self.seed)
        self.stats = [traffic.batch_stats(self.cfg, b) for b in self.pool]
        self.trainer = trainer(self.cfg, self.mix, self.device)
        self.state = self.trainer.init_state(seed=self.seed % 2**31)
        weights = self._weights()
        self.state.model.load_state_dict(dict(weights, hash_proj=self._projection()))
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

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> None:
        """``train.Driver.window``, the program's tracing on exactly while the
        profiler runs."""
        tracer = self.tracer
        start, stop = tracer.start_profile, tracer.stop_profile

        def start_both():
            start()
            self.recording = start_program_tracing()

        def stop_both():
            if self.recording is not None:
                from tpurec_torch.core import trace

                trace.stop()
            stop()

        tracer.start_profile, tracer.stop_profile = start_both, stop_both
        try:
            super().window(seconds)
        finally:
            tracer.start_profile, tracer.stop_profile = start, stop

    def device_span_ms(self) -> Dict[str, float]:
        """Each program span's device ms, totalled over the profiled steps
        and divided by them (after the window's synchronise)."""
        steps = len(self.profiled)
        if self.recording is None or not steps:
            return {}
        total: Dict[str, float] = defaultdict(float)
        for s in self.recording.spans:
            ms = getattr(s, "device_ms", None)
            if ms is not None:
                total[s.name] += ms
        return {name: ms / steps for name, ms in total.items()}

    def layer_context(self):
        return dict(super().layer_context(), device_span_ms=self.device_span_ms())

    # ----------------------------------------------------------------- check
    def _reference(self, rnd=exact, rows: slice = slice(None)):
        return readings(self.reference, self.cfg, self._weights(), self._projection(),
                        self.pool[:CHECK_STEPS], self.device, rnd, rows)

    def check(self, limits: Dict[str, float]):
        """The program's readings against three plain fp32 steps with the
        configuration's loss, from the same weights and projection on the
        same batches; returns (numbers, failed)."""
        return check.train_numbers(self.readings, self._reference()), 0

    def sides(self, names: Sequence[str]) -> Dict[str, object]:
        """What ``calibrate.train_sides`` gives for this driver's cells: each
        side's numbers against the fp32 reference (``program``: this run's
        set-up; ``control``: the reference in fp8 where the program computes
        in bf16; ``half``: the reference on half of each batch; ``leaves``:
        each leaf's norms, program against reference)."""
        from portbench import calibrate

        if "program" in names or "leaves" in names:
            self.setup()
            prog = self.readings
            self.release()
            calibrate.empty_cache(self.device)
        else:
            self.pool = traffic.make_pool(self.cfg, self.mix, self.seed)
        ref = self._reference()
        out = {}
        if "program" in names:
            out["program"] = check.train_numbers(prog, ref)
        if "leaves" in names:
            out["leaves"] = calibrate.leaf_table(prog, ref) | {"losses": [prog["losses"], ref["losses"]]}
        if "control" in names:
            out["control"] = check.train_numbers(self._reference(ROUNDINGS["fp8"]), ref)
        if "half" in names:
            rows = slice(0, int(self.mix["batch"]) // 2)
            out["half"] = check.train_numbers(self._reference(rows=rows), ref)
        return out
