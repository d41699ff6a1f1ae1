"""What the host spends on a cell's training step, by the program's own spans
(``tpurec_torch/core/trace.py``), on the machine it starts on:

    python3 portbench/hostcost.py --workload din_amazon.train --seed 2147483001 --seconds 10

Set-up is ``run.py``'s (the cell's driver, its weights and traffic from the
seed, the profiler warmed). Then, in turn:

- ``--pairs`` pairs of the driver's windows of ``--seconds`` with the
  program's tracing off and on, the benchmark's spans and the profiler off:
  the rate each reads (``rate_off``, ``rate_on``), the cost of tracing when
  on where the card paces the step;
- the traced window as ``run.py --trace 1`` runs it, with the program's spans
  on: the idle gaps labelled ``<benchmark span>/<program span>`` (the ten
  longest, and every gap's seconds totalled by label), the device operations
  a step put down to the span whose runtime call launched each (None when
  the trace holds no runtime calls) beside ``step.launches``' reading,
  ``feed.pin`` and ``feed.copy`` and the host syncs a step over the window's
  steps, and the wall time a step of the window against the profiled steps'
  (their device span, and their host spans from the first feed to the last
  step's end);
- ``--synced`` pairs of steps on the pool's batches, each step after a
  synchronise, so that each starts on an empty launch queue, the two of a
  pair on one batch with the program's tracing off and on, in turns: the
  host's time to issue a step (the median from the feed's call to the
  step's return, by the host clock, off and on; with tracing on also from
  ``feed``'s start to ``step``'s end by the spans), each span's median, the
  synced step's wall time and the steps at whose return the card was still
  busy (so the host did not wait for it), against the card's busy time a
  step in the profiled steps.

It prints one JSON line; it checks nothing against the reference.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import check, spans, spec  # noqa: E402
from portbench.lib.trace import Profile, Tracer  # noqa: E402


class KeepingTracer(Tracer):
    """The benchmark's tracer, keeping also the profiled trace's raw events,
    its base time and the program's step index at the profile's start."""

    def start_profile(self) -> None:
        from tpurec_torch.core import trace

        rec = trace.recording()
        self.first_step = rec.step if rec is not None else None
        super().start_profile()
        export = self._prof.export_chrome_trace

        def keep(path):  # the base stop_profile's export, read here too
            export(path)
            with open(path) as f:
                data = json.load(f)
            self.base_ns = data.get("baseTimeNanoseconds")
            self.events = data.get("traceEvents", [])

        self._prof.export_chrome_trace = keep


def _window(driver, seconds: float) -> float:
    """A window of the driver's own loop on the batches after the last
    window's; its rate."""
    driver.steps, driver.window_batches = 0, []
    driver.window(seconds)
    driver.next += driver.steps
    return next(iter(driver.end_to_end().values()))


def _synced(driver, device, pairs: int):
    """``pairs`` pairs of the driver's steps on the batches after the last
    window's, each step after a synchronise, the two of a pair on one batch,
    one with the program's tracing off and one with it on, which goes first
    taking turns: each step's host time from its feed to its return and its
    wall time to the next synchronise (ms), off and on; the recordings of
    the steps with tracing on; the steps at whose return the card was still
    busy (so the host did not wait for it)."""
    import torch

    from tpurec_torch.core import trace

    issue, wall = {False: [], True: []}, {False: [], True: []}
    recs, behind = [], 0
    for j in range(2 * pairs):
        on = (j % 2 == 1) != (j // 2 % 2 == 1)
        check.sync(device)
        if on:
            recs.append(trace.start())
        try:
            t0 = time.perf_counter()
            driver._step(driver.next + j // 2)
            issue[on].append((time.perf_counter() - t0) * 1e3)
        finally:
            if on:
                trace.stop()
        behind += device.type == "cuda" and not torch.cuda.current_stream(device).query()
        check.sync(device)
        wall[on].append((time.perf_counter() - t0) * 1e3)
    return issue, wall, recs, behind


def _median_or_none(xs):
    return statistics.median(xs) if xs else None


def measure(cell: spec.Cell, seed: int, seconds: float, pairs: int, synced: int, device) -> dict:
    from tpurec_torch.core import trace

    tracer = KeepingTracer(True)
    driver = spec.load_module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, tracer)
    driver.setup()
    tracer.warm()
    out = {"workload": cell.name, "seed": seed}

    driver.tracer = Tracer(False)
    rate_off, rate_on = [], []
    for _ in range(pairs):
        rate_off.append(_window(driver, seconds))
        trace.start()
        try:
            rate_on.append(_window(driver, seconds))
        finally:
            trace.stop()
    out.update(rate_off=rate_off, rate_on=rate_on)
    if rate_off:
        out["tracing_on_cost"] = 1.0 - statistics.median(rate_on) / statistics.median(rate_off)

    # the traced window, as run.py --trace 1 runs it, the program's spans on
    driver.tracer = tracer
    rec = trace.start()
    try:
        _window(driver, seconds)
    finally:
        trace.stop()
    window_steps = sorted({s.step for s in rec.spans if s.name == "step"})
    prof, k = tracer.profile, len(driver.profiled)
    out["window"] = {
        "steps": driver.steps, "seconds": driver.window_s,
        "examples_per_s": next(iter(driver.end_to_end().values())),
        "step_wall_ms": 1e3 * driver.window_s / driver.steps,
        "feed.pin_ms": spans.span_ms(rec.spans, "feed.pin", window_steps),
        "feed.copy_ms": spans.span_ms(rec.spans, "feed.copy", window_steps),
        "host_syncs_per_step": spans.syncs_per_step(rec.spans, window_steps),
        "loose_syncs": rec.loose_syncs,
    }
    if prof is not None and k and tracer.base_ns is not None:
        index = spans.SpanIndex(spans.on_timeline(rec.spans, tracer.base_ns))
        first = tracer.first_step
        profiled = [s for s in rec.spans if s.parent is None and first <= s.step < first + k]
        start, end = prof.span_us()
        busy, _ = prof.busy_and_gaps()
        by_span = spans.launches_by_span(tracer.events, index)
        idle = spans.idle_by_label(prof, index)
        out["profiled"] = {
            "steps": k,
            "device_span_ms_per_step": (end - start) * 1e-3 / k,
            "device_busy_ms_per_step": busy * 1e-3 / k,
            "host_ms_per_step":
                (max(s.end_ns for s in profiled) - min(s.start_ns for s in profiled)) * 1e-6 / k,
            "idle_share": 1.0 - busy / (end - start) if end > start else None,
            "operations_per_step": len(prof.device) / k,
            "launches_per_step": spans.launches_per_step(driver.layer_context()),
            "launches_per_step_by_span": None if by_span is None else {
                n: c / k for n, c in sorted(by_span.items(), key=lambda kv: -kv[1])},
            "idle_ms_per_step_by_label": {
                n: 1e3 * s / k for n, s in sorted(idle.items(), key=lambda kv: -kv[1])},
            "idle_gaps": spans.top_gaps(prof, index),
            "launch_calls": {c: sum(1 for e in tracer.events if e.get("cat") == c)
                             for c in spans.LAUNCH_CATEGORIES},
        }

    # steps from an empty launch queue: the host's own cost of a step, with
    # the program's tracing off and on, in turns
    driver.tracer = Tracer(False)
    issue, wall, recs, behind = _synced(driver, device, synced)
    names = sorted({s.name for rec in recs for s in rec.spans})
    out["synced"] = {
        "pairs": len(recs),
        "issue_ms_off": _median_or_none(issue[False]),
        "issue_ms_on": _median_or_none(issue[True]),
        "host_issue_ms": _median_or_none([spans.host_issue_ms(rec.spans, [0]) for rec in recs]),
        "wall_ms_off": _median_or_none(wall[False]),
        "wall_ms": _median_or_none(wall[True]),
        "span_ms": {n: _median_or_none([sum(s.ms for s in rec.spans if s.name == n) for rec in recs])
                    for n in names},
        "host_syncs_per_step": sum(spans.syncs_per_step(rec.spans, [0]) for rec in recs) / len(recs)
        if recs else None,
        "card_busy_at_issue_end": behind,
    }
    driver.release()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--synced", type=int, default=10)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "portbench" / "cuda_cache"))
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("hostcost: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = measure(cell, args.seed, args.seconds, args.pairs, args.synced, device)
    out["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
