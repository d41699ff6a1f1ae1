"""The readers of the program's spans beside a profiled trace, on a synthetic
``Profile`` and hand-made spans."""

from types import SimpleNamespace

import pytest

from portbench.lib import readers, spans
from portbench.lib.trace import Profile


class FakeSpan:
    def __init__(self, name, start_ns, end_ns, step=0, parent=None, syncs=0):
        self.name, self.start_ns, self.end_ns, self.step = name, start_ns, end_ns, step
        self.parent, self.syncs = parent, syncs


def one_step(k, t0_ns, syncs=0):
    """A step's spans from ``t0_ns``: feed 0-2 ms (pin 0-1.5), step 2-10 ms
    (forward 2-5, backward 5-8 with engine.gather 6-7, optimizer 8-10)."""
    ms = 1_000_000
    feed = FakeSpan("feed", t0_ns, t0_ns + 2 * ms, k)
    step = FakeSpan("step", t0_ns + 2 * ms, t0_ns + 10 * ms, k)
    backward = FakeSpan("step.backward", t0_ns + 5 * ms, t0_ns + 8 * ms, k, step, syncs)
    return [feed, FakeSpan("feed.pin", t0_ns, t0_ns + 1.5 * ms, k, feed), step,
            FakeSpan("step.forward", t0_ns + 2 * ms, t0_ns + 5 * ms, k, step), backward,
            FakeSpan("engine.gather", t0_ns + 6 * ms, t0_ns + 7 * ms, k, backward),
            FakeSpan("step.optimizer", t0_ns + 8 * ms, t0_ns + 10 * ms, k, step)]


BASE = 1_000_000_000  # the trace's baseTimeNanoseconds


def kernel(ts, dur, name="k", correlation=None):
    e = {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur, "name": name}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


def test_the_spans_go_onto_the_traces_timeline_with_their_depth():
    got = spans.on_timeline(one_step(0, BASE + 5000), BASE)
    assert got[0] == (5.0, 2005.0, "feed", 0)
    assert ("engine.gather", 2) in [(s[2], s[3]) for s in got]
    assert [s[0] for s in got] == sorted(s[0] for s in got)


def test_gap_labels_are_the_benchmark_span_then_the_innermost_program_span():
    program = spans.SpanIndex(spans.on_timeline(one_step(0, BASE), BASE))
    # the benchmark's host spans wrap the program's calls
    prof = Profile([kernel(0, 100), kernel(1000, 300), kernel(5600, 900), kernel(6600, 200),
                    kernel(9000, 200), kernel(11000, 100), kernel(11500, 10)],
                   [(0, 2000, "feed"), (2000, 10000, "step"), (10000, 11400, "readback")])
    got = {round(d * 1e6): label for label, d in spans.top_gaps(prof, program)}
    assert got == {
        900: "feed/feed.pin",           # 100-1000 us: in the pinning
        4300: "step/step.forward",      # 1300-5600: most of it in the forward
        100: "step/engine.gather",      # 6500-6600: inside the gather, in the backward
        2200: "step/step.backward",     # 6800-9000: most in the backward, outside the gather
        1800: "readback",               # 9200-11000: most outside every program span
        400: "readback",                # 11100-11500
    }
    by_label = spans.idle_by_label(prof, program)
    assert by_label["readback"] == pytest.approx(2200e-6)
    assert sum(by_label.values()) == pytest.approx(sum(b - a for a, b in prof.busy_and_gaps()[1]) * 1e-6)


def test_without_program_spans_the_labels_are_the_benchmarks():
    prof = Profile([kernel(0, 100), kernel(1000, 300)], [(0, 2000, "feed")])
    assert spans.top_gaps(prof, spans.SpanIndex([])) == prof.breakdown()["idle_gaps"]


def test_runtime_calls_put_each_launch_down_to_its_span():
    program = spans.SpanIndex(spans.on_timeline(one_step(0, BASE), BASE))
    runtime = [{"ph": "X", "cat": "cuda_runtime", "ts": ts, "dur": 5, "name": "cudaLaunchKernel",
                "args": {"correlation": c}} for c, ts in [(1, 500), (2, 3000), (3, 6500), (5, 12000)]]
    runtime.append({"ph": "X", "cat": "cuda_driver", "ts": 6900, "dur": 5, "name": "cuLaunchKernel",
                    "args": {"correlation": 4}})
    device = [kernel(20000 + c, 1, correlation=c) for c in (1, 2, 3, 4, 5, 99)]
    device.append({"ph": "X", "cat": "gpu_memcpy", "ts": 30000, "dur": 1, "name": "Memcpy",
                   "args": {"correlation": 2}})
    got = spans.launches_by_span(runtime + device, program)
    assert got == {"feed.pin": 1, "step.forward": 2, "engine.gather": 2, spans.OUTSIDE: 1,
                   spans.UNLAUNCHED: 1}
    assert spans.launches_by_span(device, program) is None  # no runtime calls in the trace


def test_host_issue_time_is_the_median_of_the_post_window_steps():
    ms = 1_000_000
    recorded = []
    for k, length in enumerate([30, 30, 9, 11, 10, 50]):  # the window's steps, then three synced
        steps = one_step(k, BASE + 100 * k * ms)
        steps[2].end_ns = steps[0].start_ns + length * ms
        recorded += steps
    assert spans.host_issue_ms(recorded, [2, 3, 4]) == pytest.approx(10.0)
    assert spans.host_issue_ms(recorded, [9]) is None
    assert spans.span_ms(recorded, "feed.pin", [0, 1]) == pytest.approx(1.5)


def test_syncs_a_step_count_the_feed_and_the_step():
    recorded = one_step(0, BASE, syncs=2) + one_step(1, BASE + 10**8, syncs=1)
    recorded.append(FakeSpan("elsewhere", BASE + 10**9, BASE + 10**9 + 5, 1, syncs=7))
    assert spans.syncs_per_step(recorded, [0, 1]) == pytest.approx(1.5)
    assert spans.syncs_per_step(recorded, []) is None


def test_launches_per_step_and_the_existing_readers_read_a_trace_unchanged():
    events = [kernel(0, 100), kernel(150, 50), {"ph": "X", "cat": "gpu_memset", "ts": 300, "dur": 10,
                                                 "name": "Memset"},
              {"ph": "X", "cat": "cuda_runtime", "ts": 1, "dur": 2, "name": "cudaLaunchKernel",
               "args": {"correlation": 1}}]
    prof = Profile(events, [(0, 400, "step")])
    ctx = {"tracer": SimpleNamespace(profile=prof), "profiled_stats": [{}, {}]}
    assert spans.launches_per_step(ctx) == pytest.approx(1.5)  # no feed copies: all over the steps
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 160 / 310))
    assert [[label, round(s * 1e6, 6)] for label, s in prof.breakdown()["idle_gaps"]] == [
        ["step", 100.0], ["step", 50.0]]
    assert spans.launches_per_step({"tracer": SimpleNamespace(profile=None), "profiled_stats": []}) is None


def copy(ts):
    return {"ph": "X", "cat": "gpu_memcpy", "ts": ts, "dur": 1, "name": spans.FEED_COPY}


@pytest.mark.parametrize("queued", [0, 1, 4, 9])
def test_launches_per_step_leave_out_what_was_queued_before_the_profile(queued):
    # queued: the tail of earlier steps (a feed's copies among them), then
    # four profiled steps of two feed copies and three kernels, the second
    # with a kernel the trace lost
    prefix = ([kernel(0, 1), copy(0), copy(0), kernel(0, 1), kernel(0, 1)] * 2)[-queued:] if queued else []
    steps = [[copy(0), copy(0), kernel(0, 1), kernel(0, 1), kernel(0, 1)] for _ in range(4)]
    del steps[1][-1]
    events = [dict(e, ts=t) for t, e in enumerate(prefix + sum(steps, []))]
    ctx = {"tracer": SimpleNamespace(profile=Profile(events)), "profiled_stats": [{}] * 4}
    assert spans.launches_per_step(ctx) == 5.0


@pytest.mark.parametrize("workload", ["din_amazon.train", "deepfm_criteo.train_dense"])
def test_the_host_cost_tool_reads_a_tiny_cell_on_the_cpu(workload):
    import torch

    from portbench import hostcost
    from portbench.tests import tiny

    out = hostcost.measure(tiny.cell(workload), 2147483659, 0.2, 1, 3, torch.device("cpu"))
    assert len(out["rate_off"]) == len(out["rate_on"]) == 1
    assert out["window"]["host_syncs_per_step"] == 0 and out["window"]["loose_syncs"] == 0
    synced = out["synced"]
    assert synced["pairs"] == 3 and synced["host_syncs_per_step"] == 0
    assert 0 < synced["host_issue_ms"] <= synced["issue_ms_on"] <= synced["wall_ms"]
    assert 0 < synced["issue_ms_off"] <= synced["wall_ms_off"]
    assert {"feed", "feed.copy", "step", "step.forward", "step.backward", "step.optimizer",
            "step.metrics"} <= set(synced["span_ms"])
