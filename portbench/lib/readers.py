"""What the per-layer metric files share. Each metric is a file
``portbench/metrics/<name>.py`` whose ``read(ctx)`` returns the number, or
None where the run has nothing to read (the harness then leaves the metric
out of the line). ``ctx`` is the driver's ``layer_context()``."""

from __future__ import annotations

from typing import Optional, Sequence

from portbench.lib import peaks, spec


def span_ms(ctx, name: str) -> Optional[float]:
    """The mean of the host span ``name`` over the window's calls, in ms."""
    spans = ctx["tracer"].spans.get(name)
    return 1e3 * sum(spans) / len(spans) if spans else None


def mark_ms(ctx, first: str, last: str) -> Optional[float]:
    """The device span from step mark ``first`` to ``last``, totalled over the
    window's steps and divided by them, in ms."""
    spans = ctx["tracer"].mark_ms(first, last)
    return sum(spans) / len(spans) if spans else None


def roofline(ctx, work: str, kernels: Sequence[str]) -> Optional[float]:
    """The least time of the operation's work on the profiled batches over
    the device time of the kernels that do it there, in %."""
    prof = ctx["tracer"].profile
    if prof is None or not ctx["profiled_stats"]:
        return None
    us, count = prof.kernel_us(kernels)
    if count == 0:
        return None
    least = spec.load_module("work", work).least_s
    return 100.0 * sum(least(ctx["cfg"], st) for st in ctx["profiled_stats"]) / (us * 1e-6)


def mfu(ctx) -> Optional[float]:
    """The model's FLOPs over the window, per second, as a share of the bf16
    peak, in %."""
    stats = ctx["window_stats"]
    if not stats or ctx["window_s"] <= 0:
        return None
    flops = sum(ctx["work"].flops(ctx["cfg"], st) for st in stats)
    return 100.0 * flops / ctx["window_s"] / peaks.BF16_FLOPS


def idle_share(ctx) -> Optional[float]:
    """The share of the profiled span in which no kernel, copy or fill ran,
    in %."""
    prof = ctx["tracer"].profile
    if prof is None:
        return None
    start, end = prof.span_us()
    if end <= start:
        return None
    busy, _ = prof.busy_and_gaps()
    return 100.0 * (1.0 - busy / (end - start))
