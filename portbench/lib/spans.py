"""Readings of the program's own spans (``tpurec_torch/core/trace.py``) beside
a profiled trace: each idle gap put down to the program span the host was in,
each device operation to the span whose runtime call launched it, and the
host's time to issue a step.

The program's spans come as (start, end, name, depth) in microseconds on the
trace's timeline (``on_timeline``). Nothing here imports the program.
"""

from __future__ import annotations

import bisect
import statistics
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float, str, int]


def on_timeline(spans, base_ns: int) -> List[Interval]:
    """The program's spans (``Recording.spans``) as (start, end, name,
    depth) in us from the trace's ``baseTimeNanoseconds``, by start (a
    parent before a child that starts with it)."""
    out = []
    for s in spans:
        depth, p = 0, s.parent
        while p is not None:
            depth, p = depth + 1, p.parent
        out.append(((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3, s.name, depth))
    return sorted(out, key=lambda s: (s[0], s[3]))


def _overlap(a: Sequence[float], b: Sequence[float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


class SpanIndex:
    """The program's spans by depth, each depth's in order of start (spans
    of one depth do not overlap), for lookups by interval."""

    def __init__(self, spans: Sequence[Interval]):
        self.levels: List[List[Interval]] = []
        for s in sorted(spans):
            while len(self.levels) <= s[3]:
                self.levels.append([])
            self.levels[s[3]].append(s)
        self.starts = [[s[0] for s in level] for level in self.levels]

    def _overlapping(self, depth: int, a: float, b: float) -> List[Interval]:
        # the spans that start before b, back to the first that ends by a
        # (their ends are in order too)
        level = self.levels[depth]
        i = bisect.bisect_left(self.starts[depth], b) - 1
        out = []
        while i >= 0 and level[i][1] > a:
            out.append(level[i])
            i -= 1
        return out

    def innermost(self, gap: Tuple[float, float]) -> Optional[str]:
        """The program span that holds most of the interval: from the top,
        down into the span that overlaps it most, as long as that span holds
        more of it than its parent's part outside every child (at the top:
        the part outside every span); None where no span holds the most."""
        best: Optional[Interval] = None
        held = gap[1] - gap[0]
        for depth in range(len(self.levels)):
            inside = [s for s in self._overlapping(depth, *gap)
                      if best is None or (best[0] <= s[0] and s[1] <= best[1])]
            if not inside:
                break
            parts = [_overlap(s, gap) for s in inside]
            most = max(range(len(inside)), key=parts.__getitem__)
            if parts[most] <= held - sum(parts):
                break
            best, held = inside[most], parts[most]
        return None if best is None else best[2]


def gap_label(bench_label: str, index: SpanIndex, gap: Tuple[float, float]) -> str:
    """``<benchmark span>/<innermost program span>``, or the benchmark span
    alone where no program span overlaps the gap."""
    name = index.innermost(gap)
    return bench_label if name is None else f"{bench_label}/{name}"


def idle_by_label(profile, index: SpanIndex) -> Dict[str, float]:
    """Every idle gap of the profile (``portbench.lib.trace.Profile``), its
    seconds totalled by ``gap_label``."""
    out: Dict[str, float] = Counter()
    for gap in profile.busy_and_gaps()[1]:
        out[gap_label(profile.label(gap), index, gap)] += (gap[1] - gap[0]) * 1e-6
    return dict(out)


def top_gaps(profile, index: SpanIndex, top: int = 10) -> List[list]:
    """The longest gaps as ``breakdown.idle_gaps`` gives them, their labels
    composed with the program's spans."""
    gaps = sorted(profile.busy_and_gaps()[1], key=lambda g: g[0] - g[1])[:top]
    return [[gap_label(profile.label(g), index, g), (g[1] - g[0]) * 1e-6] for g in gaps]


OUTSIDE = "(no program span)"
UNLAUNCHED = "(no launch call in the trace)"
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def launches_by_span(events: Iterable[dict], index: SpanIndex) -> Optional[Dict[str, int]]:
    """Device operations (kernels, copies, fills) of a Chrome trace, each
    counted against the innermost program span that holds the start of the
    runtime or driver call that launched it (the events' ``correlation``):
    ``OUTSIDE`` for calls outside every span, ``UNLAUNCHED`` for operations
    whose call the trace does not hold; ``None`` when the trace holds no
    such calls."""
    from portbench.lib.trace import DEVICE_CATEGORIES

    events = [e for e in events if e.get("ph") == "X"]
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    if not calls:
        return None
    out: Dict[str, int] = Counter()
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts = calls.get(e.get("args", {}).get("correlation"))
        if ts is None:
            out[UNLAUNCHED] += 1
        else:
            out[index.innermost((ts, ts + 1e-3)) or OUTSIDE] += 1
    return dict(out)


def host_issue_ms(spans, steps: Sequence[int]) -> Optional[float]:
    """The median over ``steps`` (step indices) of the host's time from the
    start of the step's ``feed`` span to the end of its ``step`` span, in
    ms."""
    feed = {s.step: s.start_ns for s in spans if s.name == "feed" and s.parent is None}
    step = {s.step: s.end_ns for s in spans if s.name == "step" and s.parent is None}
    times = [(step[k] - feed[k]) * 1e-6 for k in steps if k in feed and k in step]
    return statistics.median(times) if times else None


def span_ms(spans, name: str, steps: Sequence[int]) -> Optional[float]:
    """The mean over ``steps`` of the total time of the spans ``name`` in
    each step, in ms."""
    want = set(steps)
    total = sum(s.end_ns - s.start_ns for s in spans if s.name == name and s.step in want)
    return total * 1e-6 / len(want) if want else None


def syncs_per_step(spans, steps: Sequence[int]) -> Optional[float]:
    """Host syncs counted in the ``feed`` and ``step`` spans and their
    children over ``steps``, divided by the steps."""
    want = set(steps)
    if not want:
        return None
    total = 0
    for s in spans:
        root = s
        while root.parent is not None:
            root = root.parent
        if s.step in want and root.name in ("feed", "step"):
            total += s.syncs
    return total / len(want)


FEED_COPY = "Memcpy HtoD (Pinned -> Device)"


def launches_per_step(ctx) -> Optional[float]:
    """The median over the profiled steps of the device operations (kernels,
    copies, fills) from a step's start on the device to the next step's.
    A step starts there with its feed's copies from pinned memory, one run
    of ``FEED_COPY`` a step; the last profiled step ends with the trace.
    So operations launched before the profiler started, should the trace
    hold any, fall before the first profiled step, and a step whose
    operations the trace partly lost does not move the median. A trace
    with no such copies: all its operations over the steps."""
    prof = ctx["tracer"].profile
    n = len(ctx["profiled_stats"])
    if prof is None or not n or not prof.device:
        return None
    ops = [name for _, _, name in prof.device]
    starts = [i for i, name in enumerate(ops)
              if name == FEED_COPY and (i == 0 or ops[i - 1] != FEED_COPY)][-n:]
    if not starts:
        return len(ops) / n
    ends = starts[1:] + [len(ops)]
    return float(statistics.median(b - a for a, b in zip(starts, ends)))
