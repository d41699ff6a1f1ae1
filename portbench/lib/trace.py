"""What a traced run records, and its reduction to numbers.

- Host spans: the benchmark's own spans around its calls into the program
  (``feed``, ``step``, ``readback``; the rest of the loop is ``loop``),
  timed by the host clock over the whole window, and while the profiler
  runs also by the system clock, which the trace's own timeline counts
  from (its ``baseTimeNanoseconds``).
- Step marks: CUDA events at the program's ``Trainer.step_marks``, each
  span between two marks totalled over the window's steps.
- A profiled sub-window of a few dozen steps or calls (``torch.profiler``,
  CUDA activity only, so that the profiler adds no work to each operator on
  the host), exported as a Chrome trace into the run's
  temporary directory, read and deleted. Its device intervals (kernels,
  copies, fills) give the busy time as their union on the trace's own
  timeline, the idle gaps between them, and each kernel's time by name.

An untraced run gets a ``Tracer(False)``: every span is a no-op.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Profile:
    """The reduction of one exported trace: device intervals and host spans
    in microseconds on the trace's timeline."""

    def __init__(self, events: List[dict], host: List[Tuple[float, float, str]] = ()):
        self.device: List[Tuple[float, float, str]] = []
        self.host: List[Tuple[float, float, str]] = sorted(host)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat", "")
            if cat in DEVICE_CATEGORIES:
                self.device.append((start, end, e.get("name", "")))
        self.device.sort()

    def span_us(self) -> Tuple[float, float]:
        """From the first device operation's start to the last one's end."""
        if not self.device:
            return 0.0, 0.0
        return self.device[0][0], max(end for _, end, _ in self.device)

    def busy_and_gaps(self) -> Tuple[float, List[Tuple[float, float]]]:
        """The union of the device intervals (us) and the gaps inside it."""
        busy, gaps = 0.0, []
        cur_start = cur_end = None
        for start, end, _ in self.device:
            if cur_end is None:
                cur_start, cur_end = start, end
            elif start > cur_end:
                busy += cur_end - cur_start
                gaps.append((cur_end, start))
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        if cur_end is not None:
            busy += cur_end - cur_start
        return busy, gaps

    def kernel_us(self, names) -> Tuple[float, int]:
        """Total device time and count of the kernels whose name contains
        one of ``names`` as a function name."""
        total, count = 0.0, 0
        for start, end, name in self.device:
            if any(_names_function(name, n) for n in names):
                total += end - start
                count += 1
        return total, count

    def label(self, gap: Tuple[float, float]) -> str:
        """The host span that overlaps the gap most, else ``loop``."""
        best, label = 0.0, "loop"
        for start, end, name in self.host:
            if start >= gap[1]:
                break
            overlap = min(end, gap[1]) - max(start, gap[0])
            if overlap > best:
                best, label = overlap, name
        return label

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_name: Dict[str, float] = defaultdict(float)
        for start, end, name in self.device:
            by_name[name[:120]] += (end - start) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        _, gaps = self.busy_and_gaps()
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[self.label(g), (g[1] - g[0]) * 1e-6] for g in longest],
        }


def _names_function(kernel: str, fn: str) -> bool:
    """Whether ``fn`` appears in the kernel's name as a whole identifier."""
    at = kernel.find(fn)
    while at >= 0:
        before = kernel[at - 1] if at > 0 else " "
        after = kernel[at + len(fn)] if at + len(fn) < len(kernel) else "("
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        at = kernel.find(fn, at + 1)
    return False


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.marks: List[Dict[str, object]] = []  # one dict of CUDA events per step
        self.profile: Optional[Profile] = None
        self._prof = None
        self._host_ns: List[Tuple[int, int, str]] = []  # spans while profiling

    @contextlib.contextmanager
    def _timed(self, name: str):
        t, ns = time.perf_counter(), time.time_ns()
        yield
        self.spans[name].append(time.perf_counter() - t)
        if self._prof is not None:
            self._host_ns.append((ns, time.time_ns(), name))

    def span(self, name: str):
        return self._timed(name) if self.enabled else contextlib.nullcontext()

    def step_marks(self):
        """A ``Trainer.step_marks`` hook recording a CUDA event at each mark
        of the step (None when untraced)."""
        import torch

        if not self.enabled or not torch.cuda.is_available():
            return None

        def mark(name: str) -> None:
            if name == "forward":
                self.marks.append({})
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][name] = ev

        return mark

    def mark_ms(self, first: str, last: str) -> List[float]:
        """Each step's span from mark ``first`` to mark ``last`` (after a
        synchronise)."""
        return [m[first].elapsed_time(m[last]) for m in self.marks if first in m and last in m]

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracing, which took seconds of a traced
        window on the chip."""
        self.start_profile()
        self.stop_profile()
        self.profile = None

    def start_profile(self) -> None:
        import torch

        # no synchronise here: the host stays ahead of the device as in the
        # rest of the window, and the span starts at the first operation the
        # profiler records (one launched after this point)
        if torch.cuda.is_available():
            acts = [torch.profiler.ProfilerActivity.CUDA]
        else:
            acts = [torch.profiler.ProfilerActivity.CPU]
        self._host_ns = []
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop_profile(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        base = data.get("baseTimeNanoseconds")
        host = [] if base is None else [((a - base) / 1e3, (b - base) / 1e3, n) for a, b, n in self._host_ns]
        self.profile = Profile(data.get("traceEvents", []), host)
