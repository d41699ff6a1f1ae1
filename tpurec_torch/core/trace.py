"""Spans and counters inside the port's training path, for measurement.

Tracing is off by default. ``start()`` turns it on and returns the
``Recording`` its spans go to, kept in memory for whoever turned it on;
``stop()`` turns it off and returns the same recording. The port writes no
file of its own. While tracing is off, ``span(name)`` returns one shared
no-op context and ``phase(name)`` returns at once: one flag test each, no
clock read, no allocation.

While it is on:

- ``with span(name):`` records a ``Span``: its name, its parent (the
  enclosing span, None at the top), the step index (``Recording.step``; a
  span opened with ``ends_step=True`` advances it when it closes, so one
  step's spans share it) and its host start and end in ``time.time_ns()``,
  the clock the torch profiler's ``baseTimeNanoseconds`` counts in.
- ``phase(name)`` ends the phase open inside the innermost span, if any, and
  opens ``name`` in its place (``None`` opens none); the enclosing span's
  end ends its last phase. The training step's children between its marks
  are phases (``Trainer._mark``).
- Host syncs (unless ``start(count_syncs=False)``): torch's CUDA sync
  debug mode is ``"warn"``; each warning it gives is counted against the
  innermost open span (``Span.syncs``; ``Recording.loose_syncs`` outside
  every span) and swallowed.
- With ``start(record_function=True)`` each span is also a
  ``torch.profiler.record_function`` range, so a running profiler's trace
  shows it under the same name.
- With ``start(device_events=True)`` on a CUDA machine each span also
  records a CUDA event on the current stream when it opens and another when
  it closes; after a synchronise ``Span.device_ms`` is the device time
  between them (None without the events).

The kernel wrappers' ``.launches`` stay the launch counts of the
hand-written kernels; a profiler's trace counts every launch.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import List, Optional

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"


class Span:
    """One timed range; the context manager that opens and closes it."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns", "syncs", "_rec", "_phase",
                 "_ends_step", "_rf", "_events")

    def __init__(self, rec: "Recording", name: str, phase: bool = False, ends_step: bool = False):
        self.name = name
        self.parent: Optional[Span] = None
        self.step = 0
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self.syncs = 0
        self._rec, self._phase, self._ends_step, self._rf = rec, phase, ends_step, None
        self._events = None

    def __enter__(self) -> "Span":
        self._rec._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._rec._close(self)
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        """The device time from the span's open to its close, read after a
        synchronise; None without device events."""
        if self._events is None:
            return None
        return self._events[0].elapsed_time(self._events[1])


class Recording:
    """The spans and sync counts of one stretch of tracing, in the order the
    spans opened."""

    def __init__(self, record_function: bool = False, device_events: bool = False):
        self.spans: List[Span] = []
        self.step = 0
        self.loose_syncs = 0
        self.record_function = record_function
        self.device_events = device_events
        self._stack: List[Span] = []
        self._debug_mode = None
        self._warnings = None

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def _open(self, s: Span) -> None:
        s.parent = self._stack[-1] if self._stack else None
        s.step = self.step
        if self.record_function:
            s._rf = torch.autograd.profiler.record_function(s.name)
            s._rf.__enter__()
        self.spans.append(s)
        self._stack.append(s)
        if self.device_events:
            s._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            s._events[0].record()
        s.start_ns = time.time_ns()

    def _close(self, s: Span) -> None:
        t = time.time_ns()
        if s.end_ns is not None or s not in self._stack:
            return
        while True:  # the phases left open inside s end with it
            top = self._stack.pop()
            top.end_ns = t
            if top._events is not None:
                top._events[1].record()
            if top._rf is not None:
                top._rf.__exit__(None, None, None)
            if top is s:
                break
        if s._ends_step:
            self.step += 1

    def phase(self, name: Optional[str]) -> None:
        if self._stack and self._stack[-1]._phase:
            self._close(self._stack[-1])
        if name is not None:
            self._open(Span(self, name, phase=True))

    def _count_sync(self) -> None:
        if self._stack:
            self._stack[-1].syncs += 1
        else:
            self.loose_syncs += 1


_REC: Optional[Recording] = None
_OFF = contextlib.nullcontext()


def span(name: str, ends_step: bool = False):
    """A span named ``name`` while tracing is on; the shared no-op context
    while it is off."""
    rec = _REC
    if rec is None:
        return _OFF
    return Span(rec, name, ends_step=ends_step)


def phase(name: Optional[str]) -> None:
    """End the open phase of the innermost span and open ``name`` (None:
    none) while tracing is on."""
    if _REC is not None:
        _REC.phase(name)


def recording() -> Optional[Recording]:
    """The recording while tracing is on, else None."""
    return _REC


def start(record_function: bool = False, count_syncs: bool = True,
          device_events: bool = False) -> Recording:
    """Turn tracing on; raises if it is on already. ``count_syncs=False``
    leaves torch's sync debug mode and the warnings alone;
    ``device_events=True`` times each span on the device too, where there is
    a CUDA device."""
    global _REC
    if _REC is not None:
        raise RuntimeError("tracing is on already")
    rec = Recording(record_function, device_events and torch.cuda.is_available())
    if count_syncs:
        _count_syncs(rec)
    _REC = rec
    return rec


def _count_syncs(rec: Recording) -> None:
    rec._warnings = warnings.catch_warnings()
    rec._warnings.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_WARNING):
            rec._count_sync()
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    if torch.cuda.is_available():
        rec._debug_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")


def stop() -> Recording:
    """Turn tracing off; the spans still open end now. Returns the
    recording."""
    global _REC
    rec, _REC = _REC, None
    if rec is None:
        raise RuntimeError("tracing is off")
    if rec._stack:
        rec._close(rec._stack[0])
    if rec._debug_mode is not None:
        torch.cuda.set_sync_debug_mode(rec._debug_mode)
    if rec._warnings is not None:
        rec._warnings.__exit__(None, None, None)
    return rec
