"""Spans of the port's LM path (docs/observability_torch.md).

``with span(name):`` records the block as a complete ``"X"`` event of the
process-current recorder on the calling thread's track, category ``lm``.
The stream path's sites capture ``recorder.current()`` once at
construction; an LM step is built before tracing starts (a benchmark builds
it in set-up and traces later calls), so ``span()`` looks the recorder up at
each call instead: one module attribute load and an ``is None`` check.  With
no recorder active it returns the shared :data:`NO_SPAN`, which reads no
clock and asks nothing of the profiler.

While ``torch.profiler`` also records, a span opens a ``record_function`` of
its name over the same interval: the span is then a user annotation in the
device trace, on the profiler's clock and on the thread whose launches it
covers, so a device activity can be credited to the span open at its
launching call.  A span never reads a device value or synchronises: it times
the host's enqueue.
"""

from __future__ import annotations

import time

import torch

from repro_torch.observability import recorder


class _NoSpan:
    """The span of no active recorder: records nothing, reads no clock."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()


class _Span:
    """A span of an active recorder, mirrored into the profiler while it
    records."""

    __slots__ = ("rec", "name", "t0", "mirror")

    def __init__(self, rec: recorder.TraceRecorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> "_Span":
        self.mirror = None
        if torch._C._autograd._profiler_enabled():
            self.mirror = torch.autograd.profiler.record_function(self.name)
            self.mirror.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dur = time.perf_counter_ns() - self.t0
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        buf = self.rec._buf()
        buf.append(("X", buf.thread_name, self.name, "lm", self.t0, dur, None))


def span(name: str):
    """A span of the recorder active at this call, or :data:`NO_SPAN`."""
    rec = recorder._CURRENT
    if rec is None:
        return NO_SPAN
    return _Span(rec, name)
