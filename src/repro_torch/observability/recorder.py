"""streamtrace — the low-overhead span/counter recorder.

One recorder is the single source of truth for *where time went* in a run:
every execution layer (scheduler actor firings, host-fused region
evaluations, PLink launch phases, device lanes, serve-session lifecycle)
records into the same event stream, which exports to Chrome-trace JSON
(``repro_torch.observability.chrome``), folds into metrics, or replays as a
``NetworkProfile`` for the profile-guided DSE
(``core.profiler.profile_from_trace``).

Design constraints (see docs/observability.md):

  * **near-zero cost when disabled** — instrumentation sites capture the
    recorder once (``current()``) and guard every emission with a plain
    ``is not None`` check; no recorder, no work beyond the timing the
    runtime already did for its profiles.
  * **low overhead when enabled** — each thread appends into its own
    *ring buffer* (a preallocated list; no lock on the hot path after the
    first event), timestamps are ``perf_counter_ns`` deltas the call sites
    already measured, and event payloads are plain tuples.
  * **explicit drop accounting** — a full ring overwrites the oldest
    events and counts every overwrite; exports surface the per-thread drop
    counts instead of silently truncating the story.

Event model (one tuple per event)::

    (kind, track, name, cat, ts_ns, dur_ns, args)

``kind`` is ``"X"`` (complete span), ``"i"`` (instant), or ``"C"``
(counter; ``args`` carries the value).  ``track`` names the horizontal
lane the event renders on — one per scheduler thread, PLink lane, or
serve session — and becomes a Chrome ``tid`` with a ``thread_name``
metadata record.

Copy of ``repro/observability/recorder.py``.  Edit: the clock anchor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, str, str, str, int, int, Optional[dict]]

DEFAULT_CAPACITY = 1 << 16  # events per thread buffer


class _ThreadBuffer:
    """One thread's event ring: preallocated slots, head index, drop count."""

    __slots__ = ("events", "capacity", "head", "dropped", "thread_name")

    def __init__(self, capacity: int, thread_name: str):
        self.capacity = capacity
        self.events: List[Optional[Event]] = [None] * capacity
        self.head = 0  # total events ever appended
        self.dropped = 0
        self.thread_name = thread_name

    def append(self, ev: Event) -> None:
        i = self.head
        if i >= self.capacity:
            self.dropped += 1
        self.events[i % self.capacity] = ev
        self.head = i + 1

    def drain(self) -> List[Event]:
        """Events still resident, oldest first."""
        n = min(self.head, self.capacity)
        if self.head <= self.capacity:
            return [e for e in self.events[:n] if e is not None]
        cut = self.head % self.capacity
        return [
            e for e in self.events[cut:] + self.events[:cut] if e is not None
        ]


class TraceRecorder:
    """Collects spans/instants/counters from every thread of a run.

    Timestamps are ``time.perf_counter_ns()`` values; the recorder's
    ``t0_ns`` (taken at construction) anchors the trace so exports render
    relative time.  ``clock_anchor`` is a ``(perf_counter_ns, time_ns)``
    pair read back to back at construction: ``ts - pc + unix`` puts an
    event on the Unix clock of ``torch.profiler``'s device trace.  All
    recording methods are safe from any thread.
    """

    def __init__(self, capacity_per_thread: int = DEFAULT_CAPACITY):
        self.t0_ns = time.perf_counter_ns()
        self.clock_anchor = (self.t0_ns, time.time_ns())
        self.capacity_per_thread = max(64, int(capacity_per_thread))
        self._local = threading.local()
        self._buffers: List[_ThreadBuffer] = []
        self._reg_lock = threading.Lock()
        self.meta: Dict[str, object] = {}  # free-form run metadata

    # -- hot path -----------------------------------------------------------
    def _buf(self) -> _ThreadBuffer:
        buf = getattr(self._local, "buf", None)
        if buf is None:
            buf = _ThreadBuffer(
                self.capacity_per_thread, threading.current_thread().name
            )
            self._local.buf = buf
            with self._reg_lock:
                self._buffers.append(buf)
        return buf

    def complete(
        self,
        track: str,
        name: str,
        cat: str,
        t0_ns: int,
        dur_ns: int,
        args: Optional[dict] = None,
    ) -> None:
        """Record a finished span: the caller already measured
        ``t0_ns``/``dur_ns`` with ``perf_counter_ns`` (the runtime times its
        firings anyway — tracing adds the append, not the clock reads)."""
        self._buf().append(("X", track, name, cat, t0_ns, dur_ns, args))

    def instant(
        self, track: str, name: str, cat: str, args: Optional[dict] = None
    ) -> None:
        self._buf().append(
            ("i", track, name, cat, time.perf_counter_ns(), 0, args)
        )

    def counter(
        self,
        track: str,
        name: str,
        value,
        cat: str = "counter",
        args: Optional[dict] = None,
    ) -> None:
        """Record a named scalar sample (Chrome renders these as stacked
        counter tracks).  ``args`` may carry structured identity on top of
        the value — e.g. the authored channel endpoints for token totals."""
        payload = dict(args or ())
        payload["value"] = value
        self._buf().append(
            ("C", track, name, cat, time.perf_counter_ns(), 0, payload)
        )

    # -- export side --------------------------------------------------------
    def events(self) -> List[Event]:
        """Every resident event, merged across threads, time-sorted."""
        with self._reg_lock:
            bufs = list(self._buffers)
        out: List[Event] = []
        for b in bufs:
            out.extend(b.drain())
        out.sort(key=lambda e: e[4])
        return out

    def drops(self) -> Dict[str, int]:
        """Per-thread dropped-event counts (empty means nothing dropped)."""
        with self._reg_lock:
            return {
                b.thread_name: b.dropped
                for b in self._buffers
                if b.dropped
            }

    def total_events(self) -> int:
        with self._reg_lock:
            return sum(min(b.head, b.capacity) for b in self._buffers)


# ---------------------------------------------------------------------------
# The process-current recorder: instrumentation sites capture it once at
# construction time (a runtime built inside ``Program.run(trace=...)`` sees
# it; a runtime built outside any activation sees None and stays untraced).
# ---------------------------------------------------------------------------

_CURRENT: Optional[TraceRecorder] = None
_ACT_LOCK = threading.Lock()


def current() -> Optional[TraceRecorder]:
    """The recorder instrumentation should capture right now (or None)."""
    return _CURRENT


class activate:
    """Context manager installing ``rec`` as the process-current recorder.

    ``activate(None)`` is a no-op context — callers can write one
    ``with activate(rec):`` regardless of whether tracing is on.  Nested
    activations restore the previous recorder on exit.
    """

    def __init__(self, rec: Optional[TraceRecorder]):
        self.rec = rec
        self._prev: Optional[TraceRecorder] = None

    def __enter__(self) -> Optional[TraceRecorder]:
        global _CURRENT
        if self.rec is not None:
            with _ACT_LOCK:
                self._prev = _CURRENT
                _CURRENT = self.rec
        return self.rec

    def __exit__(self, *exc) -> None:
        global _CURRENT
        if self.rec is not None:
            with _ACT_LOCK:
                _CURRENT = self._prev
