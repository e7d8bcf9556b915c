"""The program's spans in a device trace: each device activity credited to
the innermost program span that was open when the host call that launched
it was made.

The port wraps its LM layers in streamtrace spans
(``repro_torch.observability.span``); while a recorder is active and
``torch.profiler`` records, each also opens a ``record_function`` of its
name, so it lies in the trace as a user annotation on the profiler's clock.
A device activity (kernel, copy or fill) and the runtime call that launched
it share a correlation id, so work is credited where it was launched, not
where the device happened to run it.  Of the spans open at a launch the one
opened last is the innermost, whichever thread opened it: while the
autograd engine's thread runs a backward, the main thread waits inside
``train.backward``, and the engine's own spans open later.  Credit is self
time (work credited to a span is not its parent's); work under no program
span goes to ``OUTSIDE``, so the table sums to every device activity in the
window.

The window's activities are those its calls launched
(``trace.window_activities``), whatever their stamps.  The profiler can
lose records, and a lost record moves a span's reading with no error of
its own.  So the crediting counts what it cannot match: a device activity
whose correlation id has no runtime call, and a kernel launch in the
window with no device activity in the trace; it compares each span's
kernels between the traced calls, which do the same work; and it keeps
what the program's recorder dropped.  ``faults()`` names each; the table
prints them, and the readers read nothing from a window with a fault.

``trace.Tracer.window`` records the program's spans over the traced calls
and hands ``raw_events(prof)`` to ``credit``; the run keeps the result as
``run.spans``.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from bench.harness import trace

OUTSIDE = "outside any program span"
NOT_PROGRAM = re.compile(r"^(window|ProfilerStep#\d+)$")
RUNTIME = re.compile(r"^(cuda|cu[A-Z])")  # cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync...


@dataclass
class Credit:
    device_s: float                      # every device activity in the window, summed
    by_span: Dict[str, List[float]]      # name -> [device seconds, kernels] (self)
    unlaunched: int                      # device activities whose launch is not in the trace
    unrun: int                           # kernel launches in the window with no device record
    uneven: Dict[str, List[int]]         # "span in call" -> its kernels in each traced call, where they differ
    dropped: Dict[str, int] = field(default_factory=dict)  # thread -> span events dropped

    def faults(self) -> List[str]:
        """What the profiler or the recorder lost, as far as the trace
        shows: empty where every record matched and every traced call read
        the same."""
        out = []
        if self.unlaunched:
            out.append(f"{self.unlaunched} device activities with no launching call in the trace")
        if self.unrun:
            out.append(f"{self.unrun} kernel launches in the window with no device activity "
                       f"in the trace")
        out += [f"{k}: kernels per call differ {v}" for k, v in sorted(self.uneven.items())]
        out += [f"the program's recorder dropped {n} span events on thread {t}"
                for t, n in sorted(self.dropped.items())]
        return out


def raw_events(prof) -> dict:
    """``trace.raw_events(prof)`` and what crediting and ``trace.reduce``
    need beside it, times in seconds: ``program`` (name, start, end) of each program span,
    ``corr`` the correlation id of each entry of ``device``, and ``launch``
    {correlation id: (start, name)} of each CUDA runtime call (a call that
    launched work shares its id with that work)."""
    ev = trace.raw_events(prof)
    program, corr, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                corr.append(e.correlation_id())
        elif e.is_user_annotation():
            if name not in trace.BENCH_SPANS and not NOT_PROGRAM.match(name):
                program.append((name, start, start + e.duration_ns() * 1e-9))
        elif RUNTIME.match(name):
            launch[e.correlation_id()] = (start, name)
    if len(corr) != len(ev["device"]):
        raise RuntimeError(f"{len(corr)} correlation ids for {len(ev['device'])} device events")
    return dict(ev, program=program, corr=corr, launch=launch)


def credit(ev: dict, dropped: Optional[Dict[str, int]] = None) -> Credit:
    """The window's device work by program span; ``dropped``: the span
    events the program's recorder dropped, by thread."""
    w0, w1 = trace.window_of(ev)
    inside = [(s, e, k, c) for s, e, _, k, c in trace.window_activities(ev)]
    ran = set(ev["corr"])
    unrun = sum(1 for c, (t, name) in ev["launch"].items()
                if "LaunchKernel" in name and w0 <= t <= w1 and c not in ran)

    # the benchmark's calls, each with the kernels of each span launched in it
    calls = sorted((s, e, n) for n, s, e in ev["spans"] if n in trace.BENCH_SPANS)
    call_starts = [s for s, _, _ in calls]
    in_call: List[Dict[str, int]] = [defaultdict(int) for _ in calls]

    by_span: Dict[str, List[float]] = {n: [0.0, 0] for n, _, _ in ev["program"]}
    by_span[OUTSIDE] = [0.0, 0]
    unlaunched = sum(c not in ev["launch"] for _, _, _, c in inside)
    launched = sorted((ev["launch"].get(c, (float("-inf"),))[0], s, e, k) for s, e, k, c in inside)
    inner = trace.Innermost(ev["program"])
    for t, s, e, k in launched:
        name = inner.at(t) or OUTSIDE
        by_span[name][0] += e - s
        by_span[name][1] += int(k)
        i = bisect.bisect_right(call_starts, t) - 1
        if i >= 0 and calls[i][1] > t:
            in_call[i][name] += int(k)

    uneven: Dict[str, List[int]] = {}
    for call in sorted({n for _, _, n in calls}):
        rows = [in_call[i] for i, (_, _, n) in enumerate(calls) if n == call]
        for name in sorted(set().union(*rows)):
            counts = [r[name] for r in rows]
            if len(set(counts)) > 1:
                uneven[f"{name} in {call}"] = counts
    return Credit(device_s=sum(e - s for s, e, _, _ in inside), by_span=by_span,
                  unlaunched=unlaunched, unrun=unrun, uneven=uneven, dropped=dict(dropped or {}))


def table(cr: Credit, calls: int) -> str:
    """The per-span table a traced run prints: device ms and kernels per
    call, self time, and the total against every device activity."""
    rows = sorted(cr.by_span.items(), key=lambda kv: -kv[1][0])
    lines = [f"{'program span':<28} {'device ms/call':>14} {'kernels/call':>12}"]
    lines += [f"{n:<28} {s * 1e3 / calls:>14.3f} {k / calls:>12.1f}" for n, (s, k) in rows]
    total = sum(s for s, _ in cr.by_span.values())
    lines.append(f"{'total':<28} {total * 1e3 / calls:>14.3f} "
                 f"(device activity in the window {cr.device_s * 1e3 / calls:.3f})")
    lines += [f"LOST RECORDS: {f}" for f in cr.faults()]
    return "\n".join(lines)


def _readable(cr: Optional[Credit], calls: int) -> bool:
    return cr is not None and calls > 0 and not cr.faults()


def span_ms(cr: Optional[Credit], calls: int, *names: str) -> Optional[float]:
    """Device ms per call credited to the spans ``names``; nothing where the
    trace credits them no device activity, or the window has a fault."""
    if not _readable(cr, calls):
        return None
    secs = sum(cr.by_span[n][0] for n in names if n in cr.by_span)
    return secs * 1e3 / calls if secs > 0 else None


def span_kernels(cr: Optional[Credit], calls: int, name: str) -> Optional[float]:
    """Kernels per call credited to the span ``name``; nothing where the
    trace credits it none, or the window has a fault."""
    if not _readable(cr, calls) or not cr.by_span.get(name, [0, 0])[1]:
        return None
    return cr.by_span[name][1] / calls
