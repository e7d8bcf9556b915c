"""The traced window: ``torch.profiler`` over a few calls after the
measured window, and its reduction to what the per-layer readers take.

The benchmark wraps its own calls into the program in spans
(``record_function``: ``window``, ``feed``, ``train_step``, ``prefill``,
``read_back``), inside the traced window only; the program's own spans
(``program.recording``) lie in the same trace.  The window's device
activities are those launched by a host call inside it, found by
correlation id: the profiler stamps a device record on the device's clock
mapped onto the host's, and that mapping can be off by tens of
milliseconds, so a record launched and finished inside the window (which
closes on a synchronize) can be stamped after its end.  From them it keeps
each kernel's name and time, and the union of every kernel, copy and fill
interval, which is the device's busy time (overlapping activities count
once).  Each idle gap between busy intervals is labelled by the benchmark
span and the innermost program span the host was in when the gap began,
and the last operation the host had started: what held the device back.
The profiler records every host operation, which slows the host: the
traced calls run slower than the measured window's, and the run says by
how much.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

MARGIN_S = 0.05  # idle margins at each end of the traced window
PRIME_KERNELS = 32  # launched in the profiler's active phase before the window opens
BENCH_SPANS = ("feed", "train_step", "prefill", "read_back")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]            # (name, seconds) of each kernel
    device_ops: List[Tuple[str, float]]         # the 10 longest by summed time
    idle_gaps: List[Tuple[str, float]]          # the 10 largest labels by summed idle time
    launch_calls: int = 0                       # host calls in the window that launched a kernel
    late_s: float = 0.0                         # how far device stamps run past the window's end

    def kernel_time(self, *names: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds one of ``names``."""
        sel = [s for n, s in self.kernels if any(m in n for m in names)]
        return sum(sel), len(sel)


class Tracer:
    """``window()`` traces the calls made inside it, with the program's
    spans; ``span(name)`` wraps a call in a profiler span there, and is free
    elsewhere.  After the window, ``trace`` holds its reduction and
    ``spans`` its device work credited to the program's spans
    (``spans.Credit``)."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.trace: Optional[Trace] = None
        self.spans = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            raise RuntimeError("a traced window in an untraced run")
        from bench.harness import program, spans  # spans builds on this module

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            # a warm-up phase, traced and discarded, and idle margins around
            # the window: without them the profiler loses kernel records
            torch.ones(1, device=self.device).add_(1)
            sync(self.device)
            prof.step()
            # the active phase can lose the records of its first launches:
            # spend them on kernels before the window opens
            x = torch.ones(1024, device=self.device)
            for _ in range(PRIME_KERNELS):
                x.add_(1)
            sync(self.device)
            time.sleep(MARGIN_S)
            self.active = True
            try:
                with program.recording() as rec, torch.profiler.record_function("window"):
                    yield
            finally:
                self.active = False
            sync(self.device)
            time.sleep(MARGIN_S)
            prof.step()
        ev = spans.raw_events(prof)
        self.trace = reduce(ev)
        self.spans = spans.credit(ev, dropped=rec.drops())


def ticks(t0: float, seconds: Optional[float], calls: Optional[int]):
    """The start time of each call of a window opened at ``t0``: calls are
    started until ``seconds`` have passed, or ``calls`` of them."""
    n = 0
    while True:
        now = time.perf_counter()
        if (n >= calls) if calls is not None else (now - t0 >= seconds):
            return
        yield now
        n += 1


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def raw_events(prof) -> dict:
    """The profiler's events as plain tuples, times in seconds:
    ``spans`` (benchmark spans), ``device`` (name, start, end, is_kernel),
    ``host`` (start, name) of every host operation."""
    spans, device, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        if e.is_user_annotation():
            if not on_device:
                spans.append((name, start, end))
        elif on_device:
            device.append((name, start, end, not name.startswith(("Memcpy", "Memset"))))
        else:
            host.append((start, name))
    return {"spans": spans, "device": device, "host": host}


def window_of(ev: dict) -> Tuple[float, float]:
    windows = [(s, e) for n, s, e in ev["spans"] if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
    return windows[0]


def window_activities(ev: dict) -> List[Tuple[float, float, str, bool, int]]:
    """(start, end, name, is_kernel, correlation id) of the window's device
    activities, by start: those whose launching call (``ev["launch"]``)
    lies in the window, wherever their stamps lie, and those whose launch
    the trace lacks but whose stamps meet the window."""
    w0, w1 = window_of(ev)
    out = []
    for (n, s, e, k), c in zip(ev["device"], ev["corr"]):
        launched = ev["launch"].get(c)
        if (w0 <= launched[0] <= w1) if launched else (e > w0 and s < w1):
            out.append((s, e, n, k, c))
    return sorted(out)


class Innermost:
    """The innermost program span open at each of a rising sequence of
    times: the one opened last among those covering the time."""

    def __init__(self, program):
        self.spans = sorted((s, e, n) for n, s, e in program)
        self.i = 0
        self.open: List[Tuple[float, float, str]] = []

    def at(self, t: float) -> Optional[str]:
        while self.i < len(self.spans) and self.spans[self.i][0] <= t:
            self.open.append(self.spans[self.i])
            self.i += 1
        self.open = [sp for sp in self.open if sp[1] > t]
        return self.open[-1][2] if self.open else None


def reduce(ev: dict) -> Trace:
    """The window's kernels, busy and idle time and launches from the events
    of ``spans.raw_events``."""
    w0, w1 = window_of(ev)
    inside = window_activities(ev)
    kernels = [(n, e - s) for s, e, n, k, _ in inside if k]
    merged: List[List[float]] = []
    for s, e, _, _, _ in inside:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [t for iv in merged for t in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    spans = sorted((s, e, n) for n, s, e in ev["spans"] if n in BENCH_SPANS)
    span_starts = [s for s, _, _ in spans]
    host = sorted(ev["host"])
    host_starts = [s for s, _ in host]
    inner = Innermost(ev["program"])
    by_label: Dict[str, float] = {}
    for s, e in gaps:
        i = bisect.bisect_right(span_starts, s) - 1
        where = spans[i][2] if i >= 0 and spans[i][1] > s else "between calls"
        program = inner.at(s)
        if program is not None:
            where = f"{where} > {program}"
        j = bisect.bisect_right(host_starts, s) - 1
        what = host[j][1] if j >= 0 else "nothing"
        label = f"{where}: {what}"[:160]
        by_label[label] = by_label.get(label, 0.0) + (e - s)

    by_name: Dict[str, float] = {}
    for s, e, n, _, _ in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    launches = sum(1 for t, n in ev["launch"].values() if "LaunchKernel" in n and w0 <= t <= w1)
    return Trace(window_s=w1 - w0, busy_s=busy, kernels=kernels,
                 device_ops=[(n[:160], s) for n, s in top(by_name)],
                 idle_gaps=top(by_label), launch_calls=launches,
                 late_s=max([0.0] + [e - w1 for _, e, _, _, _ in inside]))
