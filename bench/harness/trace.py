"""The traced window: ``torch.profiler`` over a few calls after the
measured window, and its reduction to what the per-layer readers take.

The benchmark wraps its own calls into the program in spans
(``record_function``: ``window``, ``feed``, ``train_step``, ``prefill``,
``read_back``), inside the traced window only.  From the trace it keeps the
device's activities inside the window: each kernel's name and time, and the
union of every kernel, copy and fill interval, which is the device's busy
time (overlapping activities count once).  Each idle gap between busy
intervals is labelled by the benchmark span the host was in when the gap
began and the last operation the host had started: what held the device
back.  The profiler records every host operation, which slows the host:
the traced calls run slower than the measured window's, and the run says by
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
BENCH_SPANS = ("feed", "train_step", "prefill", "read_back")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]            # (name, seconds) of each kernel
    device_ops: List[Tuple[str, float]]         # the 10 longest by summed time
    idle_gaps: List[Tuple[str, float]]          # the 10 largest labels by summed idle time
    launch_calls: int = 0                       # host calls that launched a kernel

    def kernel_time(self, *names: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds one of ``names``."""
        sel = [s for n, s in self.kernels if any(m in n for m in names)]
        return sum(sel), len(sel)


class Tracer:
    """``window()`` traces the calls made inside it; ``span(name)`` wraps a
    call in a profiler span there, and is free elsewhere."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.active = False
        self.trace: Optional[Trace] = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            raise RuntimeError("a traced window in an untraced run")
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
            time.sleep(MARGIN_S)
            self.active = True
            try:
                with torch.profiler.record_function("window"):
                    yield
            finally:
                self.active = False
            sync(self.device)
            time.sleep(MARGIN_S)
            prof.step()
        self.trace = reduce(raw_events(prof))


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
    ``host`` (start, name) of every host operation, and ``launches``."""
    spans, device, host = [], [], []
    launches = 0
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
            if "LaunchKernel" in name:
                launches += 1
    return {"spans": spans, "device": device, "host": host, "launches": launches}


def reduce(ev: dict) -> Trace:
    windows = [(s, e) for n, s, e in ev["spans"] if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
    w0, w1 = windows[0]
    inside = sorted((max(s, w0), min(e, w1), n, k) for n, s, e, k in ev["device"]
                    if e > w0 and s < w1)
    kernels = [(n, e - s) for s, e, n, k in inside if k]
    merged: List[List[float]] = []
    for s, e, _, _ in inside:
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
    by_label: Dict[str, float] = {}
    for s, e in gaps:
        i = bisect.bisect_right(span_starts, s) - 1
        where = spans[i][2] if i >= 0 and spans[i][1] > s else "between calls"
        j = bisect.bisect_right(host_starts, s) - 1
        what = host[j][1] if j >= 0 else "nothing"
        label = f"{where}: {what}"[:160]
        by_label[label] = by_label.get(label, 0.0) + (e - s)

    by_name: Dict[str, float] = {}
    for s, e, n, _ in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return Trace(window_s=w1 - w0, busy_s=busy, kernels=kernels,
                 device_ops=[(n[:160], s) for n, s in top(by_name)],
                 idle_gaps=top(by_label), launch_calls=ev["launches"])
