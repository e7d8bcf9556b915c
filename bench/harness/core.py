"""One run of one cell: set-up, the measured window, in a traced run a
short traced window after it, the readings of every metric the cell
reports, and the check against the reference that decides ``correct``.

The traffic's ``kind`` names the driver, ``bench/harness/<kind>.py``.  The
measured window is never traced, so a traced run's end-to-end rates and its
model FLOP share are those of an untraced window; the profiler records only
the ``trace_calls`` calls that follow it, which give the device's busy and
idle time, the launches and the kernels' times."""

from __future__ import annotations

import gc
import importlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from bench.harness import cells, spans
from bench.harness.trace import Trace, Tracer, sync
from bench.reference.precision import Precision, float32_products


def driver(kind: str):
    """The module ``bench.harness.<kind>`` that drives a traffic kind."""
    return importlib.import_module(f"bench.harness.{kind}")


@dataclass
class Run:
    """What a metric's reader gets: the cell's files, the set-up seconds,
    the measured window's counts and host times, and in a traced run the
    traced window's counts, its trace and its device work by program
    span."""

    cell: dict
    seed: int
    seconds: float
    device: torch.device
    tracer: Tracer
    setup_s: float = 0.0
    window: Dict = field(default_factory=dict)
    traced: Dict = field(default_factory=dict)

    @property
    def model(self) -> dict:
        return self.cell["config"]["model"]

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def name(self) -> str:
        return self.cell["workload"]["name"]

    @property
    def driver(self):
        return driver(self.traffic["kind"])

    @property
    def trace(self) -> Optional[Trace]:
        return self.tracer.trace

    @property
    def spans(self) -> Optional[spans.Credit]:
        return self.tracer.spans


def metrics_of(name: str, trace: bool, spec: Optional[dict] = None) -> list:
    """The BENCHMARK.json entries the cell ``name`` reports: the end-to-end
    metrics untraced, the per-layer ones traced."""
    spec = spec or cells.benchmark()
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if name in m.get("workloads", [name])]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, spec: Optional[dict] = None) -> dict:
    """Run the cell once and return its result line (a dict)."""
    run = Run(cell, seed, seconds, device, Tracer(trace, device))
    drv = run.driver
    prog = drv.setup(run)
    sync(device)
    run.setup_s = time.perf_counter() - t_start
    run.window = drv.window(run, prog, seconds=seconds)
    if trace:
        with run.tracer.window():
            run.traced = drv.window(run, prog, calls=run.traffic["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # the program's state goes before the reference runs, which then fits
    for key in ("step", "params", "state"):
        prog.pop(key, None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    float32_products()
    t_check = time.perf_counter()
    numbers = drv.check(run, prog, Precision("float32"))
    t_check = time.perf_counter() - t_check
    limits = cell["workload"]["limits"]  # a null limit: read, not compared (PERF.md)
    attempted = run.window["calls"] + run.traced.get("calls", 0)
    failed = run.window["failed"] + run.traced.get("failed", 0)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()
              if limits[k] is not None}
    checks["failed_calls"] = {"value": failed, "limit": 0}  # a call that failed is not correct
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in metrics_of(run.name, trace, spec):
        value = cells.metric_reader(m["name"])(run)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info(device, peak, run.trace)}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    result["not_compared"] = {k: v for k, v in numbers.items() if limits[k] is None}
    result["checks"] = checks
    print(f"bench: {run.name} seed {seed}: set-up {run.setup_s:.2f} s, window "
          f"{run.window['calls']} calls in {run.window['seconds']:.3f} s, check {t_check:.2f} s; "
          f"call seconds (quartiles) {quartiles(run.window['call_s'])}", file=sys.stderr)
    if run.trace is not None:
        w, t = run.window, run.traced
        slower = 100.0 * (t["seconds"] / t["calls"]) / (w["seconds"] / max(w["calls"], 1)) - 100
        print(f"bench: traced {t['calls']} calls in {t['seconds']:.3f} s, {slower:+.1f}% a call "
              f"against the measured window; {len(run.trace.kernels)} kernels for "
              f"{run.trace.launch_calls} launch calls; device stamps up to "
              f"{run.trace.late_s * 1e3:.3f} ms past the window's end", file=sys.stderr)
        print(spans.table(run.spans, t["calls"]), file=sys.stderr)
    return result


def quartiles(xs: list) -> list:
    if len(xs) < 2:
        return xs
    return [round(q, 4) for q in statistics.quantiles(xs, n=4)]


def device_info(device: torch.device, peak: int, trace: Optional[Trace]) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        info.update(busy_s=trace.busy_s, window_s=trace.window_s)
    return info
