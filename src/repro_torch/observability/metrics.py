"""Metrics registry — counters, gauges, histograms with percentiles.

The trace recorder answers "where did time go in *this* run"; the metrics
registry answers "what does the service look like *right now*": monotone
counters, point-in-time gauges, and log-bucketed histograms whose
p50/p95/p99 back the serve engine's SLO story (per-session TTFO,
inter-block latency).  ``MetricsRegistry.expose_text()`` renders the whole
registry in the Prometheus text exposition format, so a scrape endpoint is
one HTTP handler away.

Histograms use exponential bucket bounds (factor ``growth`` from ``least``)
— a fixed, allocation-free layout whose percentile error is bounded by the
bucket ratio (log-linear interpolation inside the winning bucket).  All
mutation holds a per-metric lock: observations are read-modify-write and
arrive from client threads as well as the engine.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def _fmt(v: float) -> str:
    """Prometheus-style number rendering (no trailing zeros noise)."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _sanitize(name: str) -> str:
    return "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name
    )


class Counter:
    """Monotone event count."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> List[str]:
        n = _sanitize(self.name)
        return [
            f"# HELP {n} {self.help}",
            f"# TYPE {n} counter",
            f"{n} {_fmt(self._v)}",
        ]


class Gauge:
    """Point-in-time value (set/add)."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def expose(self) -> List[str]:
        n = _sanitize(self.name)
        return [
            f"# HELP {n} {self.help}",
            f"# TYPE {n} gauge",
            f"{n} {_fmt(self._v)}",
        ]


class Histogram:
    """Log-bucketed distribution with interpolated percentiles.

    Bucket upper bounds grow geometrically from ``least`` by ``growth``
    until ``greatest`` (plus a +Inf catch-all), so the relative error of a
    percentile is bounded by ``growth`` regardless of the distribution.
    Defaults suit latencies in *seconds* — 1µs to ~1000s.
    """

    def __init__(
        self,
        name: str,
        help: str = "",
        *,
        least: float = 1e-6,
        greatest: float = 1e3,
        growth: float = 2.0,
        bounds: Optional[Sequence[float]] = None,
    ):
        self.name = name
        self.help = help
        if bounds is not None:
            self.bounds = [float(b) for b in bounds]
        else:
            self.bounds = []
            b = least
            while b <= greatest:
                self.bounds.append(b)
                b *= growth
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v
            mid = (lo + hi) // 2
            if self.bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> float:
        """Interpolated percentile, ``p`` in [0, 100].  0 with no samples."""
        with self._lock:
            if self.count == 0:
                return 0.0
            rank = p / 100.0 * self.count
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    # log-linear interpolation inside the bucket, clamped to
                    # the observed extremes so tiny samples stay honest
                    lo = self.bounds[i - 1] if i > 0 else (
                        self.min if self.min is not None else 0.0
                    )
                    hi = (
                        self.bounds[i] if i < len(self.bounds)
                        else (self.max if self.max is not None else lo)
                    )
                    lo = max(lo, self.min if self.min is not None else lo)
                    hi = min(hi, self.max if self.max is not None else hi)
                    if lo <= 0 or hi <= lo:
                        est = hi
                    else:
                        frac = (rank - seen) / c
                        est = math.exp(
                            math.log(lo)
                            + frac * (math.log(hi) - math.log(lo))
                        )
                    return min(
                        max(est, self.min if self.min is not None else est),
                        self.max if self.max is not None else est,
                    )
                seen += c
            return self.max if self.max is not None else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min or 0.0,
            "max": self.max or 0.0,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }

    def expose(self) -> List[str]:
        n = _sanitize(self.name)
        out = [f"# HELP {n} {self.help}", f"# TYPE {n} histogram"]
        with self._lock:
            cum = 0
            for bound, c in zip(self.bounds, self._counts):
                cum += c
                out.append(f'{n}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += self._counts[-1]
            out.append(f'{n}_bucket{{le="+Inf"}} {cum}')
            out.append(f"{n}_sum {_fmt(self.sum)}")
            out.append(f"{n}_count {self.count}")
        return out


class MetricsRegistry:
    """Name-keyed metric store; get-or-create accessors, one exposition."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(name, Histogram, help, **kw)

    def get(self, name: str):
        return self._metrics.get(name)

    def items(self) -> List[Tuple[str, object]]:
        with self._lock:
            return sorted(self._metrics.items())

    def expose_text(self) -> str:
        """The whole registry in Prometheus text exposition format."""
        lines: List[str] = []
        for _name, m in self.items():
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")
