"""streamtrace — unified tracing + metrics for every execution layer.

One recorder, three views (see docs/observability.md):

  1. **Chrome trace** — ``Program.run(trace=path)`` / ``StreamServer
     .trace()`` export Trace Event Format JSON that opens in
     ``chrome://tracing`` / Perfetto: one track per scheduler thread,
     PLink lane, and serve session; spans for actor firings, host-fused
     region evaluations, and the PLink stage/dispatch/sync/retire phases.
  2. **Metrics** — ``MetricsRegistry`` counters/gauges/histograms
     (p50/p95/p99) backing the serve engine's TTFO and inter-block
     latency SLOs, with Prometheus text exposition.
  3. **Profile replay** — ``core.profiler.profile_from_trace`` rebuilds a
     ``NetworkProfile`` from a recorded trace, so ``explore()`` runs the
     profile-guided DSE offline from a trace file through the same
     ingestion path as live telemetry.

Copy of ``repro/observability/__init__.py``.  Edit: it exports ``span``.
"""

from repro_torch.observability.chrome import (
    chrome_trace,
    load_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from repro_torch.observability.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.observability.recorder import TraceRecorder, activate, current
from repro_torch.observability.spans import span
from repro_torch.observability.trace_profile import (
    authored_channel_key,
    phase_totals,
    snapshot_from_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "TraceRecorder",
    "activate",
    "authored_channel_key",
    "chrome_trace",
    "current",
    "load_trace",
    "phase_totals",
    "snapshot_from_trace",
    "span",
    "validate_chrome_trace",
    "write_chrome_trace",
]
