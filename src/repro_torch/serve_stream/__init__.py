"""StreamServe — the multi-session streaming runtime.

One compiled ``Program``, many concurrent client streams::

    prog = repro_torch.compile(net, backend="device", block=1024)
    with prog.serve(batching=True) as server:
        a, b = server.open_session(), server.open_session()
        a.submit(chunk_a); b.submit(chunk_b)   # bounded, backpressured
        a.close(); b.close()
        server.drain()
        a.output()   # bit-identical to a sequential prog.run() over chunk_a

Layers (see ``docs/server.md`` and ``docs/reliability.md``):

  engine       ``StreamServer`` — the persistent engine thread; bounded
               launch retry + graceful degradation to the all-host XCF
  session      ``StreamSession`` + per-session pipelines over the lowered IR
  batcher      ``DeviceBatcher`` — B sessions, ONE batched device launch
  telemetry    ``ServerTelemetry`` — the live profile of real traffic
  repartition  ``OnlineRepartitioner`` — re-solves the MILP online and
               hot-swaps the XCF at a drained chunk boundary
  recovery     per-session checkpoint/restore — a killed engine restarts
               via ``StreamServer.recover`` and sessions resume
               bit-identically
"""

from repro_torch.serve_stream.admission import DeficitRoundRobin
from repro_torch.serve_stream.batcher import DeviceBatcher
from repro_torch.serve_stream.engine import StreamServer
from repro_torch.serve_stream.recovery import RecoveryReport, SessionRecovery
from repro_torch.serve_stream.repartition import OnlineRepartitioner
from repro_torch.serve_stream.session import (
    AdmissionFull,
    ServeError,
    StreamSession,
)
from repro_torch.serve_stream.telemetry import ServerTelemetry, TelemetrySnapshot

__all__ = [
    "AdmissionFull",
    "DeficitRoundRobin",
    "DeviceBatcher",
    "OnlineRepartitioner",
    "RecoveryReport",
    "ServeError",
    "ServerTelemetry",
    "SessionRecovery",
    "StreamServer",
    "StreamSession",
    "TelemetrySnapshot",
]
