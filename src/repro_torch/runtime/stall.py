"""Stall reporting: turn a hung or budget-expired run into an actionable
diagnosis.

When a scheduler run trips its ``max_seconds`` deadline or exhausts
``max_rounds`` without reaching quiescence, the interesting question is
*which actor is blocked on which FIFO, and how full is it* — exactly what a
silent partial return throws away.  ``stall_report`` walks the runtime's
instances and channels (using only the unguarded, cross-thread-safe
introspection surface: ``occupancy``/``total_written``) and renders that
picture; ``StallError`` carries it as the exception message plus a
``report`` attribute.

Compile-time streamcheck (``repro_torch.analysis``) rejects *provable* deadlocks
before any thread spins up; this module covers the rest — dynamic-rate
networks, external back-pressure, genuinely slow runs — at the moment they
fail.
"""

from __future__ import annotations

from typing import List

__all__ = ["StallError", "stall_report"]


class StallError(RuntimeError):
    """A run ended by deadline/budget with the network not quiescent."""

    def __init__(self, message: str, report: str):
        self.report = report
        super().__init__(f"{message}\n{report}")


def _fifo_line(name: str, fifo) -> str:
    occ = fifo.occupancy()
    return (
        f"  fifo {name}: {occ}/{fifo.capacity} tokens "
        f"({fifo.total_written} total written)"
    )


def stall_report(runtime) -> str:
    """Which actors are blocked on which FIFOs, with fill levels.

    Works on a live (possibly still-threaded) runtime: reads only monotone
    counters and owner-local ints, never the guarded endpoint API.
    """
    module = getattr(runtime, "module", None)
    fifos = getattr(runtime, "fifos", {})
    lines: List[str] = []

    occ = {name: f.occupancy() for name, f in fifos.items()}
    blocked: List[str] = []
    if module is not None:
        for name, ir in sorted(module.actors.items()):
            rate = ir.rate
            waits: List[str] = []
            for ch in module.in_channels(name):
                key = str(ch)
                if key not in occ:
                    continue
                need = rate.consume_rate(ch.dst_port) if rate.static else 1
                if need > 0 and occ[key] < need:
                    waits.append(
                        f"needs {need} on {key} (has {occ[key]})"
                    )
            for ch in module.out_channels(name):
                key = str(ch)
                if key not in occ:
                    continue
                room = fifos[key].capacity - occ[key]
                need = rate.produce_rate(ch.src_port) if rate.static else 1
                if need > 0 and room < need:
                    waits.append(
                        f"needs {need} slot(s) on {key} (full at "
                        f"{fifos[key].capacity})"
                    )
            if waits:
                blocked.append(f"  actor {name}: " + "; ".join(waits))

    lines.append("stall report:")
    if blocked:
        lines.append(f"{len(blocked)} actor(s) blocked:")
        lines.extend(blocked)
    else:
        lines.append("no statically-blocked actor (dynamic guards or "
                     "in-flight device work may be the holdup)")
    nonempty = [
        _fifo_line(name, f) for name, f in sorted(fifos.items())
        if f.occupancy() > 0
    ]
    if nonempty:
        lines.append(f"{len(nonempty)} non-empty fifo(s):")
        lines.extend(nonempty)
    else:
        lines.append("all fifos empty")
    return "\n".join(lines)
