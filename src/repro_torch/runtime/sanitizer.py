"""Debug-mode FIFO endpoint ownership sanitizer.

The lock-less ring FIFO (``repro_torch.runtime.fifo``) is correct only under a
single-thread-per-endpoint discipline: exactly one thread ever acts as the
reader and one as the writer of each channel, with cross-thread visibility
flowing through the snapshot/publish counters alone.  The scheduler, PLink
lanes, and serve pipelines are all built to respect that contract — but
nothing at runtime *checks* it, and a violation doesn't crash, it corrupts:
torn reads, lost tokens, phantom quiescence.

This module is the checker.  When enabled (before the FIFOs are
constructed), every fifo records the first thread to touch each endpoint
and raises ``OwnershipError`` the moment a different thread uses that side.
Enable it with the ``REPRO_SANITIZE=1`` environment variable, the
``enable()`` call, or the ``sanitized()`` context manager::

    with sanitizer.sanitized():
        repro_torch.compile(g, xcf).run()     # any ownership breach raises

The check costs one dict lookup per FIFO operation, so it is off by
default; the conformance suite runs its whole chain x placement sweep under
it (``tests/test_conformance.py``).

Deliberate endpoint handoffs (a repartition swap moving a channel to a new
thread) should ``EndpointGuard.release()`` the side being handed over, or
simply rebuild the runtime — fresh FIFOs get fresh guards.
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Dict, Tuple

__all__ = [
    "OwnershipError",
    "EndpointGuard",
    "enabled",
    "enable",
    "sanitized",
]


_enabled = os.environ.get("REPRO_SANITIZE", "") not in ("", "0", "false")


class OwnershipError(AssertionError):
    """A FIFO endpoint was driven from two different threads."""


def enabled() -> bool:
    """Whether newly constructed FIFOs attach ownership guards."""
    return _enabled


def enable(on: bool = True) -> None:
    """Turn the sanitizer on/off for FIFOs constructed *after* this call."""
    global _enabled
    _enabled = on


@contextmanager
def sanitized():
    """Enable the sanitizer for the duration of the block (construction
    time decides: runtimes built inside are guarded for their lifetime)."""
    prev = _enabled
    enable(True)
    try:
        yield
    finally:
        enable(prev)


class EndpointGuard:
    """Per-FIFO ownership record: first toucher of each side owns it.

    Ownership is claimed lazily (the constructing thread often isn't the
    running thread), and each side independently — an admission queue
    legitimately has a client-thread writer and an engine-thread reader.
    """

    __slots__ = ("name", "_owners")

    def __init__(self, name: str = ""):
        self.name = name or "<fifo>"
        # side -> (thread ident, thread name)
        self._owners: Dict[str, Tuple[int, str]] = {}

    def check(self, side: str) -> None:
        me = threading.get_ident()
        owner = self._owners.get(side)
        if owner is None:
            self._owners[side] = (me, threading.current_thread().name)
            return
        if owner[0] != me:
            raise OwnershipError(
                f"fifo {self.name!r}: {side} endpoint driven from thread "
                f"{threading.current_thread().name!r} but owned by thread "
                f"{owner[1]!r} — the lock-less FIFO protocol requires one "
                f"thread per endpoint (snapshot/publish visibility breaks "
                f"otherwise); hand the endpoint over explicitly or fix the "
                f"partition mapping"
            )

    def release(self, side: str) -> None:
        """Forget a side's owner (deliberate endpoint handoff)."""
        self._owners.pop(side, None)
