"""Lock-less ring-buffer FIFO with global/local counters (paper §III-C).

Every channel has two monotonically increasing counters: total tokens written
(``w_pub``) and total tokens read (``r_pub``).  Each endpoint is owned by exactly
one thread; the owner mutates only its *local* counter during a scheduling round
and *publishes* it in post-fire.  The opposite endpoint sees counter updates only
via the published value snapshotted in pre-fire — so the ring buffer needs no
locks: a reader can only observe fully written tokens, a writer can only observe
fully freed slots.  (Under CPython the design is what is being reproduced; int
stores are atomic under the GIL.)

Channels whose two endpoints live on the same thread publish immediately
(``deferred=False``) — the cross-thread protocol is unnecessary there and
immediate visibility lets a chain of same-thread actors pipeline within a round.

When the ownership sanitizer (``repro_torch.runtime.sanitizer``) is enabled at
construction time, every endpoint operation asserts the single-thread
discipline the protocol depends on; ``occupancy``/``total_written``/
``unpublished`` stay unguarded — they are the deliberately cross-thread
introspection surface (stall reports, quiescence checks).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.runtime import sanitizer


class RingFifo:
    def __init__(self, capacity: int, name: str = "", deferred: bool = True):
        assert capacity > 0
        self.capacity = capacity
        self.name = name
        self.deferred = deferred
        self._guard = (
            sanitizer.EndpointGuard(name) if sanitizer.enabled() else None
        )
        self._buf: List[Any] = [None] * capacity
        # published (visible cross-thread)
        self.w_pub = 0
        self.r_pub = 0
        # owner-local
        self._w_loc = 0
        self._r_loc = 0
        # pre-fire snapshots of the *other* side
        self._w_snap = 0  # reader's view of writes
        self._r_snap = 0  # writer's view of reads
        self.total_written = 0  # monotone, for profiling / quiescence

    # ---- pre-fire -----------------------------------------------------------
    def snapshot_reader(self) -> None:
        if self._guard is not None:
            self._guard.check("reader")
        self._w_snap = self.w_pub

    def snapshot_writer(self) -> None:
        if self._guard is not None:
            self._guard.check("writer")
        self._r_snap = self.r_pub

    # ---- post-fire ------------------------------------------------------------
    def publish_reader(self) -> None:
        if self._guard is not None:
            self._guard.check("reader")
        self.r_pub = self._r_loc

    def publish_writer(self) -> None:
        if self._guard is not None:
            self._guard.check("writer")
        self.w_pub = self._w_loc

    def _sync_now(self) -> None:
        if not self.deferred:
            self.w_pub = self._w_loc
            self.r_pub = self._r_loc
            self._w_snap = self.w_pub
            self._r_snap = self.r_pub

    # ---- reader API -------------------------------------------------------------
    def count(self) -> int:
        if self._guard is not None:
            self._guard.check("reader")
        if not self.deferred:
            self._w_snap = self.w_pub
        return self._w_snap - self._r_loc

    def peek(self, n: int) -> Tuple[Any, ...]:
        assert self.count() >= n, f"{self.name}: peek({n}) with {self.count()}"
        i0 = self._r_loc % self.capacity
        if i0 + n <= self.capacity:  # contiguous: one C-level slice
            return tuple(self._buf[i0:i0 + n])
        head = self.capacity - i0
        return tuple(self._buf[i0:]) + tuple(self._buf[:n - head])

    def read(self, n: int) -> Tuple[Any, ...]:
        vals = self.peek(n)
        self.commit(n)
        return vals

    def peek_view(self, n: int) -> Optional[List[Any]]:
        """The next ``n`` tokens as ONE direct slice of the ring storage —
        no per-token tuple boxing — or None when the window wraps (callers
        fall back to ``read``).  Pair with ``commit(n)`` after consuming;
        the view must not be used past the commit (a later ``write`` may
        reuse those slots)."""
        assert self.count() >= n, (
            f"{self.name}: peek_view({n}) with {self.count()}"
        )
        i0 = self._r_loc % self.capacity
        if i0 + n > self.capacity:
            return None
        return self._buf[i0:i0 + n]

    def commit(self, n: int) -> None:
        """Consume ``n`` tokens previously obtained via ``peek_view``."""
        assert self.count() >= n, f"{self.name}: commit({n}) with {self.count()}"
        self._r_loc += n
        self._sync_now()

    # ---- writer API ----------------------------------------------------------------
    def space(self) -> int:
        if self._guard is not None:
            self._guard.check("writer")
        if not self.deferred:
            self._r_snap = self.r_pub
        return self.capacity - (self._w_loc - self._r_snap)

    def write(self, vals: Sequence[Any]) -> None:
        n = len(vals)
        assert self.space() >= n, f"{self.name}: overflow"
        i0 = self._w_loc % self.capacity
        if i0 + n <= self.capacity:  # contiguous: one C-level splice
            self._buf[i0:i0 + n] = list(vals)
        else:
            head = self.capacity - i0
            vals = list(vals)
            self._buf[i0:] = vals[:head]
            self._buf[:n - head] = vals[head:]
        self._w_loc += n
        self.total_written += n
        self._sync_now()

    # ---- introspection ---------------------------------------------------------------
    @property
    def unpublished(self) -> bool:
        return self._w_loc != self.w_pub or self._r_loc != self.r_pub

    def occupancy(self) -> int:
        """True occupancy (both local counters) — debugging/termination only."""
        return self._w_loc - self._r_loc

    def __repr__(self):
        return (
            f"RingFifo({self.name!r}, cap={self.capacity}, "
            f"w={self._w_loc}, r={self._r_loc})"
        )


class ArrayFifo:
    """Numpy-block FIFO for device→device PLink lanes.

    A channel between two accelerator partitions never carries host tokens:
    the producing PLink retires whole masked blocks and the consuming PLink
    stages whole blocks.  Boxing every token into a Python object through a
    ``RingFifo`` would put a host round-trip of per-token work on a path
    whose endpoints are both device programs — this FIFO instead queues the
    retired numpy arrays themselves and serves reads as (at most one
    concatenate of) array slices.

    Concurrency contract: exactly one writer thread (the upstream PLink's)
    and one reader thread (the downstream PLink's).  The writer only appends
    and advances ``_w``; the reader only consumes from the head and advances
    ``_r``; both counters are monotone ints (atomic under the GIL), so the
    reader can never observe a partially appended block.  The RingFifo
    snapshot/publish calls are accepted as no-ops — progress is immediately
    visible, which is strictly more conservative for quiescence.
    """

    def __init__(self, capacity: int, name: str = "", deferred: bool = True):
        assert capacity > 0
        self.capacity = capacity
        self.name = name
        self.deferred = deferred
        self._guard = (
            sanitizer.EndpointGuard(name) if sanitizer.enabled() else None
        )
        self._blocks: List[Any] = []  # writer appends, reader pops head
        self._head = 0  # tokens consumed from _blocks[0]
        self._w = 0  # total written (writer-owned)
        self._r = 0  # total read (reader-owned)
        self.total_written = 0

    # -- RingFifo protocol no-ops (always-published semantics) --------------
    def snapshot_reader(self) -> None:
        pass

    def snapshot_writer(self) -> None:
        pass

    def publish_reader(self) -> None:
        pass

    def publish_writer(self) -> None:
        pass

    @property
    def unpublished(self) -> bool:
        return False

    # -- reader API ----------------------------------------------------------
    def count(self) -> int:
        if self._guard is not None:
            self._guard.check("reader")
        return self._w - self._r

    def read(self, n: int):
        import numpy as np

        assert self.count() >= n, f"{self.name}: read({n}) with {self.count()}"
        if n == 0:
            return np.empty((0,))
        vals = self.peek(n)
        self.commit(n)
        return vals

    def peek(self, n: int):
        import numpy as np

        assert self.count() >= n, f"{self.name}: peek({n}) with {self.count()}"
        parts = []
        got = 0
        head = self._head
        for blk in self._blocks:
            take = min(len(blk) - head, n - got)
            parts.append(blk[head:head + take])
            got += take
            head = 0
            if got == n:
                break
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def peek_view(self, n: int):
        """The next ``n`` tokens as a genuinely zero-copy numpy view into
        the head block, or None when they span a block boundary (callers
        fall back to ``read``).  Pair with ``commit(n)``."""
        assert self.count() >= n, (
            f"{self.name}: peek_view({n}) with {self.count()}"
        )
        if not self._blocks or len(self._blocks[0]) - self._head < n:
            return None
        return self._blocks[0][self._head:self._head + n]

    def commit(self, n: int) -> None:
        """Consume ``n`` tokens previously obtained via ``peek_view``."""
        assert self.count() >= n, (
            f"{self.name}: commit({n}) with {self.count()}"
        )
        got = 0
        while got < n:
            blk = self._blocks[0]
            take = min(len(blk) - self._head, n - got)
            got += take
            if self._head + take == len(blk):
                self._blocks.pop(0)
                self._head = 0
            else:
                self._head += take
        self._r += n

    # -- writer API ----------------------------------------------------------
    def space(self) -> int:
        if self._guard is not None:
            self._guard.check("writer")
        return self.capacity - (self._w - self._r)

    def write(self, vals) -> None:
        import numpy as np

        arr = np.asarray(vals)
        n = len(arr)
        assert self.space() >= n, f"{self.name}: overflow"
        if n == 0:
            return
        self._blocks.append(arr)
        self._w += n
        self.total_written += n

    # -- introspection -------------------------------------------------------
    def occupancy(self) -> int:
        return self._w - self._r

    def __repr__(self):
        return (
            f"ArrayFifo({self.name!r}, cap={self.capacity}, "
            f"w={self._w}, r={self._r})"
        )


class ReaderEndpoint:
    """Reader-side view bound into a PortEnv."""

    def __init__(self, fifo: RingFifo):
        self.fifo = fifo

    def count(self) -> int:
        return self.fifo.count()

    def peek(self, n: int):
        return self.fifo.peek(n)

    def read(self, n: int):
        return self.fifo.read(n)

    def peek_view(self, n: int):
        """Zero-copy contiguous window (None when it wraps) — see
        ``RingFifo.peek_view``/``ArrayFifo.peek_view``; consume with
        ``commit``."""
        return self.fifo.peek_view(n)

    def commit(self, n: int) -> None:
        return self.fifo.commit(n)


class WriterEndpoint:
    def __init__(self, fifo: RingFifo):
        self.fifo = fifo

    def space(self) -> int:
        return self.fifo.space()

    def write(self, vals):
        return self.fifo.write(vals)
