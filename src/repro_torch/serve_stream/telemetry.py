"""Live server telemetry — the online analogue of ``Program.profile()``.

The offline flow measures the MILP's inputs once, before deployment
(§III-E).  A long-lived server sees the *actual* traffic, so the engine
feeds every scheduling round into this collector: per-actor firing counts
and wall time for host actors, per-link token totals, device-dispatch
counts/latency/lane occupancy, and admission-queue depths.  Snapshots are
windowed — ``snapshot()`` returns everything accumulated since the last
call — which is what lets the online repartitioner react to traffic shifts
instead of averaging over the server's whole lifetime.

``core.profiler.profile_from_telemetry`` turns a snapshot into the
``NetworkProfile`` the MILP consumes.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

ChannelKey = Tuple[str, str, str, str]


@dataclass
class TelemetrySnapshot:
    """One observation window, ready for profile ingestion."""

    seconds: float                               # window wall-clock length
    actor_fires: Dict[str, int]
    actor_time_ns: Dict[str, int]
    channel_tokens: Dict[ChannelKey, int]        # tokens moved per link
    device_dispatches: int                       # batched launches
    device_lanes: int                            # session lanes across launches
    device_width: int                            # launch widths incl. pad lanes
    lanes_peak: int                              # most live lanes in one launch
    device_time_ns: int                          # host-observed dispatch+retire
    device_tokens_in: int
    device_tokens_out: int
    sessions_opened: int
    sessions_closed: int
    chunks_submitted: int
    chunks_split: int                            # submissions chunked at admission
    tokens_submitted: int
    tokens_delivered: int
    queue_peak: int                              # deepest admission queue seen
    swaps: int                                   # XCF hot-swaps in the window

    @property
    def mean_batch(self) -> float:
        return self.device_lanes / max(self.device_dispatches, 1)

    @property
    def pad_fraction(self) -> float:
        """Fraction of launched lanes that were masked padding (ragged
        packing reuses a compiled width within ``LANE_SLACK``)."""
        return 1.0 - self.device_lanes / max(self.device_width, 1)

    def throughput(self) -> float:
        """Delivered tokens per second over the window."""
        return self.tokens_delivered / max(self.seconds, 1e-9)


class ServerTelemetry:
    """Accumulates observations; ``snapshot()`` drains the window.

    Most writes come from the engine thread, but admission-side counters
    (``chunks_submitted``/``tokens_submitted``, session opens) land from
    client threads, so every mutation and the window swap hold a small
    lock — increments are read-modify-write, not atomic stores, and a
    ``snapshot()`` racing a client increment would drop it into the
    discarded window.
    """

    def __init__(self) -> None:
        self.started = time.perf_counter()
        self._win_start = self.started
        self.totals = self._zero()
        self._win = self._zero()
        self._lock = threading.Lock()
        self.swap_log: List[Dict] = []  # every hot-swap, for introspection

    @staticmethod
    def _zero() -> Dict:
        return dict(
            actor_fires={}, actor_time_ns={}, channel_tokens={},
            device_dispatches=0, device_lanes=0, device_width=0,
            lanes_peak=0, device_time_ns=0,
            device_tokens_in=0, device_tokens_out=0,
            sessions_opened=0, sessions_closed=0,
            chunks_submitted=0, chunks_split=0,
            tokens_submitted=0, tokens_delivered=0,
            queue_peak=0, swaps=0,
        )

    # -- recording (engine thread + admission-side client threads) -----------
    def actor_fired(self, name: str, fires: int, time_ns: int) -> None:
        with self._lock:
            for d in (self._win, self.totals):
                d["actor_fires"][name] = (
                    d["actor_fires"].get(name, 0) + fires
                )
                d["actor_time_ns"][name] = (
                    d["actor_time_ns"].get(name, 0) + time_ns
                )

    def link_moved(self, key: ChannelKey, tokens: int) -> None:
        if not tokens:
            return
        with self._lock:
            for d in (self._win, self.totals):
                d["channel_tokens"][key] = (
                    d["channel_tokens"].get(key, 0) + tokens
                )

    def device_dispatched(
        self, lanes: int, tokens_in: int, time_ns: int = 0, width: int = 0
    ) -> None:
        with self._lock:
            for d in (self._win, self.totals):
                d["device_dispatches"] += 1
                d["device_lanes"] += lanes
                d["device_width"] += width or lanes
                if lanes > d["lanes_peak"]:
                    d["lanes_peak"] = lanes
                d["device_tokens_in"] += tokens_in
                d["device_time_ns"] += time_ns

    def device_retired(self, tokens_out: int, time_ns: int) -> None:
        with self._lock:
            for d in (self._win, self.totals):
                d["device_tokens_out"] += tokens_out
                d["device_time_ns"] += time_ns

    def count(self, what: str, n: int = 1) -> None:
        with self._lock:
            for d in (self._win, self.totals):
                d[what] += n

    def submitted(self, chunks: int, tokens: int, split: int = 0) -> None:
        """One admission event, both counters under ONE lock acquisition.

        Client threads report submissions; two separate ``count()`` calls
        would let a concurrent ``snapshot()`` land *between* them and split
        one submission across windows (chunks in the drained window, its
        tokens in the next) — a per-window invariant violation the online
        repartitioner would read as a traffic anomaly.  ``split`` counts
        submissions larger than the admission chunk that were broken up."""
        with self._lock:
            for d in (self._win, self.totals):
                d["chunks_submitted"] += chunks
                d["tokens_submitted"] += tokens
                d["chunks_split"] += split

    def queue_depth(self, depth: int) -> None:
        with self._lock:
            for d in (self._win, self.totals):
                if depth > d["queue_peak"]:
                    d["queue_peak"] = depth

    def swapped(self, detail: Dict) -> None:
        self.count("swaps")
        self.swap_log.append(dict(detail, at=time.perf_counter()))

    # -- reader side --------------------------------------------------------
    def _freeze(self, d: Dict, seconds: float) -> TelemetrySnapshot:
        return TelemetrySnapshot(
            seconds=seconds,
            actor_fires=dict(d["actor_fires"]),
            actor_time_ns=dict(d["actor_time_ns"]),
            channel_tokens=dict(d["channel_tokens"]),
            **{
                k: d[k]
                for k in (
                    "device_dispatches", "device_lanes", "device_width",
                    "lanes_peak", "device_time_ns",
                    "device_tokens_in", "device_tokens_out",
                    "sessions_opened", "sessions_closed",
                    "chunks_submitted", "chunks_split", "tokens_submitted",
                    "tokens_delivered", "queue_peak", "swaps",
                )
            },
        )

    def snapshot(self) -> TelemetrySnapshot:
        """Drain and return the current window."""
        with self._lock:
            now = time.perf_counter()
            snap = self._freeze(self._win, now - self._win_start)
            self._win = self._zero()
            self._win_start = now
        return snap

    def lifetime(self) -> TelemetrySnapshot:
        """Everything since the server started (windows are unaffected)."""
        with self._lock:
            return self._freeze(
                self.totals, time.perf_counter() - self.started
            )
