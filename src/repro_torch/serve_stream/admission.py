"""Admission control — who gets the next batch lanes.

The continuous batcher launches at most ``max_batch`` lanes per round; at
production scale (O(1000) sessions over 32 lanes) *which* sessions ride is
the whole SLO story.  The engine orders each round's candidates with
``DeficitRoundRobin``:

  * **round-robin rotation** — candidates are ordered least-recently-
    scheduled first, so every ready session gets a lane within
    ``ceil(ready / max_batch)`` rounds of becoming ready.  Starvation-free
    by construction: a session's wait is bounded by the rotation length,
    not by how much anyone else submits.
  * **deficit tiebreak** — among equally-recent candidates, the session
    with the least attained service (total tokens staged to the device)
    goes first.  A huge submission — already split into admission-sized
    chunks by ``StreamSession.submit`` — accumulates service and
    automatically yields lanes to lighter streams, instead of occupying
    the batch until it drains.
  * **TTFO boost** — sessions still awaiting their *first* output whose
    wait already exceeds the live p95 of the server's TTFO histogram jump
    the rotation.  This closes the loop between the SLO metrics
    (``serve_ttfo_seconds``) and the scheduler: the histogram is not just
    reported, it shapes the tail it measures.

The scheduler is engine-thread-only state; the engine charges it after
every launch and forgets sessions when they finish.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class DeficitRoundRobin:
    """Fairness ordering over ``(session, stage)`` launch candidates."""

    def __init__(self, boost_ttfo: bool = True):
        self.boost_ttfo = boost_ttfo
        self._last_round: Dict[int, int] = {}   # sid -> last scheduled round
        self._served: Dict[int, int] = {}       # sid -> tokens staged so far

    # -- engine bookkeeping ---------------------------------------------------
    def charge(self, sid: int, tokens: int, round_no: int) -> None:
        """Record one session's share of a launched round."""
        self._served[sid] = self._served.get(sid, 0) + tokens
        self._last_round[sid] = round_no

    def forget(self, sid: int) -> None:
        """Drop a finished session's state (keeps the maps O(live))."""
        self._last_round.pop(sid, None)
        self._served.pop(sid, None)

    def served(self, sid: int) -> int:
        return self._served.get(sid, 0)

    # -- ordering -------------------------------------------------------------
    def order(
        self,
        candidates: List[Tuple[object, object]],  # (session, stage)
        *,
        now_ns: int,
        ttfo_p95_s: Optional[float] = None,
    ) -> List[Tuple[object, object]]:
        """Fairness order for one round's launch candidates.

        ``ttfo_p95_s`` is the live 95th percentile of the server's TTFO
        histogram (None or 0 when it has no samples yet): a session that
        submitted, has delivered nothing, and has already waited past it
        outranks the whole rotation — the scheduler spends lanes where the
        tail latency is being made.
        """

        def key(cand):
            s, _stage = cand
            urgent = 1
            if (
                self.boost_ttfo
                and ttfo_p95_s
                and s.first_delivery_ns is None
                and s.first_submit_ns is not None
                and (now_ns - s.first_submit_ns) / 1e9 > ttfo_p95_s
            ):
                urgent = 0
            return (
                urgent,
                self._last_round.get(s.sid, -1),
                self._served.get(s.sid, 0),
                s.sid,
            )

        return sorted(candidates, key=key)
