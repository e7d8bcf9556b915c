"""Online profile-guided repartitioning.

The offline flow (§III-E, §V-B) profiles once, solves the placement MILP
once, and deploys the winner.  A long-lived server can do better: its
telemetry *is* a rolling profile of the real traffic, so this module
periodically re-solves the same MILP (``core.milp`` via
``core.partitioner.explore``) against ``profile_from_telemetry`` and, when
the predicted-best placement differs from the one being served, hands the
engine an XCF to hot-swap at the next drained chunk boundary.

The loop is deliberately conservative:

  * it never solves before ``min_window_s`` of traffic has accumulated
    (early windows are dominated by warm-up jitter);
  * it requires the predicted win to beat ``min_gain`` (relative) before
    proposing a swap — a swap drains the pipelines, so near-ties are noise;
  * the MILP runs on the engine thread between rounds, so solve time is
    bounded by the same small-graph solvers the offline path uses.

``base_profile`` seeds device/link numbers the live window cannot observe
(hw times of actors currently fused into one launch, link models); pass
``Program.profile()`` output, or leave None to let the repartitioner build
one lazily from its first window.
"""

from __future__ import annotations

import time
from typing import Sequence

from repro_torch.core.profiler import profile_from_telemetry


class OnlineRepartitioner:
    def __init__(
        self,
        *,
        interval_s: float = 2.0,
        min_window_s: float = 0.2,
        min_gain: float = 0.05,
        thread_counts: Sequence[int] = (1, 2),
        accel_options: Sequence[bool] = (False, True),
        base_profile=None,
        alpha: float = 0.0,
    ):
        self.interval_s = interval_s
        self.min_window_s = min_window_s
        self.min_gain = min_gain
        self.thread_counts = tuple(thread_counts)
        self.accel_options = tuple(accel_options)
        self.base_profile = base_profile
        self.alpha = alpha
        self.server = None
        self._last_solve = time.perf_counter()
        self.decisions = []  # (predicted_current, predicted_best, swapped)

    def bind(self, server) -> None:
        self.server = server

    # -- called by the engine between rounds ---------------------------------
    def maybe(self):
        """Return an XCF to swap to, or None.  Engine-thread only."""
        now = time.perf_counter()
        if now - self._last_solve < self.interval_s:
            return None
        self._last_solve = now
        snap = self.server.telemetry.snapshot()
        if snap.seconds < self.min_window_s or not snap.actor_fires:
            return None
        return self.propose(snap)

    def propose(self, snap):
        """Solve the MILP over one telemetry window; an XCF when the best
        placement beats the current one by ``min_gain``, else None."""
        from repro_torch.core.cost_model import evaluate
        from repro_torch.core.partitioner import best_point, explore

        program = self.server.program
        graph = program.graph
        prof = profile_from_telemetry(graph, snap, base=self.base_profile)
        points = explore(
            graph, prof,
            thread_counts=self.thread_counts,
            accel_options=self.accel_options,
            alpha=self.alpha,
        )
        if not points:
            return None
        best = best_point(points)
        current = evaluate(
            graph, program.xcf.assignment(), prof,
            accel=program.hw_partitions or "accel",
        )["T_exec"]
        swapped = (
            best.predicted < current * (1.0 - self.min_gain)
            and best.xcf.assignment() != program.xcf.assignment()
        )
        self.decisions.append((current, best.predicted, swapped))
        return best.xcf if swapped else None
