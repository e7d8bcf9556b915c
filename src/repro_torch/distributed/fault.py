"""Fault tolerance and elasticity for the training loop.

Mechanisms (designed for 1000+ nodes, exercised here with simulated failures):

  * checkpoint/restart — the supervisor wraps the step loop; any step exception
    (a real XLA device error, or an injected ``SimulatedFailure``) triggers a
    restore from the last complete checkpoint and a retry with a bounded budget.
  * elastic re-mesh — checkpoints are mesh-agnostic (gathered arrays), so a
    restart may build a *different* mesh/rules (fewer healthy pods) and restore
    into it; ``remesh_restore`` re-shards every leaf onto the new sharding.
  * straggler mitigation — per-step wall times feed an EWMA watchdog; steps
    slower than ``threshold×`` the EWMA are counted and surfaced (on a real
    cluster this signal drives hot-spare swaps; here it is logged and tested
    with artificial delays).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.runtime.chaos import InjectedFault


class SimulatedFailure(InjectedFault):
    """Injected node failure (tests / chaos drills).

    Part of the :mod:`repro_torch.runtime.chaos` fault taxonomy so handlers can
    treat train-loop drills and serve-mode injections uniformly; the
    message-only constructor is kept for callers that raise it by hand."""

    def __init__(self, message: str = "simulated node failure"):
        RuntimeError.__init__(self, message)
        self.site = "train:step"
        self.occurrence = 0
        self.rule = None


@dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    alpha: float = 0.2
    ewma_s: float = 0.0
    events: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma_s == 0.0:
            self.ewma_s = dt
            return False
        slow = dt > self.threshold * self.ewma_s
        if slow:
            self.events.append(step)
        # EWMA tracks the healthy population (don't poison it with stragglers)
        if not slow:
            self.ewma_s = (1 - self.alpha) * self.ewma_s + self.alpha * dt
        return slow


@dataclass
class SupervisorReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_events: int = 0
    final_metrics: Dict[str, float] = field(default_factory=dict)


class TrainSupervisor:
    """Fault-tolerant step-loop driver.

    step_fn(state, step_idx) -> (state, metrics); state is the full pytree
    (params, opt state, ...).  make_initial_state() builds a fresh state;
    state_like/shardings describe the restore target (possibly on a new mesh).
    """

    def __init__(
        self,
        step_fn: Callable,
        make_initial_state: Callable[[], Any],
        ckpt_dir,
        *,
        ckpt_every: int = 10,
        max_restarts: int = 5,
        shardings: Any = None,
        watchdog: Optional[StragglerWatchdog] = None,
    ):
        self.step_fn = step_fn
        self.make_initial_state = make_initial_state
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.shardings = shardings
        self.watchdog = watchdog or StragglerWatchdog()

    def _restore_or_init(self):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return self.make_initial_state(), 0
        state = self.make_initial_state()
        restored, _ = restore(
            self.ckpt_dir, step, state, shardings=self.shardings
        )
        return restored, step

    def run(self, total_steps: int) -> SupervisorReport:
        report = SupervisorReport()
        restarts = 0
        while True:
            state, start = self._restore_or_init()
            try:
                for i in range(start, total_steps):
                    t0 = time.perf_counter()
                    state, metrics = self.step_fn(state, i)
                    dt = time.perf_counter() - t0
                    if self.watchdog.observe(i, dt):
                        report.straggler_events += 1
                    done = i + 1
                    if done % self.ckpt_every == 0 or done == total_steps:
                        self.ckpt.save(done, state, extra={"step": done})
                    report.steps_done = done
                    report.final_metrics = {
                        k: float(v) for k, v in metrics.items()
                    }
                self.ckpt.wait()
                report.restarts = restarts
                return report
            except SimulatedFailure:
                restarts += 1
                self.ckpt.wait()
                if restarts > self.max_restarts:
                    raise
                continue
