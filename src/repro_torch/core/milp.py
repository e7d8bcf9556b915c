"""Partitioning solvers for the MILP formulation (paper §III-F).

The decision variables d_p^a assign each actor to exactly one partition; the
objective is ``cost_model.evaluate`` (equations 1–10).  No industrial MILP solver
ships in this container, so three solvers cover the regimes:

  * solve_exact   — full enumeration (small graphs; ground truth for tests),
  * solve_bb      — branch & bound with the admissible bound max-partition-load
                    (T_exec ≥ max_p T_p since comm terms are nonnegative),
  * solve_anneal  — simulated annealing with single-reassignment moves
                    (large graphs; validated against exact on small instances),
  * solve_chain_dp — optimal *contiguous* partitioning of a chain
                    (LM layer stacks; the pipeline-stage assignment problem).

``solve`` picks automatically.  A multi-objective wrapper implements §V-C:
minimize T + α·R where R charges device resource use.
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import NetworkProfile, evaluate


@dataclass
class Solution:
    assignment: Dict[str, str]
    objective: float
    detail: Dict[str, float]
    solver: str


def _accel_set(accel) -> frozenset:
    return frozenset((accel,)) if isinstance(accel, str) else frozenset(accel)


def _objective(
    graph, assignment, prof, accel, alpha: float,
    resource: Optional[Callable[[str], float]],
    capacity: Optional[int] = None,
) -> Tuple[float, Dict[str, float]]:
    accels = _accel_set(accel)
    if capacity is not None:
        # per-accelerator capacity: a partition (sub-mesh) only fits so many
        # actors' worth of synthesized logic — overfull placements are
        # infeasible, which is what pushes the DSE toward k-way splits
        load: Dict[str, int] = {}
        for a, p in assignment.items():
            if p in accels:
                load[p] = load.get(p, 0) + 1
        if any(n > capacity for n in load.values()):
            return math.inf, {"T_exec": math.inf, "infeasible": 1.0}
    detail = evaluate(graph, assignment, prof, accel=accels)
    obj = detail["T_exec"]
    if alpha:
        r = sum(
            (resource(a) if resource else 1.0)
            for a, p in assignment.items()
            if p in accels
        )
        obj = obj + alpha * r
        detail["resource"] = r
    return obj, detail


def _placeable(graph, actor: str, partition: str, accel) -> bool:
    if partition in _accel_set(accel) and not graph.actors[actor].device_ok:
        return False
    return True


def solve_exact(
    graph, prof: NetworkProfile, partitions: Sequence[str],
    *, accel="accel", alpha: float = 0.0, resource=None,
    capacity: Optional[int] = None, limit: int = 400_000,
) -> Solution:
    actors = sorted(graph.actors)
    n_combo = len(partitions) ** len(actors)
    assert n_combo <= limit, f"exact solver: {n_combo} combos > {limit}"
    best, best_obj, best_detail = None, math.inf, {}
    for combo in itertools.product(partitions, repeat=len(actors)):
        asg = dict(zip(actors, combo))
        if any(not _placeable(graph, a, p, accel) for a, p in asg.items()):
            continue
        obj, detail = _objective(
            graph, asg, prof, accel, alpha, resource, capacity
        )
        if obj < best_obj:
            best, best_obj, best_detail = asg, obj, detail
    return Solution(best, best_obj, best_detail, "exact")


def solve_bb(
    graph, prof: NetworkProfile, partitions: Sequence[str],
    *, accel="accel", alpha: float = 0.0, resource=None,
    capacity: Optional[int] = None,
) -> Solution:
    """DFS branch & bound.  Bound: max current partition load (admissible —
    each accelerator partition's lane load is its max member hw time, and
    software loads use ``prof.sw_bound`` — the fused host rate when known —
    since the evaluator may charge co-located fusable actors the cheaper
    fused coefficient; bounding with the interpreted rate could prune the
    optimum)."""
    accels = _accel_set(accel)
    actors = sorted(
        graph.actors,
        key=lambda a: -max(prof.exec_sw.get(a, 0), prof.exec_hw.get(a, 0)),
    )
    best: List = [None, math.inf, {}]
    loads = {p: 0.0 for p in partitions if p not in accels}
    hw_max = {p: 0.0 for p in partitions if p in accels}
    hw_count = {p: 0 for p in hw_max}
    asg: Dict[str, str] = {}

    def bound() -> float:
        return max(
            max(loads.values(), default=0.0),
            max(hw_max.values(), default=0.0),
        )

    def dfs(i: int):
        if i == len(actors):
            obj, detail = _objective(
                graph, asg, prof, accel, alpha, resource, capacity
            )
            if obj < best[1]:
                best[0], best[1], best[2] = dict(asg), obj, detail
            return
        a = actors[i]
        for p in partitions:
            if not _placeable(graph, a, p, accel):
                continue
            if p in accels:
                if capacity is not None and hw_count[p] >= capacity:
                    continue
                prev_hw = hw_max[p]
                hw_max[p] = max(hw_max[p], prof.exec_hw.get(a, math.inf))
                hw_count[p] += 1
            else:
                loads[p] += prof.sw_bound(a)
            if bound() < best[1]:
                asg[a] = p
                dfs(i + 1)
                del asg[a]
            if p in accels:
                hw_max[p] = prev_hw
                hw_count[p] -= 1
            else:
                loads[p] -= prof.sw_bound(a)

    dfs(0)
    return Solution(best[0], best[1], best[2], "bb")


def solve_anneal(
    graph, prof: NetworkProfile, partitions: Sequence[str],
    *, accel="accel", alpha: float = 0.0, resource=None,
    capacity: Optional[int] = None,
    iters: int = 20_000, seed: int = 0, restarts: int = 3,
) -> Solution:
    rng = random.Random(seed)
    actors = sorted(graph.actors)
    partitions = list(partitions)

    def rand_assignment() -> Dict[str, str]:
        asg = {}
        for a in actors:
            opts = [p for p in partitions if _placeable(graph, a, p, accel)]
            asg[a] = rng.choice(opts)
        return asg

    best, best_obj, best_detail = None, math.inf, {}
    for r in range(restarts):
        asg = rand_assignment()
        obj, detail = _objective(
            graph, asg, prof, accel, alpha, resource, capacity
        )
        cur_obj = obj
        t0 = max(cur_obj, 1e-12)
        for it in range(iters):
            a = rng.choice(actors)
            opts = [
                p for p in partitions
                if p != asg[a] and _placeable(graph, a, p, accel)
            ]
            if not opts:
                continue
            p_new = rng.choice(opts)
            old = asg[a]
            asg[a] = p_new
            obj2, detail2 = _objective(
                graph, asg, prof, accel, alpha, resource, capacity
            )
            temp = t0 * (1.0 - it / iters) * 0.1 + 1e-15
            if obj2 <= cur_obj or rng.random() < math.exp(
                (cur_obj - obj2) / temp
            ):
                cur_obj = obj2
                if obj2 < best_obj:
                    best, best_obj, best_detail = dict(asg), obj2, detail2
            else:
                asg[a] = old
        if cur_obj < best_obj and best is None:
            best, best_obj, best_detail = dict(asg), cur_obj, detail
    return Solution(best, best_obj, best_detail, "anneal")


def solve_chain_dp(
    names: Sequence[str],
    exec_time: Dict[str, float],
    boundary_cost: Callable[[int], float],
    k_stages: int,
) -> Tuple[List[int], float]:
    """Optimal contiguous split of a chain into ≤ k stages.

    Minimizes max over stages of (stage work + incoming boundary transfer) —
    pipeline steady-state throughput.  boundary_cost(i) = cost of the channel
    entering element i from element i-1.  Returns (stage id per element, T).
    """
    n = len(names)
    pre = [0.0]
    for a in names:
        pre.append(pre[-1] + exec_time[a])

    def seg(i: int, j: int) -> float:  # work of [i, j)
        w = pre[j] - pre[i]
        if i > 0:
            w += boundary_cost(i)
        return w

    INF = math.inf
    dp = [[INF] * (k_stages + 1) for _ in range(n + 1)]
    arg = [[-1] * (k_stages + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for j in range(1, n + 1):
        for k in range(1, k_stages + 1):
            for i in range(j):
                if dp[i][k - 1] is INF:
                    continue
                cand = max(dp[i][k - 1], seg(i, j))
                if cand < dp[j][k]:
                    dp[j][k] = cand
                    arg[j][k] = i
    k_best = min(range(1, k_stages + 1), key=lambda k: dp[n][k])
    stages = [0] * n
    j, k = n, k_best
    bounds = []
    while j > 0:
        i = arg[j][k]
        bounds.append((i, j))
        j, k = i, k - 1
    for s, (i, j2) in enumerate(reversed(bounds)):
        for t in range(i, j2):
            stages[t] = s
    return stages, dp[n][k_best]


def solve(
    graph, prof: NetworkProfile, partitions: Sequence[str],
    *, accel="accel", alpha: float = 0.0, resource=None,
    capacity: Optional[int] = None, time_budget: str = "auto",
) -> Solution:
    n = len(graph.actors)
    combos = len(partitions) ** n
    kw = dict(
        accel=accel, alpha=alpha, resource=resource, capacity=capacity
    )
    if combos <= 200_000:
        return solve_exact(graph, prof, partitions, **kw)
    if n <= 14:
        return solve_bb(graph, prof, partitions, **kw)
    return solve_anneal(graph, prof, partitions, **kw)
