"""Design-space exploration (paper §V-B): sweep thread counts × accelerator use,
solve the MILP at each point, emit XCFs.

Two front-ends:
  * ``explore``     — generic actor graphs with measured profiles (the paper's
                      JPEG/MPEG study, reproduced on this host's benchmarks),
  * ``explore_lm``  — LM layer chains on TPU sub-meshes: the pipeline-stage
                      assignment problem solved with the optimal chain DP; the
                      'accelerator boundary' is the ICI/DCN stage crossing.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Dict, List, Optional, Sequence, Tuple


from repro_torch.core.cost_model import (
    LinkModel,
    NetworkProfile,
    lm_layer_profile,
)
from repro_torch.core.graph import ActorGraph, GraphError
from repro_torch.core.milp import Solution, solve, solve_chain_dp
from repro_torch.core.xcf import XCF, make_xcf
from repro_torch.ir.passes import legalize_xcf


@dataclass
class DesignPoint:
    n_threads: int
    use_accel: bool
    solution: Solution
    xcf: XCF
    accel_ids: Tuple[str, ...] = ("accel",)

    @property
    def predicted(self) -> float:
        return self.solution.objective

    @property
    def n_accels(self) -> int:
        return len(self.accel_ids) if self.use_accel else 0

    def hw_actors(self) -> List[str]:
        return sorted(
            a for a, p in self.solution.assignment.items()
            if p in self.accel_ids
        )


def explore(
    graph: ActorGraph,
    prof: NetworkProfile,
    *,
    thread_counts: Sequence[int] = (1, 2, 3, 4),
    accel_options: Sequence = (False, True),  # bool | int accel counts
    alpha: float = 0.0,
    accel: str = "accel",
    accel_capacity: Optional[int] = None,
    megastep_k: Optional[int] = None,
) -> List[DesignPoint]:
    """Sweep thread counts × accelerator-partition counts, solve the MILP at
    each point, emit legalized XCFs.

    ``accel_options`` entries are accelerator-partition counts (``False`` →
    0, ``True`` → 1, any int k → k device partitions named ``accel0..``).
    ``accel_capacity`` bounds the actors per device partition (the
    per-accelerator resource term) — what makes a k-way split win over one
    overfull partition.  ``megastep_k`` overrides ``prof.megastep_k`` — the
    launches-amortization factor the evaluator's PLink terms divide the
    boundary latency by (``Program.explore`` sets it from its compile
    options).
    """
    if megastep_k is not None:
        prof.megastep_k = max(1, int(megastep_k))
    points: List[DesignPoint] = []
    any_device = any(a.device_ok for a in graph)
    for n in thread_counts:
        for opt in accel_options:
            k = int(opt)
            if k and not any_device:
                continue
            accel_ids = (
                [accel] if k == 1 else [f"{accel}{i}" for i in range(k)]
            )
            partitions = [f"t{i}" for i in range(n)] + (
                accel_ids if k else []
            )
            sol = solve(
                graph, prof, partitions,
                accel=accel_ids if k else accel, alpha=alpha,
                capacity=accel_capacity if k else None,
            )
            if sol.assignment is None:
                continue
            xcf = make_xcf(
                graph.name, sol.assignment, accel=accel_ids,
                meta={
                    "predicted_T": sol.objective,
                    "n_threads": n,
                    "n_accels": k,
                },
            )
            # Every emitted XCF must pass the middle-end's placement
            # legalization — the same pass ``repro_torch.compile`` runs — so a
            # solver bug can never hand the runtimes an illegal placement.
            try:
                legalize_xcf(graph, xcf)
            except GraphError as e:  # pragma: no cover - solver invariant
                raise GraphError(
                    f"partitioner produced an illegal placement for "
                    f"{graph.name!r} (threads={n}, accels={k}): {e}"
                ) from e
            points.append(
                DesignPoint(n, bool(k), sol, xcf, tuple(accel_ids))
            )
    return points


def best_point(points: Sequence[DesignPoint]) -> DesignPoint:
    return min(points, key=lambda p: p.predicted)


def pareto(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Pareto frontier over (n_threads + accel_cost, predicted time)."""

    def res(p: DesignPoint) -> int:
        return p.n_threads + 8 * p.n_accels

    out = []
    for p in points:
        if not any(
            res(q) <= res(p) and q.predicted < p.predicted for q in points
        ):
            out.append(p)
    return sorted(out, key=lambda p: p.predicted)


# ---------------------------------------------------------------------------
# LM pipeline partitioning (TPU application)
# ---------------------------------------------------------------------------


@dataclass
class LMPipelinePlan:
    arch: str
    num_stages: int
    chips_per_stage: int
    stage_of_layer: List[int]  # per actor in chain order (embed..blocks..head)
    bottleneck_s: float
    names: List[str]

    def stage_map(self) -> Dict[str, int]:
        return dict(zip(self.names, self.stage_of_layer))


def explore_lm(
    cfg,
    *,
    seq_len: int = 4096,
    global_batch: int = 256,
    total_chips: int = 256,
    stage_options: Sequence[int] = (1, 2, 4, 8),
    inter_stage: Optional[LinkModel] = None,
    train: bool = True,
    mfu: float = 0.4,
) -> List[LMPipelinePlan]:
    """Pipeline-stage DSE for an LM chain: for each stage count, split the layer
    chain optimally (chain DP) across equal sub-meshes and report the pipeline
    bottleneck time — the LM instantiation of the paper's partitioning."""
    plans: List[LMPipelinePlan] = []
    for k in stage_options:
        if total_chips % k:
            continue
        chips = total_chips // k
        names, prof = lm_layer_profile(
            cfg, seq_len=seq_len, global_batch=global_batch,
            chips_per_stage=chips, train=train, mfu=mfu,
        )
        link = inter_stage or prof.links["ici"]

        def boundary(i: int) -> float:
            key = (names[i - 1], "OUT", names[i], "IN")
            n = prof.tokens.get(key, 0)
            return link.tau(n, prof.buffers.get(key, n or 1))

        stages, T = solve_chain_dp(names, prof.exec_hw, boundary, k)
        plans.append(
            LMPipelinePlan(cfg.name, k, chips, stages, T, list(names))
        )
    return plans
