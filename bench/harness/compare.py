"""The numbers that decide ``correct``, each computed the same way for the
program's run and for the control."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch

from bench.harness.weights import leaf_tensors


def leaf_norms(flat: Dict[str, torch.Tensor], model: dict) -> Dict[str, float]:
    """The float32 norm of every leaf, each layer of a stacked leaf its own."""
    leaves = leaf_tensors(flat, model)
    norms = torch.stack([torch.linalg.vector_norm(t.detach().float()) for t in leaves.values()])
    return dict(zip(leaves, norms.tolist()))


def norm_gaps(got: Dict[str, float], ref: Dict[str, float],
              counted: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap between its norm in ``got`` and in ``ref``, over the
    reference's norm of that leaf or of the median leaf, whichever is larger
    (some leaves' norms are all but zero); non-finite gaps read infinite."""
    names = list(ref) if counted is None else list(counted)
    if set(got) != set(ref):
        return {"(leaves differ)": math.inf}
    median = statistics.median(ref.values())
    gaps = {n: abs(got[n] - ref[n]) / max(ref[n], median, 1e-30) for n in names}
    return {n: g if math.isfinite(g) else math.inf for n, g in gaps.items()}


def worst_norm_gap(got: Dict[str, float], ref: Dict[str, float],
                   counted: Optional[Iterable[str]] = None) -> float:
    """The largest of :func:`norm_gaps`: the worst leaf."""
    return max(norm_gaps(got, ref, counted).values(), default=0.0)


def median_norm_gap(got: Dict[str, float], ref: Dict[str, float]) -> float:
    """The median of :func:`norm_gaps`: the median leaf, steady from seed to
    seed where the worst leaf is one small leaf's noise."""
    return statistics.median(norm_gaps(got, ref).values())


def moved_leaves(grad_norms: Dict[str, float]) -> list:
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's.  Others move under Adam by round-off
    alone, so the change compares only these."""
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= 1e-3 * median]


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in float32."""
    got, ref = got.float(), ref.float()
    den = torch.linalg.vector_norm(ref)
    return float(torch.linalg.vector_norm(got - ref) / torch.clamp(den, min=1e-30))
