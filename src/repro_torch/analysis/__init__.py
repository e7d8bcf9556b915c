"""streamcheck: compile-time dataflow verification over the lowered IR.

The analyses run as pass-pipeline stages (``analyze-rates`` and
``streamcheck`` in ``repro_torch.ir.passes``), on by default in ``repro_torch.compile``;
``Program.check()`` and ``python -m repro_torch.analysis`` expose the same suite
interactively.  See docs/analysis.md for the ``SB###`` code catalog and the
exact semantics of each analysis.

Orchestration entry points:

- :func:`run_rate_analysis` — solve the SDF balance equations, store the
  repetition vector in ``module.meta["repetition"]``, and (re)initialize
  ``module.meta["diagnostics"]``.
- :func:`run_streamcheck` — deadlock simulation, buffer/block sufficiency,
  and the boundedness/liveness/placement lints; extends the module's
  diagnostics in place.
- :func:`check_module` — both stages, fresh; what ``Program.check()`` and
  the CLI call.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import (
    CODES,
    AnalysisError,
    Diagnostic,
    Diagnostics,
)
from repro_torch.analysis.deadlock import check_deadlock, simulate_iteration
from repro_torch.analysis.lints import check_block, check_buffers, run_lints
from repro_torch.analysis.rates import (
    member_rates,
    port_member,
    region_repetition,
    repetition_vector,
    solve_rates,
)

__all__ = [
    "CODES",
    "AnalysisError",
    "Diagnostic",
    "Diagnostics",
    "check_deadlock",
    "simulate_iteration",
    "check_block",
    "check_buffers",
    "run_lints",
    "member_rates",
    "port_member",
    "region_repetition",
    "repetition_vector",
    "solve_rates",
    "run_rate_analysis",
    "run_streamcheck",
    "check_module",
]


def run_rate_analysis(module) -> Diagnostics:
    """Stage 1: balance equations.  Stores ``meta["repetition"]`` (fires per
    iteration, minimal per static component) and resets the module's
    diagnostics collection; emits ``SB101`` when the system is
    inconsistent."""
    q, diags = solve_rates(module)
    if q is not None:
        module.meta["repetition"] = q
    module.meta["diagnostics"] = diags
    return diags


def run_streamcheck(module, block: int = 1024, megastep_k=None) -> Diagnostics:
    """Stage 2: deadlock simulation (SB102), buffer sufficiency (SB103),
    staging-granule-vs-block (SB104) + megastep depth sufficiency (SB206),
    and the SB2xx lints.  Extends the diagnostics started by
    :func:`run_rate_analysis` (running it first if needed) and returns the
    full collection.  ``megastep_k`` defaults to the lowered module's
    ``meta["megastep"]`` target (1 when depth inference has not run)."""
    diags = module.meta.get("diagnostics")
    if diags is None:
        diags = run_rate_analysis(module)
    if megastep_k is None:
        megastep_k = module.meta.get("megastep", 1)
    repetition = module.meta.get("repetition")
    diags.extend(check_deadlock(module, repetition))
    diags.extend(check_buffers(module))
    diags.extend(check_block(module, block, megastep_k=megastep_k))
    diags.extend(run_lints(module))
    return diags


def check_module(module, block: int = 1024, megastep_k=None) -> Diagnostics:
    """Run the full suite from scratch (idempotent: prior findings are
    discarded, not duplicated)."""
    run_rate_analysis(module)
    return run_streamcheck(module, block=block, megastep_k=megastep_k)
