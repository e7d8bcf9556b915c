"""Diagnostic framework for streamcheck (compile-time dataflow verification).

Every finding the analysis suite produces flows through one structure: a
``Diagnostic`` with a stable ``SB###`` code, a severity, a human-actionable
message, and the actors/channels it is about (plus authoring provenance when
the frontend recorded it).  The collection lives in
``module.meta["diagnostics"]`` so it rides along with the IR — rendered by
``ir_dump()``, returned by ``Program.check()``, and enforced by
``repro_torch.ir.passes.lower`` according to the ``check=`` policy.

Stable code catalog (see docs/analysis.md for the full semantics):

  errors (reject the program under ``check=True``):
    SB101  inconsistent SDF rates — the balance equations have no solution
    SB102  sure deadlock — one repetition-vector iteration cannot complete
           against the resolved FIFO depths (undersized cycle/reconvergence
           buffers, or a token-free static cycle)
    SB103  undersized channel — a FIFO smaller than one firing's token need
           (or one staging granule on a device boundary) can never be
           satisfied
    SB104  block smaller than a device staging quantum — a whole region
           iteration must fit in one staged block

  warnings (reported, never rejected):
    SB201  dead actors surviving eliminate-dead (kept only to keep live
           outputs wired; they can never affect an observable output)
    SB202  dynamic-rate actor splitting a would-be-fused device region
    SB203  chatty device boundary — more crossing channels than member
           actors (a placement the MILP would never pick)
    SB204  unbounded backlog — a channel whose consumer never consumes
           from the destination port in any action
    SB205  sinkless network — quiescence-run entry points never terminate
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

from repro_torch.core.graph import GraphError

__all__ = ["Diagnostic", "Diagnostics", "AnalysisError", "CODES"]

CODES: Dict[str, str] = {
    "SB101": "inconsistent SDF rates (balance equations unsolvable)",
    "SB102": "sure deadlock (iteration cannot complete at resolved depths)",
    "SB103": "channel depth smaller than one firing / staging granule",
    "SB104": "block smaller than a device staging quantum",
    "SB201": "dead actors surviving eliminate-dead",
    "SB202": "dynamic-rate actor splits a would-be-fused device region",
    "SB203": "chatty device partition boundary",
    "SB204": "unbounded backlog channel (consumer never drains the port)",
    "SB205": "sinkless network never quiesces",
    "SB206": "crossing FIFO too shallow for the megastep target (k clamps)",
}

ERROR = "error"
WARNING = "warning"


@dataclass(frozen=True)
class Diagnostic:
    """One finding: a stable code, a severity, and its subjects."""

    code: str
    severity: str  # "error" | "warning"
    message: str
    actors: Tuple[str, ...] = ()
    channels: Tuple[str, ...] = ()
    origin: str = ""  # "file:line" where the first named actor was authored

    def __post_init__(self):
        assert self.code in CODES, f"unknown diagnostic code {self.code!r}"
        assert self.severity in (ERROR, WARNING), self.severity

    def __str__(self) -> str:
        where = f" [{self.origin}]" if self.origin else ""
        return f"{self.code} {self.severity}: {self.message}{where}"


class Diagnostics:
    """An ordered collection of findings for one lowered module."""

    def __init__(self, origins: Dict[str, str] = None):
        self._items: List[Diagnostic] = []
        # actor -> "file:line", threaded from the frontend DSL
        self.origins: Dict[str, str] = dict(origins or {})

    # -- emission ------------------------------------------------------------
    def _origin_of(self, actors: Sequence[str]) -> str:
        for a in actors:
            o = self.origins.get(a)
            if o:
                return o
        return ""

    def emit(
        self,
        code: str,
        severity: str,
        message: str,
        *,
        actors: Sequence[str] = (),
        channels: Sequence[str] = (),
    ) -> Diagnostic:
        d = Diagnostic(
            code=code,
            severity=severity,
            message=message,
            actors=tuple(actors),
            channels=tuple(str(c) for c in channels),
            origin=self._origin_of(actors),
        )
        self._items.append(d)
        return d

    def error(self, code: str, message: str, **kw) -> Diagnostic:
        return self.emit(code, ERROR, message, **kw)

    def warn(self, code: str, message: str, **kw) -> Diagnostic:
        return self.emit(code, WARNING, message, **kw)

    def extend(self, other: "Diagnostics") -> None:
        self._items.extend(other)

    # -- queries -------------------------------------------------------------
    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self._items if d.severity == ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self._items if d.severity == WARNING]

    @property
    def has_errors(self) -> bool:
        return any(d.severity == ERROR for d in self._items)

    def codes(self) -> List[str]:
        return [d.code for d in self._items]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self._items if d.code == code]

    def __iter__(self) -> Iterator[Diagnostic]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    # -- rendering -----------------------------------------------------------
    def render(self) -> str:
        if not self._items:
            return "no findings"
        return "\n".join(str(d) for d in self._items)

    def __repr__(self) -> str:
        return (
            f"Diagnostics({len(self.errors)} errors, "
            f"{len(self.warnings)} warnings)"
        )


class AnalysisError(GraphError):
    """A streamcheck rejection: the program has error-severity findings.

    Subclasses ``GraphError`` so existing ``except GraphError`` placement
    handling (partitioner DSE, conformance harnesses, tests) keeps working —
    a statically-rejected network is an invalid placement like any other,
    just caught earlier and with stable codes attached.
    """

    def __init__(self, module_name: str, diagnostics: Diagnostics):
        self.diagnostics = diagnostics
        errs = diagnostics.errors
        lines = "\n".join(f"  {d}" for d in errs)
        super().__init__(
            f"{module_name}: streamcheck rejected the program with "
            f"{len(errs)} error(s):\n{lines}\n"
            f"(compile with check='warn' to proceed anyway, check=False to "
            f"skip analysis; see docs/analysis.md for the code catalog)"
        )

    @property
    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics.errors]
