"""Typed dataflow IR — the compiler's middle-end representation.

The frontend (``repro_torch.frontend``) authors an ``ActorGraph``; the backends
(host scheduler, device codegen, PLink) execute *lowered IR*: an ``IRModule``
of rate-annotated actors, dtype/depth-annotated channels, and partition
regions.  The module is produced by a ``PassPipeline`` (see
``repro_torch.ir.passes``) so every placement decision, depth choice, and fusion is
an inspectable pass over this structure (``Program.ir_dump()``).

Mirrors the StreamBlocks middle-end (paper §III): CAL actors are lowered to
actor machines with known token rates, partitioned by the XCF, and only then
handed to per-platform code generators.

Copy of ``repro/ir/ir.py``.  Edit: the fused-actor ``codegen`` tags read
``"cuda" | "torch"`` (the reference's ``"pallas" | "jnp"``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core.actor import Actor, Port
from repro_torch.core.graph import ActorGraph, GraphError

__all__ = [
    "RateSig",
    "IRActor",
    "IRChannel",
    "Region",
    "IRModule",
    "connected_components",
]


def connected_components(
    nodes: Iterable[str], channels: Iterable["IRChannel"]
) -> Dict[str, str]:
    """Map each node to its component root under the channel edges whose
    endpoints both lie in ``nodes`` (path-compressed union-find).

    Shared by SDF-region detection (components of static actors inside one
    hw region) and the device staging plan (components of a partition, for
    lane-aligned staging) so the two can never drift on what "connected"
    means.
    """
    nodes = set(nodes)
    parent = {a: a for a in nodes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for ch in channels:
        if ch.src in nodes and ch.dst in nodes:
            parent[find(ch.src)] = find(ch.dst)
    return {a: find(a) for a in nodes}


@dataclass(frozen=True)
class RateSig:
    """Token rates of one actor: tokens consumed/produced per port per firing.

    ``static`` is True when every action agrees on the rates and carries no
    guard — the actor is SDF and a region of such actors can be fused into a
    single device kernel.  Dynamic (DDF) actors report the rates of their
    highest-priority action with ``static=False``.
    """

    consumes: Tuple[Tuple[str, int], ...]
    produces: Tuple[Tuple[str, int], ...]
    static: bool

    @classmethod
    def of(cls, actor: Actor) -> "RateSig":
        if not actor.actions:
            return cls((), (), False)
        a0 = actor.actions[0]
        return cls(
            tuple(sorted(a0.consumes.items())),
            tuple(sorted(a0.produces.items())),
            actor.is_sdf,
        )

    def consume_rate(self, port: str) -> int:
        return dict(self.consumes).get(port, 0)

    def produce_rate(self, port: str) -> int:
        return dict(self.produces).get(port, 0)

    def __str__(self) -> str:
        c = ", ".join(f"{p}:{n}" for p, n in self.consumes) or "-"
        p = ", ".join(f"{p}:{n}" for p, n in self.produces) or "-"
        kind = "sdf" if self.static else "ddf"
        return f"[{c} -> {p}] {kind}"


@dataclass
class IRActor:
    """One actor instance in the lowered module.

    ``impl`` is the executable ``repro_torch.core.actor.Actor`` (host firing
    functions + optional ``vector_fire``); fusion products synthesize a fresh
    ``impl`` whose ``vector_fire`` evaluates the whole region.
    """

    name: str
    inputs: List[Port]
    outputs: List[Port]
    rate: RateSig
    device_ok: bool
    host_only_reason: str
    impl: Actor
    fused_from: Tuple[str, ...] = ()  # non-empty for fusion products
    codegen: str = ""  # fused actors: "cuda" | "torch"

    @property
    def is_fused(self) -> bool:
        return bool(self.fused_from)

    def port(self, name: str) -> Port:
        for p in self.inputs + self.outputs:
            if p.name == name:
                return p
        raise GraphError(f"IR actor {self.name!r}: no port {name!r}")

    def describe(self) -> str:
        tags = []
        if not self.device_ok:
            tags.append(f"host-only({self.host_only_reason or '?'})")
        if self.is_fused:
            tags.append(f"fused<{self.codegen}>({', '.join(self.fused_from)})")
        return f"{self.name} {self.rate}" + (
            f"  {' '.join(tags)}" if tags else ""
        )


@dataclass
class IRChannel:
    """A typed channel with the full depth-resolution story attached.

    ``resolved_depth`` is what the runtimes allocate: the XCF-pinned size if
    any, else the authored depth, else the inferred depth from the depth
    pass.  No layer mutates the authored graph to communicate depths anymore.
    """

    src: str
    src_port: str
    dst: str
    dst_port: str
    dtype: str
    authored_depth: Optional[int] = None
    xcf_depth: Optional[int] = None
    inferred_depth: Optional[int] = None

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.src, self.src_port, self.dst, self.dst_port)

    @property
    def resolved_depth(self) -> Optional[int]:
        if self.xcf_depth is not None:
            return self.xcf_depth
        if self.authored_depth is not None:
            return self.authored_depth
        return self.inferred_depth

    def depth_source(self) -> str:
        if self.xcf_depth is not None:
            return "xcf"
        if self.authored_depth is not None:
            return "authored"
        if self.inferred_depth is not None:
            return "inferred"
        return "default"

    def __str__(self) -> str:
        return f"{self.src}.{self.src_port}->{self.dst}.{self.dst_port}"


@dataclass
class Region:
    """A partition region: the unit a backend code-generates.

    ``kind`` is "sw" (a host scheduler thread) or "hw" (a compiled device
    partition).  A module may carry any number of hw regions — each is
    compiled into its own ``DeviceProgram`` and driven by its own PLink
    lane, so accelerator partitions pipeline against each other.
    """

    id: str
    kind: str  # "sw" | "hw"
    pe: str
    actors: List[str] = field(default_factory=list)


@dataclass
class IRModule:
    """The lowered program: what every backend consumes."""

    name: str
    actors: Dict[str, IRActor] = field(default_factory=dict)
    channels: List[IRChannel] = field(default_factory=list)
    regions: Dict[str, Region] = field(default_factory=dict)
    source: Optional[ActorGraph] = None  # the authored graph (never mutated)
    meta: Dict[str, object] = field(default_factory=dict)
    trace: List[Tuple[str, str]] = field(default_factory=list)  # (pass, dump)

    # -- queries ---------------------------------------------------------------
    def assignment(self) -> Dict[str, str]:
        return {a: r.id for r in self.regions.values() for a in r.actors}

    @property
    def hw_region(self) -> Optional[Region]:
        """The module's *single* hw region (legacy accessor).

        Multi-partition modules must use ``hw_regions()``; this property
        keeps the one-partition callers honest by refusing to pick one
        arbitrarily.
        """
        hw = self.hw_regions()
        if len(hw) > 1:
            raise GraphError(
                f"{self.name}: {len(hw)} hw regions "
                f"({[r.id for r in hw]}); use hw_regions() — there is no "
                f"single 'the device partition' in a multi-partition module"
            )
        return hw[0] if hw else None

    def hw_regions(self) -> List[Region]:
        """Every device partition region, in stable (id-sorted) order."""
        return sorted(
            (r for r in self.regions.values() if r.kind == "hw"),
            key=lambda r: r.id,
        )

    def hw_actors(self) -> Set[str]:
        """Union of all device-partition actors."""
        return {a for r in self.hw_regions() for a in r.actors}

    def hw_assignment(self) -> Dict[str, str]:
        """Device actor -> owning hw region id."""
        return {a: r.id for r in self.hw_regions() for a in r.actors}

    def sw_regions(self) -> List[Region]:
        return [r for r in self.regions.values() if r.kind == "sw"]

    def in_channels(self, actor: str) -> List[IRChannel]:
        return [c for c in self.channels if c.dst == actor]

    def out_channels(self, actor: str) -> List[IRChannel]:
        return [c for c in self.channels if c.src == actor]

    def predecessors(self, actor: str) -> Set[str]:
        return {c.src for c in self.in_channels(actor)}

    def successors(self, actor: str) -> Set[str]:
        return {c.dst for c in self.out_channels(actor)}

    def topo_order(self) -> List[str]:
        """Topological order ignoring back-edges (same contract as
        ``ActorGraph.topo_order``)."""
        order: List[str] = []
        seen: Set[str] = set()

        def visit(n: str, stack: Set[str]):
            if n in seen or n in stack:
                return
            stack.add(n)
            for p in sorted(self.predecessors(n)):
                visit(p, stack)
            stack.discard(n)
            seen.add(n)
            order.append(n)

        for n in sorted(self.actors):
            visit(n, set())
        return order

    # -- introspection -----------------------------------------------------------
    def dump(self) -> str:
        """Human-readable module listing — the unit of ``ir_dump()``."""
        lines = [f"module {self.name}"]
        for rid, r in sorted(self.regions.items()):
            lines.append(
                f"  region {rid} [{r.kind}/{r.pe}]: "
                f"{', '.join(sorted(r.actors)) or '-'}"
            )
        for name in sorted(self.actors):
            lines.append(f"  actor {self.actors[name].describe()}")
        for ch in self.channels:
            d = ch.resolved_depth
            lines.append(
                f"  channel {ch} : {ch.dtype} "
                f"depth={d if d is not None else '?'}({ch.depth_source()})"
            )
        for k in sorted(self.meta):
            v = self.meta[k]
            if k == "diagnostics":
                # streamcheck findings: one line per diagnostic so the pass
                # trace shows exactly what the analyses saw at this point
                lines.append(f"  meta diagnostics={v!r}")
                for d in v:
                    lines.append(f"    diag {d}")
                continue
            lines.append(f"  meta {k}={v}")
        return "\n".join(lines)

    def record(self, pass_name: str) -> None:
        self.trace.append((pass_name, self.dump()))

    def dump_trace(self, pass_name: Optional[str] = None) -> str:
        """The pass-by-pass story: every pass's name followed by the module
        as it stood after the pass ran.  ``pass_name`` selects one entry."""
        if pass_name is not None:
            for name, text in self.trace:
                if name == pass_name:
                    return text
            known = [n for n, _ in self.trace]
            raise KeyError(
                f"no pass {pass_name!r} in trace (ran: {known})"
            )
        blocks = []
        for name, text in self.trace:
            blocks.append(f"// after {name}\n{text}")
        return "\n\n".join(blocks)
