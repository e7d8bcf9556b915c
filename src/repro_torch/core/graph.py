"""Dataflow graph: actor instances connected by point-to-point channels.

Mirrors a CAL ``network`` (paper Listing 1): entities + structure.  Channels are
lossless, ordered, conceptually unbounded; a concrete FIFO depth is chosen by the
configuration (XCF) or a default.  The graph is the unit the partitioner operates
on and the runtimes execute.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.core.actor import Actor


class GraphError(ValueError):
    """Invalid graph construction (unknown actor/port, conflicting channel).

    Raised at *build* time so authoring mistakes surface before any runtime is
    constructed — the frontend DSL and the legacy ``connect`` API both route
    through these checks.
    """


@dataclass(frozen=True)
class Channel:
    src: str  # actor instance name
    src_port: str
    dst: str
    dst_port: str
    depth: Optional[int] = None  # None -> runtime default

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.src, self.src_port, self.dst, self.dst_port)

    def __str__(self):
        return f"{self.src}.{self.src_port}->{self.dst}.{self.dst_port}"


class ActorGraph:
    """A network of actor instances."""

    def __init__(self, name: str):
        self.name = name
        self.actors: Dict[str, Actor] = {}
        self.channels: List[Channel] = []
        # actor name -> "file:line" where it was authored (filled by the DSL;
        # empty for hand-built graphs).  Diagnostics use it as provenance.
        self.origins: Dict[str, str] = {}

    # -- construction -------------------------------------------------------
    def add(self, actor: Actor) -> Actor:
        if actor.name in self.actors:
            raise GraphError(
                f"{self.name}: duplicate actor {actor.name!r} — instance names "
                f"must be unique within a network"
            )
        self.actors[actor.name] = actor
        return actor

    def _actor(self, name: str, role: str) -> Actor:
        try:
            return self.actors[name]
        except KeyError:
            raise GraphError(
                f"{self.name}: connect() {role} refers to unknown actor "
                f"{name!r} — add() it first (known actors: "
                f"{sorted(self.actors) or 'none'})"
            ) from None

    def _port(self, actor: Actor, port: str, direction: str):
        ports = actor.inputs if direction == "input" else actor.outputs
        for p in ports:
            if p.name == port:
                return p
        raise GraphError(
            f"{self.name}: actor {actor.name!r} has no {direction} port "
            f"{port!r} (its {direction}s: {[p.name for p in ports] or 'none'})"
        )

    def connect(
        self, src: str, dst: str,
        src_port: str = "OUT", dst_port: str = "IN",
        depth: Optional[int] = None,
    ) -> Channel:
        sa, da = self._actor(src, "source"), self._actor(dst, "destination")
        sp = self._port(sa, src_port, "output")
        dp = self._port(da, dst_port, "input")
        if "object" not in (sp.dtype, dp.dtype) and sp.dtype != dp.dtype:
            raise GraphError(
                f"{self.name}: dtype mismatch on {src}.{src_port} "
                f"({sp.dtype}) -> {dst}.{dst_port} ({dp.dtype}) — tokens are "
                f"not converted in flight; align the port dtypes"
            )
        # point-to-point: one writer and one reader per port
        for c in self.channels:
            if c.src == src and c.src_port == src_port:
                raise GraphError(
                    f"{self.name}: output {src}.{src_port} already feeds "
                    f"{c.dst}.{c.dst_port} — channels are point-to-point; "
                    f"use the frontend's tee() for fan-out"
                )
            if c.dst == dst and c.dst_port == dst_port:
                raise GraphError(
                    f"{self.name}: input {dst}.{dst_port} is already fed by "
                    f"{c.src}.{c.src_port} — channels are point-to-point; "
                    f"merge upstream with an explicit actor instead"
                )
        ch = Channel(src, src_port, dst, dst_port, depth)
        self.channels.append(ch)
        return ch

    # -- queries --------------------------------------------------------------
    def in_channels(self, actor: str) -> List[Channel]:
        return [c for c in self.channels if c.dst == actor]

    def out_channels(self, actor: str) -> List[Channel]:
        return [c for c in self.channels if c.src == actor]

    def successors(self, actor: str) -> Set[str]:
        return {c.dst for c in self.out_channels(actor)}

    def predecessors(self, actor: str) -> Set[str]:
        return {c.src for c in self.in_channels(actor)}

    def validate(self) -> None:
        for name, a in self.actors.items():
            for p in a.inputs:
                if not any(
                    c.dst == name and c.dst_port == p.name for c in self.channels
                ):
                    raise GraphError(
                        f"{self.name}: unconnected input {name}.{p.name}"
                    )
            for p in a.outputs:
                if not any(
                    c.src == name and c.src_port == p.name for c in self.channels
                ):
                    raise GraphError(
                        f"{self.name}: unconnected output {name}.{p.name}"
                    )

    def topo_order(self) -> List[str]:
        """Topological order ignoring back-edges (graph may be cyclic)."""
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

    def is_chain(self) -> bool:
        """True when the graph is a simple pipeline (each actor <=1 pred/succ)."""
        return all(
            len(self.predecessors(a)) <= 1 and len(self.successors(a)) <= 1
            for a in self.actors
        )

    def __iter__(self) -> Iterator[Actor]:
        return iter(self.actors.values())

    def __len__(self) -> int:
        return len(self.actors)
