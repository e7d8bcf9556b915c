"""Declarative actor-authoring DSL (the CAL surface of the frontend).

Actors are authored once as ``@actor`` classes whose ``@action`` methods carry
their token rates and guards — the textual analogue of a CAL actor (paper §II).
Networks are wired through *typed port handles*: ``src.OUT >> filt.IN`` creates
a validated channel (port existence, direction, dtype, point-to-point arity)
that fails at build time with an actionable message instead of mid-run.

::

    from repro_torch.frontend import actor, action, network

    @actor(inputs={"IN": "float32"}, outputs={"OUT": "float32"})
    class Filter:
        def __init__(self, param=50.0):
            self.param = param

        @action(consumes={"IN": 1}, produces={"OUT": 1},
                guard=lambda self, st, t: t["IN"][0] < self.param)
        def keep(self, st, t):
            return st, {"OUT": [t["IN"][0]]}

        @action(consumes={"IN": 1})          # lower priority: drop
        def drop(self, st, t):
            return st, {}

    net = network("TopFilter")
    src = net.source("source", gen, has_next=lambda st: st["x"] < 4096)
    filt = net.add(Filter(50.0), "filter")
    out = []
    snk = net.sink("sink", collect=out)
    src >> filt >> snk                        # typed, validated connections
    graph = net.graph()                       # plain repro_torch.core ActorGraph

Action methods (and guards / ``vector_fire``) may be written with or without a
leading ``self`` parameter; ``self`` gives access to constructor parameters
(coefficients, thresholds).  Fan-out is explicit via ``port.tee(a.IN, b.IN)``
— channels stay point-to-point, matching the runtimes' single-writer /
single-reader FIFO protocol.

The DSL builds the exact same ``repro_torch.core`` IR (``Actor``/``ActorGraph``) the
rest of the compiler consumes, so hand-built graphs and DSL-built networks are
interchangeable everywhere, including ``repro_torch.compile``.
"""

from __future__ import annotations

import inspect
import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


from repro_torch.core.actor import (
    Action,
    Actor,
    Port,
    simple_actor,
    sink_actor,
    source_actor,
)
from repro_torch.core.graph import ActorGraph, GraphError


class FrontendError(GraphError):
    """Invalid DSL usage, reported at authoring/build time."""


def _caller_origin() -> str:
    """``file:line`` of the first stack frame outside this module — the user
    code that placed the actor.  Streamcheck diagnostics carry it so a finding
    points at the authoring site, not at the compiler."""
    f = sys._getframe(1)
    while f is not None and f.f_globals.get("__file__") == __file__:
        f = f.f_back
    if f is None:
        return ""
    return f"{f.f_code.co_filename}:{f.f_lineno}"


# ---------------------------------------------------------------------------
# @action / @actor decorators
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _ActionSpec:
    fn: Callable
    consumes: Dict[str, int]
    produces: Dict[str, int]
    guard: Optional[Callable]
    name: str


def action(
    fn: Optional[Callable] = None,
    *,
    consumes: Optional[Dict[str, int]] = None,
    produces: Optional[Dict[str, int]] = None,
    guard: Optional[Callable] = None,
    name: Optional[str] = None,
):
    """Mark a method of an ``@actor`` class as a CAL action.

    ``consumes``/``produces`` map port name -> tokens per firing; ``guard`` is
    an optional predicate over (state, peeked inputs).  Actions fire in
    declaration order (CAL priority order).
    """

    def wrap(f: Callable) -> _ActionSpec:
        return _ActionSpec(
            fn=f,
            consumes=dict(consumes or {}),
            produces=dict(produces or {}),
            guard=guard,
            name=name or f.__name__,
        )

    return wrap(fn) if fn is not None else wrap


def _as_ports(spec, what: str) -> List[Port]:
    if spec is None:
        return []
    if isinstance(spec, dict):
        return [Port(n, dt) for n, dt in spec.items()]
    ports = []
    for item in spec:
        if isinstance(item, Port):
            ports.append(item)
        elif isinstance(item, str):
            ports.append(Port(item, "float32"))
        elif isinstance(item, tuple) and len(item) == 2:
            ports.append(Port(item[0], item[1]))
        else:
            raise FrontendError(
                f"@actor {what} entries must be Port, name, or (name, dtype); "
                f"got {item!r}"
            )
    return ports


def _wants_self(fn: Optional[Callable]) -> bool:
    if fn is None:
        return False
    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):  # builtins / odd callables: leave as-is
        return False
    return bool(params) and params[0] == "self"


def _bind(fn: Optional[Callable], obj: Any) -> Optional[Callable]:
    """Bind ``fn`` to ``obj`` when its first parameter is ``self``; otherwise
    the function is treated as stateless and used directly."""
    if fn is None:
        return None
    return fn.__get__(obj) if _wants_self(fn) else fn


def actor(
    cls: Optional[type] = None,
    *,
    inputs=None,
    outputs=None,
    state: Optional[Dict[str, Any]] = None,
    device_ok: bool = True,
    host_only_reason: str = "",
    name: Optional[str] = None,
):
    """Class decorator turning a class with ``@action`` methods into an actor
    template.  Instances of the class are placeable in a network via
    ``Network.add`` (constructor arguments parameterize the actor); a class
    with a no-argument constructor can be placed directly."""

    def wrap(c: type) -> type:
        in_ports = _as_ports(inputs, "inputs")
        out_ports = _as_ports(outputs, "outputs")
        specs = [v for v in vars(c).values() if isinstance(v, _ActionSpec)]
        if not specs:
            raise FrontendError(
                f"@actor class {c.__name__} declares no @action methods"
            )
        in_names = {p.name for p in in_ports}
        out_names = {p.name for p in out_ports}
        for s in specs:
            for p in s.consumes:
                if p not in in_names:
                    raise FrontendError(
                        f"{c.__name__}.{s.name}: consumes unknown input "
                        f"{p!r} (declared inputs: {sorted(in_names) or 'none'})"
                    )
            for p in s.produces:
                if p not in out_names:
                    raise FrontendError(
                        f"{c.__name__}.{s.name}: produces unknown output "
                        f"{p!r} (declared outputs: {sorted(out_names) or 'none'})"
                    )
        c._actor_template = {
            "inputs": in_ports,
            "outputs": out_ports,
            "specs": specs,
            "state": dict(state or {}),
            "device_ok": device_ok,
            "host_only_reason": host_only_reason,
            "name": name or c.__name__,
        }

        def build(self, instance_name: str) -> Actor:
            meta = type(self)._actor_template
            actions = [
                Action(
                    name=s.name,
                    consumes=dict(s.consumes),
                    produces=dict(s.produces),
                    guard=_bind(s.guard, self),
                    fire=_bind(s.fn, self),
                )
                for s in meta["specs"]
            ]
            vf = self.__dict__.get("vector_fire") or _bind(
                getattr(type(self), "vector_fire", None), self
            )
            # Fusion spec: instances may set self.stream_op in __init__
            # (parameterized actors) or declare it as a class attribute /
            # zero-arg method.
            sop = getattr(self, "stream_op", None)
            if callable(sop):
                sop = sop()
            st = getattr(self, "state", None)
            return Actor(
                name=instance_name,
                inputs=list(meta["inputs"]),
                outputs=list(meta["outputs"]),
                actions=actions,
                initial_state=dict(st if st is not None else meta["state"]),
                device_ok=meta["device_ok"],
                host_only_reason=meta["host_only_reason"],
                vector_fire=vf,
                stream_op=sop,
            )

        c.build = build
        return c

    return wrap(cls) if cls is not None else wrap


# ---------------------------------------------------------------------------
# Typed handles
# ---------------------------------------------------------------------------


class PortHandle:
    """A (network, actor, port) reference with direction and dtype — the unit
    of connection.  ``out_handle >> in_handle`` wires a channel."""

    __slots__ = ("net", "actor_name", "port", "is_input")

    def __init__(self, net: "Network", actor_name: str, port: Port, is_input: bool):
        self.net = net
        self.actor_name = actor_name
        self.port = port
        self.is_input = is_input

    @property
    def dtype(self) -> str:
        return self.port.dtype

    @property
    def owner(self) -> "ActorHandle":
        return self.net[self.actor_name]

    def __rshift__(self, other) -> "ActorHandle":
        return self.net.connect(self, other)

    def connect(self, other, *, depth: Optional[int] = None) -> "ActorHandle":
        return self.net.connect(self, other, depth=depth)

    def tee(self, *dsts, depth: Optional[int] = None, name: Optional[str] = None):
        return self.net.tee(self, *dsts, depth=depth, name=name)

    def __repr__(self) -> str:
        kind = "in" if self.is_input else "out"
        return f"<{kind}-port {self.actor_name}.{self.port.name}: {self.dtype}>"


class ActorHandle:
    """Handle to a placed actor instance; port handles hang off it as
    attributes (``h.OUT``), validated against the actor's declared ports."""

    __slots__ = ("_net", "_name", "_actor")

    def __init__(self, net: "Network", name: str, actor: Actor):
        object.__setattr__(self, "_net", net)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_actor", actor)

    @property
    def name(self) -> str:
        return self._name

    @property
    def actor(self) -> Actor:
        return self._actor

    def port(self, name: str) -> PortHandle:
        for p in self._actor.inputs:
            if p.name == name:
                return PortHandle(self._net, self._name, p, True)
        for p in self._actor.outputs:
            if p.name == name:
                return PortHandle(self._net, self._name, p, False)
        raise FrontendError(
            f"actor {self._name!r} has no port {name!r} "
            f"(inputs: {[p.name for p in self._actor.inputs] or 'none'}, "
            f"outputs: {[p.name for p in self._actor.outputs] or 'none'})"
        )

    def __getattr__(self, item: str) -> PortHandle:
        if item.startswith("_"):
            raise AttributeError(item)
        try:
            return self.port(item)
        except FrontendError as e:
            # AttributeError keeps hasattr()/dir() semantics intact while the
            # message stays actionable.
            raise AttributeError(str(e)) from None

    def __getitem__(self, item: str) -> PortHandle:
        return self.port(item)

    def _sole(self, direction: str) -> PortHandle:
        ports = self._actor.inputs if direction == "input" else self._actor.outputs
        if len(ports) != 1:
            raise FrontendError(
                f"actor {self._name!r} has {len(ports)} {direction} ports "
                f"({[p.name for p in ports] or 'none'}); name one explicitly, "
                f"e.g. {self._name}.{ports[0].name if ports else 'PORT'}"
            )
        return self.port(ports[0].name)

    def __rshift__(self, other) -> "ActorHandle":
        return self._net.connect(self, other)

    def __repr__(self) -> str:
        return f"<actor {self._name} of {self._net.name}>"


# ---------------------------------------------------------------------------
# Network builder
# ---------------------------------------------------------------------------


class Network:
    """Builds a validated ``ActorGraph`` from placed actors and typed-port
    connections.  Pass the network (or its ``.graph()``) to ``repro_torch.compile``."""

    def __init__(self, name: str):
        self.name = name
        self._graph = ActorGraph(name)
        self._handles: Dict[str, ActorHandle] = {}
        self._collectors: List[list] = []
        self._auto: Dict[str, int] = {}

    # -- placement -----------------------------------------------------------
    def add(self, obj, name: Optional[str] = None) -> ActorHandle:
        """Place an actor: an ``@actor`` template instance (or class, when its
        constructor takes no arguments) or a raw ``repro_torch.core`` Actor."""
        if isinstance(obj, type) and hasattr(obj, "_actor_template"):
            obj = obj()
        if hasattr(type(obj), "_actor_template"):
            a = obj.build(
                name
                or self._auto_name(type(obj)._actor_template["name"].lower())
            )
        elif isinstance(obj, Actor):
            if name is not None and name != obj.name:
                import dataclasses

                obj = dataclasses.replace(obj, name=name)
            a = obj
        else:
            raise FrontendError(
                f"Network.add expects an @actor template or a core Actor, "
                f"got {type(obj).__name__}"
            )
        self._graph.add(a)  # GraphError on duplicate names
        self._graph.origins[a.name] = _caller_origin()
        h = ActorHandle(self, a.name, a)
        self._handles[a.name] = h
        return h

    def _auto_name(self, base: str) -> str:
        i = self._auto.get(base, 0)
        self._auto[base] = i + 1
        cand = base if i == 0 else f"{base}{i}"
        while cand in self._graph.actors:
            i += 1
            self._auto[base] = i + 1
            cand = f"{base}{i}"
        return cand

    # -- IO / function-actor sugar (host-side endpoints) ----------------------
    def source(
        self,
        name: str,
        gen: Callable,
        *,
        out: str = "OUT",
        dtype: str = "float32",
        state: Optional[Dict[str, Any]] = None,
        has_next: Optional[Callable] = None,
    ) -> ActorHandle:
        """Host-side generator actor (``gen(state) -> (state, token|None)``)."""
        return self.add(
            source_actor(name, gen, out=out, dtype=dtype, state=state,
                         has_next=has_next)
        )

    def sink(
        self,
        name: str,
        consume: Optional[Callable] = None,
        *,
        collect: Optional[list] = None,
        cast: Optional[Callable] = float,
        inp: str = "IN",
        dtype: str = "float32",
        state: Optional[Dict[str, Any]] = None,
    ) -> ActorHandle:
        """Host-side sink.  ``collect=lst`` appends each token (``cast``-ed) to
        the list and registers it so ``Program.run`` can reset it between runs;
        with neither ``consume`` nor ``collect`` the sink discards tokens."""
        if consume is not None and collect is not None:
            raise FrontendError(f"sink {name!r}: pass consume= or collect=, not both")
        if collect is not None:
            self._collectors.append(collect)

            def consume(st, v, _lst=collect, _cast=cast):  # noqa: A001
                _lst.append(_cast(v) if _cast is not None else v)
                return st

        elif consume is None:
            def consume(st, v):  # noqa: A001
                return st

        return self.add(
            sink_actor(name, consume, inp=inp, dtype=dtype, state=state)
        )

    def map(
        self,
        name: str,
        fn: Callable,
        *,
        inputs: Sequence[str] = ("IN",),
        outputs: Sequence[str] = ("OUT",),
        dtype: str = "float32",
        state: Optional[Dict[str, Any]] = None,
        vector_fire: Optional[Callable] = None,
        stream_op: Optional[tuple] = None,
    ) -> ActorHandle:
        """One-action SDF actor: ``fn(state, *in_tokens) -> (state, out)``."""
        return self.add(
            simple_actor(name, fn, inputs=inputs, outputs=outputs, dtype=dtype,
                         state=state, vector_fire=vector_fire,
                         stream_op=stream_op)
        )

    # -- wiring ---------------------------------------------------------------
    def _as_port(self, x, *, output: bool) -> PortHandle:
        role = "source (left of >>)" if output else "destination (right of >>)"
        if isinstance(x, ActorHandle):
            x = x._sole("output" if output else "input")
        if not isinstance(x, PortHandle):
            raise FrontendError(
                f"connection {role} must be a port or actor handle, "
                f"got {type(x).__name__}"
            )
        if x.net is not self:
            raise FrontendError(
                f"{x!r} belongs to network {x.net.name!r}, not {self.name!r} — "
                f"handles cannot be wired across networks"
            )
        if output and x.is_input:
            raise FrontendError(
                f"{x!r} is an input port and cannot be a connection {role}"
            )
        if not output and not x.is_input:
            raise FrontendError(
                f"{x!r} is an output port and cannot be a connection {role}"
            )
        return x

    def connect(self, src, dst, *, depth: Optional[int] = None) -> ActorHandle:
        """Wire ``src`` (output port / actor) to ``dst`` (input port / actor).
        Returns the destination actor handle so connections chain:
        ``src >> filt >> sink``."""
        s = self._as_port(src, output=True)
        d = self._as_port(dst, output=False)
        # dtype compatibility (and arity) are enforced by ActorGraph.connect
        self._graph.connect(
            s.actor_name, d.actor_name, s.port.name, d.port.name, depth=depth
        )
        return self._handles[d.actor_name]

    def tee(
        self,
        src,
        *dsts,
        depth: Optional[int] = None,
        name: Optional[str] = None,
    ) -> ActorHandle:
        """Fan one output out to several inputs through an explicit duplicator
        actor (channels stay point-to-point).  Returns the tee's handle."""
        s = self._as_port(src, output=True)
        if len(dsts) < 2:
            raise FrontendError(
                f"tee from {s!r} needs at least two destinations "
                f"(got {len(dsts)}); use >> for a plain connection"
            )
        tee_name = name or self._auto_name(f"{s.actor_name}_{s.port.name}_tee")
        outs = [f"O{i}" for i in range(len(dsts))]

        def fire(st, t, _outs=tuple(outs)):
            v = t["IN"][0]
            return st, {o: [v] for o in _outs}

        def vf(state, ins, _outs=tuple(outs)):
            pair = ins["IN"]
            return state, {o: pair for o in _outs}

        h = self.add(
            Actor(
                tee_name,
                inputs=[Port("IN", s.dtype)],
                outputs=[Port(o, s.dtype) for o in outs],
                actions=[
                    Action(
                        "dup",
                        consumes={"IN": 1},
                        produces={o: 1 for o in outs},
                        fire=fire,
                    )
                ],
                vector_fire=vf,
                stream_op=("dup", len(outs)),
            )
        )
        self.connect(s, h.port("IN"), depth=depth)
        for o, d in zip(outs, dsts):
            self.connect(h.port(o), d, depth=depth)
        return h

    # -- access / build --------------------------------------------------------
    def __getitem__(self, name: str) -> ActorHandle:
        try:
            return self._handles[name]
        except KeyError:
            raise FrontendError(
                f"network {self.name!r} has no actor {name!r} "
                f"(placed: {sorted(self._handles) or 'none'})"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._handles

    def __iter__(self) -> Iterator[ActorHandle]:
        return iter(self._handles.values())

    def __len__(self) -> int:
        return len(self._handles)

    @property
    def collectors(self) -> List[list]:
        return self._collectors

    def graph(self) -> ActorGraph:
        """Validate (every port connected) and return the underlying IR."""
        try:
            self._graph.validate()
        except GraphError as e:
            raise FrontendError(f"network {self.name!r} is incomplete: {e}") from None
        return self._graph

    def __repr__(self) -> str:
        return (
            f"<Network {self.name}: {len(self._graph.actors)} actors, "
            f"{len(self._graph.channels)} channels>"
        )


def network(name: str) -> Network:
    """Start a new network (a CAL ``network`` block)."""
    return Network(name)
