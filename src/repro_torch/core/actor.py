"""CAL-style actors: ports, actions with guards and priorities.

An actor is a collection of *actions* (paper §II): each action declares how many
tokens it consumes/produces per port, an optional guard over (state, peeked inputs),
and a fire function.  Actions are checked in priority order (the listed order, unless
explicit priorities are given — matching CAL's ``priority t0 > t1`` blocks).

Actors are written functionally: ``fire(state, inputs) -> (new_state, outputs)``.
The same actor object can execute on the host runtime (``repro_torch.runtime``) or be
compiled into a device partition (``repro_torch.runtime.device_runtime``), which is the
point of the paper: placement is a configuration decision, not a code change.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

State = Dict[str, Any]
Tokens = Mapping[str, Sequence[Any]]


@dataclass(frozen=True)
class Port:
    name: str
    # Token type is advisory (numpy dtype string or "object"); device partitions
    # require a concrete dtype.
    dtype: str = "object"


@dataclass(frozen=True)
class Action:
    name: str
    consumes: Dict[str, int] = field(default_factory=dict)  # port -> tokens/firing
    produces: Dict[str, int] = field(default_factory=dict)
    guard: Optional[Callable[[State, Tokens], bool]] = None
    fire: Callable[[State, Tokens], Tuple[State, Dict[str, List[Any]]]] = None

    def __post_init__(self):
        assert self.fire is not None, f"action {self.name} needs a fire function"


@dataclass
class Actor:
    """A dataflow actor: typed ports + prioritized actions + private state."""

    name: str
    inputs: List[Port] = field(default_factory=list)
    outputs: List[Port] = field(default_factory=list)
    actions: List[Action] = field(default_factory=list)  # priority order
    initial_state: State = field(default_factory=dict)
    # Hints for the partitioner / device codegen:
    device_ok: bool = True      # False for IO/file actors (paper §III-A)
    host_only_reason: str = ""
    # Static rates (SDF) enable vectorized device execution; None = dynamic (DDF).
    #   If every action has identical consume/produce rates, the actor is SDF.
    vector_fire: Optional[Callable] = None  # jnp-based batched fire (device path)
    # Declarative semantics for the fusion pass (repro_torch.ir.fusion): e.g.
    # ("affine", pre, mul, post), ("clip", lo, hi), ("matmul8", basis),
    # ("mac", c), ("fir_seed",), ("cmpx", ascending), ("dup", n).  Actors in
    # an SDF device region all carrying specs fuse into one Pallas stream
    # kernel; without specs the region fuses via composed vector_fires.
    stream_op: Optional[tuple] = None

    def __post_init__(self):
        in_names = {p.name for p in self.inputs}
        out_names = {p.name for p in self.outputs}
        for a in self.actions:
            for p in a.consumes:
                assert p in in_names, f"{self.name}.{a.name}: unknown input {p}"
            for p in a.produces:
                assert p in out_names, f"{self.name}.{a.name}: unknown output {p}"

    @property
    def is_sdf(self) -> bool:
        if not self.actions:
            return False
        c0, p0 = self.actions[0].consumes, self.actions[0].produces
        return all(
            a.consumes == c0 and a.produces == p0 and a.guard is None
            for a in self.actions
        ) and len(self.actions) == 1

    def port(self, name: str) -> Port:
        for p in self.inputs + self.outputs:
            if p.name == name:
                return p
        raise KeyError(f"{self.name}: no port {name}")


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------


def simple_actor(
    name: str,
    fn: Callable[..., Any],
    *,
    inputs: Sequence[str] = ("IN",),
    outputs: Sequence[str] = ("OUT",),
    dtype: str = "float32",
    state: Optional[State] = None,
    vector_fire: Optional[Callable] = None,
    stream_op: Optional[tuple] = None,
) -> Actor:
    """One-action SDF actor: consumes 1 token per input, applies fn, emits result(s).

    fn(state, *in_vals) -> (state, out_val | tuple of out_vals)
    """

    def fire(st: State, toks: Tokens):
        vals = [toks[p][0] for p in inputs]
        st, out = fn(st, *vals)
        if not isinstance(out, tuple):
            out = (out,)
        return st, {p: [v] for p, v in zip(outputs, out)}

    return Actor(
        name=name,
        inputs=[Port(p, dtype) for p in inputs],
        outputs=[Port(p, dtype) for p in outputs],
        actions=[
            Action(
                name="fire",
                consumes={p: 1 for p in inputs},
                produces={p: 1 for p in outputs},
                fire=fire,
            )
        ],
        initial_state=dict(state or {}),
        vector_fire=vector_fire,
        stream_op=stream_op,
    )


def source_actor(
    name: str, gen: Callable[[State], Tuple[State, Optional[Any]]],
    *, out: str = "OUT", dtype: str = "float32", state: Optional[State] = None,
    has_next: Optional[Callable[[State], bool]] = None,
) -> Actor:
    """Source: fires while the guard holds (the paper's Source stops at 4096).

    Prefer ``has_next(state)`` so exhaustion is discovered by the *guard* (no
    wasted firing); without it, gen returning None marks the actor done."""

    def guard(st: State, _toks: Tokens) -> bool:
        if has_next is not None:
            return bool(has_next(st))
        return not st.get("_done", False)

    def fire(st: State, _toks: Tokens):
        st, val = gen(st)
        if val is None:
            st = {**st, "_done": True}
            return st, {out: []}
        return st, {out: [val]}

    return Actor(
        name=name,
        inputs=[],
        outputs=[Port(out, dtype)],
        actions=[Action(name="gen", produces={out: 1}, guard=guard, fire=fire)],
        initial_state=dict(state or {}),
        device_ok=False,
        host_only_reason="source generates data host-side",
    )


def sink_actor(
    name: str, consume: Callable[[State, Any], State],
    *, inp: str = "IN", dtype: str = "float32", state: Optional[State] = None,
) -> Actor:
    def fire(st: State, toks: Tokens):
        st = consume(st, toks[inp][0])
        return st, {}

    return Actor(
        name=name,
        inputs=[Port(inp, dtype)],
        outputs=[],
        actions=[Action(name="eat", consumes={inp: 1}, fire=fire)],
        initial_state=dict(state or {}),
        device_ok=False,
        host_only_reason="sink performs IO host-side",
    )
