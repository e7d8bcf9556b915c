"""Actor Machines (paper §II-B, Janneck [20]).

Action selection is compiled into a controller state machine whose states encode
*knowledge* about the actor's firing conditions — each condition is known-true (1),
known-false (0) or unknown (X).  Three instruction kinds transition the controller:

  TEST c   — evaluate condition c, branch on the result,
  EXEC a   — fire action a (the only instruction that touches program state),
  WAIT     — forget knowledge of *transient* conditions (token availability,
             output space) and yield until an external event can change them.

This module synthesizes a single-instruction AM (SIAM) per actor: each controller
state carries exactly one instruction, chosen deterministically.  The controller
*remembers* conditions already tested — the paper's key advantage over the
"basic" re-test-everything controller (reproduced in BasicController below and
compared in benchmarks/table_am_vs_basic.py).

Priorities are respected with partial knowledge: an action EXECs only when it is
known-enabled and every higher-priority action is known-disabled.

Conditions:
  ("in", port, n)   — ≥ n tokens available          (transient)
  ("out", port, n)  — ≥ n slots of output space      (transient)
  ("guard", action) — guard predicate over (state, peeked tokens)  (reset on EXEC)
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import Dict, List, Optional, Tuple, Union


from repro_torch.core.actor import Action, Actor

Cond = Tuple  # ("in", port, n) | ("out", port, n) | ("guard", action_name)
Knowledge = Tuple[Optional[bool], ...]  # per canonical condition; None = X


@dataclass(frozen=True)
class Test:
    cond_idx: int
    if_true: Knowledge
    if_false: Knowledge


@dataclass(frozen=True)
class Exec:
    action_idx: int
    next: Knowledge  # always the initial all-X state


@dataclass(frozen=True)
class Wait:
    next: Knowledge
    terminal: bool = False  # actor can provably never fire again


Instr = Union[Test, Exec, Wait]


@dataclass
class Controller:
    actor_name: str
    conditions: List[Cond]
    actions: List[Action]
    init: Knowledge
    states: Dict[Knowledge, Instr]

    @property
    def num_states(self) -> int:
        return len(self.states)


def action_conditions(actor: Actor) -> Tuple[List[Cond], Dict[str, List[int]]]:
    """Canonical condition list + per-action condition indices (test order)."""
    conds: List[Cond] = []
    index: Dict[Cond, int] = {}

    def intern(c: Cond) -> int:
        if c not in index:
            index[c] = len(conds)
            conds.append(c)
        return index[c]

    per_action: Dict[str, List[int]] = {}
    for a in actor.actions:
        idx: List[int] = []
        for port, n in sorted(a.consumes.items()):
            idx.append(intern(("in", port, n)))
        if a.guard is not None:
            idx.append(intern(("guard", a.name)))
        for port, n in sorted(a.produces.items()):
            idx.append(intern(("out", port, n)))
        per_action[a.name] = idx
    return conds, per_action


def _is_transient(c: Cond) -> bool:
    return c[0] in ("in", "out")


def build_controller(actor: Actor) -> Controller:
    """Synthesize the SIAM controller via lazy reachable-state construction."""
    conds, per_action = action_conditions(actor)
    n = len(conds)
    init: Knowledge = tuple([None] * n)
    states: Dict[Knowledge, Instr] = {}

    def guard_testable(a: Action, k: Knowledge) -> bool:
        """A guard peeks at input tokens, so its action's input conditions must be
        known true before the guard can be tested."""
        for ci in per_action[a.name]:
            c = conds[ci]
            if c[0] == "in" and k[ci] is not True:
                return False
            if c[0] == "guard":
                return True
        return True

    def sel_conds(a: Action) -> List[int]:
        """Selection conditions (inputs + guard).  Output space is a bounded-
        buffer artifact: it gates EXEC but must not alter the *choice* among
        prioritized actions (CAL semantics assume unbounded channels — cf. the
        paper's Fig. 2, where missing output space WAITs instead of falling
        through to the lower-priority action)."""
        return [ci for ci in per_action[a.name] if conds[ci][0] != "out"]

    def out_conds(a: Action) -> List[int]:
        return [ci for ci in per_action[a.name] if conds[ci][0] == "out"]

    def sel_status(a: Action, k: Knowledge) -> str:
        vals = [k[ci] for ci in sel_conds(a)]
        if any(v is False for v in vals):
            return "disabled"
        if all(v is True for v in vals):
            return "enabled"
        return "unknown"

    def choose(k: Knowledge) -> Instr:
        def mk_test(ci: int) -> Test:
            kt = list(k); kt[ci] = True
            kf = list(k); kf[ci] = False
            return Test(ci, tuple(kt), tuple(kf))

        for i, a in enumerate(actor.actions):
            st = sel_status(a, k)
            if st == "disabled":
                continue
            if st == "unknown":
                for ci in sel_conds(a):
                    if k[ci] is None:
                        c = conds[ci]
                        if c[0] == "guard" and not guard_testable(a, k):
                            continue  # inputs get tested first by list order
                        return mk_test(ci)
                raise AssertionError("unknown status without unknown condition")
            # selected (highest-priority enabled): now satisfy output space
            for ci in out_conds(a):
                if k[ci] is None:
                    return mk_test(ci)
                if k[ci] is False:
                    # blocked on output space: WAIT, keep guard knowledge
                    return Wait(_transient_reset(k), terminal=False)
            return Exec(i, init)
        # every action disabled: WAIT; terminal iff all disabled by guard-False
        terminal = all(
            any(
                k[ci] is False and conds[ci][0] == "guard"
                for ci in sel_conds(a)
            )
            for a in actor.actions
        )
        reset = _transient_reset(k)
        if reset == k and not terminal:
            return Wait(k, terminal=False)
        return Wait(reset, terminal=terminal)

    def _transient_reset(k: Knowledge) -> Knowledge:
        return tuple(
            None if (_is_transient(conds[i]) and k[i] is not None) else k[i]
            for i in range(len(k))
        )

    # lazy DFS over reachable states
    stack = [init]
    while stack:
        k = stack.pop()
        if k in states:
            continue
        instr = choose(k)
        states[k] = instr
        nxts = []
        if isinstance(instr, Test):
            nxts = [instr.if_true, instr.if_false]
        elif isinstance(instr, Exec):
            nxts = [instr.next]
        else:
            if not instr.terminal and instr.next != k:
                nxts = [instr.next]
        for nk in nxts:
            if nk not in states:
                stack.append(nk)
    return Controller(actor.name, conds, list(actor.actions), init, states)


# ---------------------------------------------------------------------------
# Runtime interpreters
# ---------------------------------------------------------------------------


class PortEnv:
    """Binding of an actor's ports to FIFO endpoints (duck-typed):

    input endpoints:  .count() -> tokens available, .peek(n) -> tuple, .read(n)
    output endpoints: .space() -> free slots, .write(seq)
    """

    def __init__(self, inputs: Dict[str, object], outputs: Dict[str, object]):
        self.inputs = inputs
        self.outputs = outputs


@dataclass
class AMStats:
    tests: int = 0
    execs: int = 0
    waits: int = 0
    invocations: int = 0
    fire_time_ns: int = 0


class ActorMachine:
    """SIAM interpreter with persistent controller state (the paper's HAM/SAM)."""

    def __init__(self, actor: Actor, env: PortEnv, controller: Optional[Controller] = None):
        self.actor = actor
        self.env = env
        self.controller = controller or build_controller(actor)
        self.k: Knowledge = self.controller.init
        self.state = dict(actor.initial_state)
        self.stats = AMStats()
        self.terminated = False

    # -- condition evaluation ------------------------------------------------
    def _eval(self, c: Cond) -> bool:
        kind = c[0]
        if kind == "in":
            return self.env.inputs[c[1]].count() >= c[2]
        if kind == "out":
            return self.env.outputs[c[1]].space() >= c[2]
        action = next(a for a in self.actor.actions if a.name == c[1])
        peeked = {
            p: self.env.inputs[p].peek(n) for p, n in action.consumes.items()
        }
        return bool(action.guard(self.state, peeked))

    def _fire(self, a: Action) -> None:
        toks = {p: self.env.inputs[p].read(n) for p, n in a.consumes.items()}
        self.state, outs = a.fire(self.state, toks)
        for p, vals in outs.items():
            if vals:
                self.env.outputs[p].write(vals)

    # -- the paper's invocation contract --------------------------------------
    def invoke(self, max_execs: int = 1_000_000) -> int:
        """Run controller micro-steps until WAIT or the exec budget; returns execs.

        Hardware AMs bound the steps per invocation (acyclic controller pass);
        software AMs iterate up to a threshold (paper §III-C).  Knowledge
        persists across invocations either way.
        """
        self.stats.invocations += 1
        execs = 0
        if self.terminated:
            return 0
        ctrl = self.controller
        while True:
            instr = ctrl.states[self.k]
            if isinstance(instr, Test):
                self.stats.tests += 1
                self.k = instr.if_true if self._eval(ctrl.conditions[instr.cond_idx]) else instr.if_false
            elif isinstance(instr, Exec):
                self._fire(ctrl.actions[instr.action_idx])
                self.stats.execs += 1
                execs += 1
                self.k = instr.next
                if execs >= max_execs:
                    return execs
            else:  # Wait
                self.stats.waits += 1
                self.k = instr.next
                if instr.terminal:
                    self.terminated = True
                return execs


class BasicController:
    """The Orcc-style controller (paper Listing 4): re-tests every firing
    condition on every invocation.  Used as the comparison baseline."""

    def __init__(self, actor: Actor, env: PortEnv):
        self.actor = actor
        self.env = env
        self.state = dict(actor.initial_state)
        self.stats = AMStats()
        self.terminated = False

    def invoke(self, max_execs: int = 1_000_000) -> int:
        self.stats.invocations += 1
        execs = 0
        while execs < max_execs:
            fired = False
            for a in self.actor.actions:
                # selection (paper Listing 4 structure): inputs + guard choose
                # the action; a false guard or missing input falls through to
                # the next priority, but missing OUTPUT SPACE blocks — the
                # else-branch is not taken when the guard held.
                sel = True
                for p, n_tok in a.consumes.items():
                    self.stats.tests += 1
                    if self.env.inputs[p].count() < n_tok:
                        sel = False
                        break
                if sel and a.guard is not None:
                    self.stats.tests += 1
                    peeked = {
                        p: self.env.inputs[p].peek(n)
                        for p, n in a.consumes.items()
                    }
                    sel = bool(a.guard(self.state, peeked))
                if not sel:
                    continue
                ok = True
                for p, n_tok in a.produces.items():
                    self.stats.tests += 1
                    if self.env.outputs[p].space() < n_tok:
                        ok = False
                        break
                if ok:
                    toks = {
                        p: self.env.inputs[p].read(n) for p, n in a.consumes.items()
                    }
                    self.state, outs = a.fire(self.state, toks)
                    for p, vals in outs.items():
                        if vals:
                            self.env.outputs[p].write(vals)
                    self.stats.execs += 1
                    execs += 1
                    fired = True
                break  # selected: either fired or blocked on output space
            if not fired:
                self.stats.waits += 1
                return execs
        return execs
