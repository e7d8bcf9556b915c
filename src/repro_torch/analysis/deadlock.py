"""Deadlock-freedom analysis: symbolic simulation of one SDF iteration.

A consistent rate system is necessary but not sufficient for liveness: the
*resolved FIFO depths* must also admit a schedule.  A feedback cycle of
static actors with no initial tokens can never start; a reconvergent diamond
whose short-path FIFO is smaller than the long path's firing skew wedges the
writer against the joint consumer.  At runtime both fail by hanging a
scheduler thread — this pass rejects them at compile time instead.

Method (classic Lee/Messerschmitt iteration simulation, made conservative
for the DDF frontier): demand-driven firing of the static actors, each up to
its repetition-vector count ``q[a]``, against the channels' resolved
capacities.  An actor may fire when every constrained input holds one
firing's tokens and every constrained output has one firing's space — the
exact enabling rule the actor-machine scheduler applies.  Channels touching
a dynamic actor are unconstrained (infinite tokens/space): a dynamic
neighbor *might* always cooperate, so nothing is rejected on its account —
only *sure* deadlocks, provable from static rates and depths alone, produce
``SB102``.  Channels internal to one device partition are also unconstrained
— the device backend compiles them to wires inside a single step, with no
FIFO at runtime.

Greedy firing within the per-actor budgets is complete: if the iteration can
finish at all, firing any enabled not-yet-done actor never paints the
schedule into a corner (tokens are conserved per channel and budgets bound
every counter), so "stuck with budgets unmet" is a proof of deadlock, not a
search artifact.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.diagnostics import Diagnostics

__all__ = ["simulate_iteration", "check_deadlock"]


def _constrained_channels(module) -> List[Tuple[object, int, int, int]]:
    """(channel, produce, consume, capacity) for every channel the
    simulation must respect."""
    hw_of = module.hw_assignment()
    out = []
    for ch in module.channels:
        rs = module.actors[ch.src].rate
        rd = module.actors[ch.dst].rate
        if not (rs.static and rd.static):
            continue  # DDF frontier: assume full cooperation
        p = rs.produce_rate(ch.src_port)
        c = rd.consume_rate(ch.dst_port)
        if p <= 0 or c <= 0:
            continue  # backlog/starvation lints cover these
        s_hw, d_hw = hw_of.get(ch.src), hw_of.get(ch.dst)
        if s_hw is not None and s_hw == d_hw:
            continue  # device-internal wire: no FIFO exists at runtime
        cap = ch.resolved_depth
        if cap is None:
            continue  # no depth resolved (legalize-only paths): skip
        out.append((ch, p, c, cap))
    return out


def simulate_iteration(
    module, repetition: Dict[str, int]
) -> Optional[Dict[str, List[Tuple[str, str]]]]:
    """Run one repetition-vector iteration symbolically.

    Returns None when the iteration completes; otherwise a map from each
    still-owing actor to ``(reason, channel)`` blocking witnesses.
    """
    chans = _constrained_channels(module)
    static = [
        a for a, ir in module.actors.items()
        if ir.rate.static and repetition.get(a, 0) > 0
    ]
    budget = {a: repetition[a] for a in static}
    fires = {a: 0 for a in static}
    tokens = {id(ch): 0 for (ch, _p, _c, _cap) in chans}
    ins: Dict[str, List] = {a: [] for a in static}
    outs: Dict[str, List] = {a: [] for a in static}
    for entry in chans:
        ch = entry[0]
        if ch.dst in ins:
            ins[ch.dst].append(entry)
        if ch.src in outs:
            outs[ch.src].append(entry)

    def blocked_reasons(a: str) -> List[Tuple[str, str]]:
        why = []
        for (ch, _p, c, _cap) in ins[a]:
            if tokens[id(ch)] < c:
                why.append((
                    f"needs {c} token(s) on {ch} (holds {tokens[id(ch)]})",
                    str(ch),
                ))
        for (ch, p, _c, cap) in outs[a]:
            if cap - tokens[id(ch)] < p:
                why.append((
                    f"needs {p} slot(s) on {ch} "
                    f"(fill {tokens[id(ch)]} of depth {cap})",
                    str(ch),
                ))
        return why

    def can_fire(a: str) -> bool:
        return not blocked_reasons(a)

    def fire(a: str) -> None:
        for (ch, _p, c, _cap) in ins[a]:
            tokens[id(ch)] -= c
        for (ch, p, _c, _cap) in outs[a]:
            tokens[id(ch)] += p
        fires[a] += 1

    progressed = True
    while progressed:
        progressed = False
        for a in static:
            while fires[a] < budget[a] and can_fire(a):
                fire(a)
                progressed = True
        if all(fires[a] >= budget[a] for a in static):
            return None
    return {
        a: blocked_reasons(a)
        for a in static
        if fires[a] < budget[a]
    }


def check_deadlock(
    module, repetition: Optional[Dict[str, int]]
) -> Diagnostics:
    """Emit ``SB102`` when one iteration provably cannot complete."""
    from repro_torch.analysis.rates import _module_origins

    diags = Diagnostics(origins=_module_origins(module))
    if repetition is None:
        return diags  # rates inconsistent: SB101 already rejected it
    stuck = simulate_iteration(module, repetition)
    if stuck is None:
        return diags
    # Only starved *live* actors (path to a sink) reject the program: a dead
    # feedback loop that eliminate-dead kept (fed by a live producer) wedges
    # only itself — the observable outputs still complete, and the SB201
    # dead-actor lint already names it.
    live = set()
    work = [a for a, ir in module.actors.items() if not ir.outputs]
    while work:
        a = work.pop()
        if a in live:
            continue
        live.add(a)
        work.extend(module.predecessors(a) - live)
    stuck = {a: why for a, why in stuck.items() if a in live}
    if not stuck:
        return diags
    detail = "; ".join(
        f"{a} ({' and '.join(r for r, _c in why) if why else 'transitively starved'})"
        for a, why in sorted(stuck.items())
    )
    channels = sorted({c for why in stuck.values() for _r, c in why})
    diags.error(
        "SB102",
        f"sure deadlock: one repetition-vector iteration cannot complete "
        f"at the resolved FIFO depths — blocked: {detail}. A static-rate "
        f"feedback cycle has no initial tokens to start from, and a "
        f"reconvergent path needs its short-side FIFO to absorb the long "
        f"side's firing skew; raise the named depths (connect(depth=...) "
        f"or XCF fifo pins) or break the cycle with a dynamic actor",
        actors=tuple(sorted(stuck)),
        channels=channels,
    )
    return diags
