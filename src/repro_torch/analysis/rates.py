"""SDF rate-consistency analysis: balance equations and repetition vectors.

For every channel ``src.p -> dst.q`` between two *static-rate* actors the
balance equation

    produce_rate(src, p) * q[src] == consume_rate(dst, q) * q[dst]

must admit a positive integer solution ``q`` (the repetition vector): firing
each actor ``q[a]`` times moves every channel back to its starting fill, so
the network can run forever in bounded memory.  An inconsistent system means
some channel's backlog grows (or starves) without bound every iteration —
the network is rejected with ``SB101`` before any thread spins up.

Dynamic (DDF) actors — guarded actions, multiple actions — have no static
rates to balance: edges touching them contribute no equation, and each
maximal *static* component is solved independently (so the paper's TopFilter,
whose Filter is dynamic, type-checks without false positives).

The same solver, restricted to one region's member set, replaces the ad-hoc
``lcm``-of-all-rates math previously duplicated in ``ir/fusion.py`` and the
device staging plan: the tokens one boundary port must be staged in per
region iteration is exactly ``consume_rate(port) * q[member]`` — the
repetition vector is the single source of truth for quanta.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.diagnostics import Diagnostics

__all__ = [
    "repetition_vector",
    "solve_rates",
    "member_rates",
    "region_repetition",
    "port_member",
]


def _normalize(q: Dict[str, Fraction]) -> Dict[str, int]:
    """Scale a fractional solution to the minimal positive integer vector."""
    scale = math.lcm(*(f.denominator for f in q.values()))
    ints = {a: int(f * scale) for a, f in q.items()}
    g = math.gcd(*ints.values())
    return {a: v // g for a, v in ints.items()}


def repetition_vector(
    nodes: Sequence[str],
    rate_of,  # name -> RateSig-like (consume_rate/produce_rate/static)
    edges: Sequence[Tuple[str, str, str, str]],  # (src, sport, dst, dport)
) -> Optional[Dict[str, int]]:
    """Minimal positive integer solution of the balance equations over
    ``nodes``, or None when the system is inconsistent.

    Only edges between two static endpoints with nonzero rates constrain the
    system; every unconstrained node gets ``q = 1`` (fires at its own pace —
    dynamic actors, isolated members).  The result is minimal per connected
    component of the constraint graph.
    """
    nodes = list(nodes)
    node_set = set(nodes)
    adj: Dict[str, List[Tuple[str, Fraction]]] = {a: [] for a in nodes}
    for (src, sport, dst, dport) in edges:
        if src not in node_set or dst not in node_set:
            continue
        rs, rd = rate_of(src), rate_of(dst)
        if not (rs.static and rd.static):
            continue
        p, c = rs.produce_rate(sport), rd.consume_rate(dport)
        if p <= 0 or c <= 0:
            continue
        # q[src] * p == q[dst] * c
        adj[src].append((dst, Fraction(p, c)))
        adj[dst].append((src, Fraction(c, p)))

    q: Dict[str, int] = {}
    seen: Dict[str, Fraction] = {}
    for start in nodes:
        if start in seen:
            continue
        comp: Dict[str, Fraction] = {start: Fraction(1)}
        work = [start]
        while work:
            a = work.pop()
            for (b, ratio) in adj[a]:
                want = comp[a] * ratio
                if b in comp:
                    if comp[b] != want:
                        return None  # inconsistent
                else:
                    comp[b] = want
                    work.append(b)
        seen.update(comp)
        q.update(_normalize(comp))
    return q


def solve_rates(module) -> Tuple[Optional[Dict[str, int]], Diagnostics]:
    """Solve the balance equations of a lowered module.

    Returns ``(repetition, diagnostics)``: ``repetition`` maps every actor to
    its fires-per-iteration (minimal per static component, 1 for dynamic /
    unconstrained actors), or None when inconsistent — in which case the
    diagnostics carry an ``SB101`` error naming a witness channel.
    """
    diags = Diagnostics(origins=_module_origins(module))

    def rate_of(a):
        return module.actors[a].rate

    # BFS with fractional firing ratios; the first edge whose implied ratio
    # contradicts the partial assignment is the witness channel for SB101.
    constrained = []
    for ch in module.channels:
        rs, rd = rate_of(ch.src), rate_of(ch.dst)
        if not (rs.static and rd.static):
            continue
        p, c = rs.produce_rate(ch.src_port), rd.consume_rate(ch.dst_port)
        if p > 0 and c > 0:
            constrained.append((ch, p, c))
    adj: Dict[str, List[Tuple[str, Fraction, object, int, int]]] = {
        a: [] for a in module.actors
    }
    for (ch, p, c) in constrained:
        adj[ch.src].append((ch.dst, Fraction(p, c), ch, p, c))
        adj[ch.dst].append((ch.src, Fraction(c, p), ch, p, c))

    assigned: Dict[str, Fraction] = {}
    q: Dict[str, int] = {}
    for start in module.actors:
        if start in assigned:
            continue
        comp: Dict[str, Fraction] = {start: Fraction(1)}
        work = [start]
        while work:
            a = work.pop()
            for (b, ratio, ch, p, c) in adj[a]:
                want = comp[a] * ratio
                if b in comp:
                    if comp[b] != want:
                        diags.error(
                            "SB101",
                            f"inconsistent SDF rates: channel {ch} requires "
                            f"q[{ch.src}]*{p} == q[{ch.dst}]*{c}, which "
                            f"contradicts the firing ratio the rest of the "
                            f"network implies for {ch.src!r} and {ch.dst!r} "
                            f"— the balance equations have no solution, so "
                            f"this channel's backlog diverges every "
                            f"iteration",
                            actors=(ch.src, ch.dst),
                            channels=(ch,),
                        )
                        return None, diags
                else:
                    comp[b] = want
                    work.append(b)
        assigned.update(comp)
        q.update(_normalize(comp))
    return q, diags


def _module_origins(module) -> Dict[str, str]:
    src = getattr(module, "source", None)
    return dict(getattr(src, "origins", {}) or {})


# ---------------------------------------------------------------------------
# Region-restricted repetition vectors (the staging/fusion consumers)
# ---------------------------------------------------------------------------


def member_rates(module, members: Sequence[str]):
    """``(rate_of, edges)`` for a member set, robust to device fusion having
    already removed the members from ``module.actors``: rates are recovered
    from the authored source graph (never mutated) when needed."""
    from repro_torch.ir.ir import RateSig

    rates = {}
    for m in members:
        ir = module.actors.get(m)
        if ir is not None:
            rates[m] = ir.rate
        else:
            src = getattr(module, "source", None)
            impl = src.actors.get(m) if src is not None else None
            assert impl is not None, f"no rate signature for member {m!r}"
            rates[m] = RateSig.of(impl)
    sub = set(members)
    edges = []
    seen_keys = set()
    for ch in module.channels:
        if ch.src in sub and ch.dst in sub:
            edges.append((ch.src, ch.src_port, ch.dst, ch.dst_port))
            seen_keys.add((ch.src, ch.src_port, ch.dst, ch.dst_port))
    src = getattr(module, "source", None)
    if src is not None:  # post-fusion: internal edges live only in the source
        for ch in src.channels:
            key = (ch.src, ch.src_port, ch.dst, ch.dst_port)
            if ch.src in sub and ch.dst in sub and key not in seen_keys:
                edges.append(key)
    return (lambda a: rates[a]), edges


def region_repetition(module, members: Sequence[str]) -> Dict[str, int]:
    """Minimal repetition vector restricted to one region's member set.

    This is deliberately *not* the global ``meta["repetition"]`` entry
    restricted to the members: the global vector is minimal per whole static
    component, which may scale the members up by context outside the region;
    staging and fusion need the region's own minimal iteration.
    """
    rate_of, edges = member_rates(module, members)
    q = repetition_vector(list(members), rate_of, edges)
    assert q is not None, (
        f"inconsistent rates inside region {sorted(members)} — "
        f"streamcheck (SB101) should have rejected this module"
    )
    return q


def port_member(module, actor: str, port: str) -> str:
    """The authored member an actor's port belongs to.

    Fused device actors expose boundary ports named ``member__PORT``; every
    other actor owns its ports directly.
    """
    ir = module.actors[actor]
    if ir.fused_from and "__" in port:
        m = port.split("__", 1)[0]
        if m in ir.fused_from:
            return m
    return actor
