"""Boundedness, liveness, and placement lints over the lowered IRModule.

Errors (fail ``check=True`` compiles):
  SB103  a FIFO smaller than one firing's token need on either endpoint can
         never be satisfied — the runtime would wedge on its first write.
  SB104  a device staging granule larger than the transfer block — the block
         is the unit PLink stages per invocation, and a whole region
         iteration's worth of a boundary port must fit in one (this is the
         compile-time generalization of the runtime ``block < quantum``
         rejection in ``device_runtime.staging_plan``).

Warnings (reported, never rejected — they describe legal-but-suspect
networks and placements):
  SB201  actors with no path to any sink: they can never affect observable
         output, yet survived eliminate-dead (which only prunes actors
         unreachable *from* the sources).
  SB202  a dynamic-rate actor wedged between static actors inside one device
         region, splitting what would otherwise fuse into a single kernel.
  SB203  a chatty device boundary: more crossing channels than member
         actors — per-token transfer overhead will dominate; the partitioner
         would never pick this placement.
  SB204  unbounded backlog: the producer emits onto a port the consumer
         never consumes in *any* action, so the channel's fill grows without
         bound for as long as the producer runs.
  SB205  a sinkless network: quiescence is defined by sinks draining the
         sources; with no sink the quiescence run-loop never terminates on
         its own (only ``max_rounds``/``max_seconds`` stop it).
  SB206  a crossing FIFO too shallow for the megastep target: the device
         runtime clamps k per partition to ``depth // (2*block)``, so the
         placement runs with less boundary amortization than requested.
"""

from __future__ import annotations

from typing import Dict


from repro_torch.analysis.diagnostics import Diagnostics
from repro_torch.analysis.rates import _module_origins, port_member, region_repetition

__all__ = ["check_buffers", "check_block", "run_lints"]


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def check_buffers(module) -> Diagnostics:
    """SB103: every FIFO must hold at least one firing of both endpoints."""
    diags = Diagnostics(origins=_module_origins(module))
    hw_of = module.hw_assignment()
    for ch in module.channels:
        s_hw, d_hw = hw_of.get(ch.src), hw_of.get(ch.dst)
        if s_hw is not None and s_hw == d_hw:
            continue  # device-internal wire: no FIFO exists at runtime
        cap = ch.resolved_depth
        if cap is None:
            continue
        rs = module.actors[ch.src].rate
        rd = module.actors[ch.dst].rate
        p = rs.produce_rate(ch.src_port) if rs.static else 0
        c = rd.consume_rate(ch.dst_port) if rd.static else 0
        need = max(p, c)
        if need > cap:
            side = "producer" if p >= c else "consumer"
            diags.error(
                "SB103",
                f"channel {ch} has depth {cap} but its {side} moves "
                f"{need} token(s) per firing — the FIFO can never hold one "
                f"firing, so the network wedges on first use; raise the "
                f"depth (connect(depth=...) or an XCF fifo pin) to at "
                f"least {need}",
                actors=(ch.src, ch.dst),
                channels=(ch,),
            )
    return diags


def _region_granules(module, region) -> Dict[str, int]:
    """Staging granule per in-boundary channel of one device region:
    ``consume_rate(port) * q_region[member]`` tokens per region iteration."""
    members = [m for m in region.actors if m in module.actors]
    static = [m for m in members if module.actors[m].rate.static]
    if not static:
        return {}
    q = region_repetition(module, static)
    granules: Dict[str, int] = {}
    member_set = set(members)
    for ch in module.channels:
        if ch.src in member_set or ch.dst not in member_set:
            continue  # want channels crossing *into* the region
        member = port_member(module, ch.dst, ch.dst_port)
        if member not in q:
            continue  # dynamic member: no static granule
        rate = module.actors[ch.dst].rate
        c = rate.consume_rate(ch.dst_port)
        if c > 0:
            granules[str(ch)] = c * q[member]
    return granules


def check_block(module, block: int, megastep_k: int = 1) -> Diagnostics:
    """SB104: every device staging granule must fit in one transfer block —
    a megastep launch stages k blocks, but each *chunk* of the stack is
    still one block, so the quantum bound is unchanged by k.

    SB206 (warning): a crossing FIFO shallower than ``2*k*block`` cannot
    absorb a pipelined megastep launch at the requested k — the device
    runtime clamps k down per partition (``resolve_megastep_k``), so the
    placement still runs, just with less boundary amortization than asked
    for.  Depth inference sizes crossing channels for k; this fires only
    for XCF-pinned or hand-set shallower depths."""
    diags = Diagnostics(origins=_module_origins(module))
    for region in module.hw_regions():
        members = set(region.actors) & set(module.actors)
        for ch_name, granule in sorted(_region_granules(module, region).items()):
            if granule > block:
                diags.error(
                    "SB104",
                    f"block={block} is smaller than the staging quantum "
                    f"{granule} of device boundary channel {ch_name} "
                    f"(partition {region.pe!r}): one region iteration "
                    f"stages {granule} token(s) through this port and must "
                    f"fit in a single block — compile with "
                    f"block>={granule}",
                    actors=tuple(sorted(region.actors)),
                    channels=(ch_name,),
                )
        if megastep_k > 1 and members:
            for ch in module.channels:
                if (ch.src in members) == (ch.dst in members):
                    continue
                depth = ch.resolved_depth
                need = 2 * megastep_k * block
                if depth is not None and depth < need:
                    eff = max(1, depth // (2 * block))
                    diags.warn(
                        "SB206",
                        f"crossing channel {ch} has depth {depth} but the "
                        f"megastep target k={megastep_k} needs "
                        f"{need} (= 2*k*block) to keep a pipelined launch "
                        f"in flight — the runtime clamps this partition to "
                        f"k={eff}; deepen the FIFO (or drop the megastep "
                        f"target) to restore the amortization",
                        actors=(ch.src, ch.dst),
                        channels=(ch,),
                    )
    return diags


# ---------------------------------------------------------------------------
# warnings
# ---------------------------------------------------------------------------


def _lint_dead(module, diags: Diagnostics) -> None:
    sinks = [a for a, ir in module.actors.items() if not ir.outputs]
    live = set(sinks)
    work = list(sinks)
    preds = module.predecessors
    while work:
        a = work.pop()
        for b in preds(a):
            if b not in live:
                live.add(b)
                work.append(b)
    dead = sorted(set(module.actors) - live)
    if dead:
        diags.warn(
            "SB201",
            f"actor(s) {', '.join(dead)} have no path to any sink: they can "
            f"never affect observable output (eliminate-dead only prunes "
            f"actors unreachable from the sources) — remove them or wire "
            f"them to a sink",
            actors=tuple(dead),
        )


def _lint_region_shape(module, diags: Diagnostics) -> None:
    for region in module.hw_regions():
        members = set(region.actors) & set(module.actors)
        # SB202: dynamic actor between static members inside one region
        for m in sorted(members):
            if module.actors[m].rate.static:
                continue
            static_pred = any(
                p in members and module.actors[p].rate.static
                for p in module.predecessors(m)
            )
            static_succ = any(
                s in members and module.actors[s].rate.static
                for s in module.successors(m)
            )
            if static_pred and static_succ:
                diags.warn(
                    "SB202",
                    f"dynamic-rate actor {m!r} sits between static actors "
                    f"inside device partition {region.pe!r}, splitting a "
                    f"region that would otherwise fuse into one kernel — "
                    f"place it on the host or make its rates static",
                    actors=(m,),
                )
        # SB203: chatty boundary
        crossing = [
            ch for ch in module.channels
            if (ch.src in members) != (ch.dst in members)
        ]
        if members and len(crossing) > len(members):
            diags.warn(
                "SB203",
                f"device partition {region.pe!r} has {len(crossing)} "
                f"boundary channel(s) for only {len(members)} member "
                f"actor(s) — per-block transfer overhead will dominate; "
                f"widen the region or move the chatty actors across",
                actors=tuple(sorted(members)),
                channels=tuple(str(c) for c in crossing),
            )


def _lint_backlog(module, diags: Diagnostics) -> None:
    src_graph = getattr(module, "source", None)
    if src_graph is None:
        return
    for ch in module.channels:
        consumer = src_graph.actors.get(ch.dst)
        producer = src_graph.actors.get(ch.src)
        if consumer is None or producer is None:
            continue  # fused actor: members were analyzed pre-fusion
        if not consumer.actions or not producer.actions:
            continue
        drains = any(
            a.consumes.get(ch.dst_port, 0) > 0 for a in consumer.actions
        )
        feeds = any(
            a.produces.get(ch.src_port, 0) > 0 for a in producer.actions
        )
        if feeds and not drains:
            diags.warn(
                "SB204",
                f"channel {ch} backlog is unbounded: {ch.src!r} produces "
                f"on {ch.src_port!r} but no action of {ch.dst!r} ever "
                f"consumes from {ch.dst_port!r} — the FIFO fills and "
                f"stalls the producer forever",
                actors=(ch.src, ch.dst),
                channels=(ch,),
            )


def _lint_sinkless(module, diags: Diagnostics) -> None:
    if any(not ir.outputs for ir in module.actors.values()):
        return
    if not module.actors:
        return
    diags.warn(
        "SB205",
        "network has no sink actor (every actor has outputs): quiescence "
        "is defined by sinks draining the sources, so run() only stops on "
        "max_rounds/max_seconds — add a sink or run with an explicit "
        "budget",
        actors=tuple(sorted(module.actors)),
    )


def run_lints(module) -> Diagnostics:
    diags = Diagnostics(origins=_module_origins(module))
    _lint_dead(module, diags)
    _lint_region_shape(module, diags)
    _lint_backlog(module, diags)
    _lint_sinkless(module, diags)
    return diags
