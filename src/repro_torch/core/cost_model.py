"""The paper's performance model (§III-F + Appendix VII-A), TPU-adapted.

Implements equations (1)–(10) verbatim over profile data:

  T_p        = Σ_a d_p^a · exec(a, p)                       (threads serialize)    (1)
  T_plink    = max_a d_accel^a · exec(a, accel) + T_r + T_w (fabric parallel)      (2)
  T_exec     = max({T_p} ∪ {T_plink}) + T_intra + T_inter                          (3)
  τ_w(n, b)  = ξ_w(b)·⌊n/b⌋ + ξ_w(n mod b)                 (buffered transfers)    (4)
  T_plink^w/r = Σ_{(s,t) crossing} τ(n_(s,t), b_(s,t))                             (5)
  t_intra^p, t_intra^plink, T_intra, T_inter                                       (6–10)

Link models ξ(b) are (latency, bandwidth) affine models — measured on the host
(FIFO round-trips, §VII-C) and analytic for the TPU links (PCIe/ICI/DCN), exactly
as the paper mixes measured CPU cycles with measured OpenCL event times.

The same evaluator scores a *pipeline* of device sub-meshes (the multi-pod
application): partitions = stages, exec(a, stage) = layer time on the stage's
chips, the PLink link model = ICI/DCN hop between stages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple


Assignment = Mapping[str, str]  # actor -> partition id ("accel" = device)

# ---------------------------------------------------------------------------
# Link models ξ(b): seconds to transfer a buffer of b tokens (token_bytes each)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkModel:
    """Affine transfer-time model: ξ(b) = latency + b·token_bytes / bandwidth."""

    name: str
    latency_s: float
    bandwidth_Bps: float
    token_bytes: int = 4

    def xi(self, tokens: int) -> float:
        if tokens <= 0:
            return 0.0
        return self.latency_s + tokens * self.token_bytes / self.bandwidth_Bps

    def tau(self, n: int, b: int) -> float:
        """Equation (4): time to move n tokens through buffers of capacity b."""
        if n <= 0:
            return 0.0
        b = max(1, min(b, n))
        return self.xi(b) * (n // b) + self.xi(n % b)


# Hardware constants (assignment spec: TPU v5e-like).
TPU_PEAK_FLOPS = 197e12  # bf16 / chip
TPU_HBM_BW = 819e9  # B/s / chip
TPU_ICI_BW = 50e9  # B/s / link
TPU_DCN_BW = 6.25e9  # B/s / host pair (50 Gb/s-class inter-pod)
PCIE_BW = 16e9  # B/s host<->device
PCIE_LAT = 20e-6

DEFAULT_LINKS = {
    "intra": LinkModel("intra-core", 2e-8, 20e9),     # same-thread FIFO (cache)
    "inter": LinkModel("inter-core", 1e-7, 4e9),      # cross-thread FIFO (LLC)
    "plink": LinkModel("pcie", PCIE_LAT, PCIE_BW),     # host<->device
    "ici": LinkModel("ici", 1e-6, TPU_ICI_BW),
    "dcn": LinkModel("dcn", 1e-5, TPU_DCN_BW),
}


# ---------------------------------------------------------------------------
# Profile container
# ---------------------------------------------------------------------------


@dataclass
class NetworkProfile:
    """Everything the MILP needs (paper §V-B inputs (i)-(iv))."""

    # exec(a, kind): seconds per *total workload* of actor a on partition kind.
    #   kind "sw" = one host thread; "hw" = the device partition.
    exec_sw: Dict[str, float] = field(default_factory=dict)
    exec_hw: Dict[str, float] = field(default_factory=dict)
    # exec_sw_fused: seconds per total workload when the actor runs inside a
    # fused host region (the fuse-sdf-host-regions block executor) instead of
    # its per-token interpreter.  Measured by profiler.profile_host_fused /
    # live server telemetry; empty means "no fused host rate known" and the
    # evaluator falls back to exec_sw everywhere.
    exec_sw_fused: Dict[str, float] = field(default_factory=dict)
    # tokens moved per connection over the workload: key (src, src_port, dst, dst_port)
    tokens: Dict[Tuple[str, str, str, str], int] = field(default_factory=dict)
    # buffer sizes per connection (for τ); default used when missing
    buffers: Dict[Tuple[str, str, str, str], int] = field(default_factory=dict)
    default_buffer: int = 4096
    links: Dict[str, LinkModel] = field(default_factory=lambda: dict(DEFAULT_LINKS))
    # True when exec_sw was measured in situ (firing times already include
    # same-thread FIFO reads/writes): the intra term is then zero and the inter
    # term only charges the *additional* cost of crossing a thread.
    in_situ: bool = True
    # Physical cores available: threads beyond this serialize (the paper pins
    # threads to dedicated cores and never exceeds them; the DSE must know).
    n_cores: Optional[int] = None
    # Device megastep target: repetition-vector iterations per launch.  The
    # PLink lane terms in eq. (4)/(5) amortize the per-launch boundary cost
    # over k·b-token staged transfers (one launch moves k buffers' worth),
    # so `explore()` prices megastep placements at their real boundary tax.
    megastep_k: int = 1

    def exec_time(self, actor: str, partition: str, accel) -> float:
        accels = {accel} if isinstance(accel, str) else set(accel)
        if partition in accels:
            return self.exec_hw.get(actor, math.inf)
        return self.exec_sw.get(actor, 0.0)

    def sw_bound(self, actor: str) -> float:
        """Admissible (never over-estimating) software time: the fused host
        rate when one is known, else the interpreted rate — what branch &
        bound may use as a partition-load lower bound."""
        t = self.exec_sw.get(actor, 0.0)
        f = self.exec_sw_fused.get(actor)
        return t if f is None else min(t, f)


def host_fused_actors(graph, assignment: Assignment, prof, accels) -> set:
    """Actors the evaluator charges at the *fused* host rate under this
    assignment: actors with a measured fused rate that share a software
    partition with at least one fused-rate neighbor.

    This is the cost-model approximation of the fuse-sdf-host-regions rule
    (connected static-rate stream-op groups of >= 2 fuse; singletons stay
    interpreted) — the evaluator cannot re-run the detection pass per
    candidate, but adjacency-of-fusable-neighbors matches it exactly on the
    graphs the pass accepts, since fused rates are only ever measured for
    actors the pass found fusable in the first place.
    """
    fusable = {
        a for a in prof.exec_sw_fused
        if a in assignment and assignment[a] not in accels
    }
    out = set()
    for ch in graph.channels:
        if (
            ch.src in fusable
            and ch.dst in fusable
            and assignment[ch.src] == assignment[ch.dst]
        ):
            out.add(ch.src)
            out.add(ch.dst)
    return out


# ---------------------------------------------------------------------------
# Equations (1)-(10)
# ---------------------------------------------------------------------------


def evaluate(
    graph,
    assignment: Assignment,
    prof: NetworkProfile,
    *,
    accel="accel",  # str | Iterable[str]: accelerator partition id(s)
    plink_thread: Optional[str] = None,
    megastep_k: Optional[int] = None,
) -> Dict[str, float]:
    """Predicted execution time for one partitioning (the MILP objective).

    ``accel`` may name several accelerator partitions: each gets its own
    PLink-lane term (equations (2) + (5) per partition).  Lanes run
    independently pipelined async dispatches, so the model takes the *max*
    over lanes, not the sum — the per-accelerator capacity story that lets
    the DSE trade one big device partition against k smaller ones.  A
    device→device channel is charged as a staged read on the producing lane
    and a staged write on the consuming lane.
    """
    accels = {accel} if isinstance(accel, str) else set(accel)
    parts = sorted({p for p in assignment.values() if p not in accels})
    threads = parts
    p1 = plink_thread or (threads[0] if threads else None)
    used_accels = sorted({p for p in assignment.values() if p in accels})

    # (1) thread times — actors co-located with a fused-rate neighbor are
    # charged their host-fused coefficient (the block executor's measured
    # rate) instead of the per-token interpreter's, so `explore()` prices
    # host design points at what the runtime will actually deliver
    fused_on = (
        host_fused_actors(graph, assignment, prof, accels)
        if prof.exec_sw_fused else set()
    )
    T_p: Dict[str, float] = {p: 0.0 for p in threads}
    for a, p in assignment.items():
        if p not in accels:
            T_p[p] += (
                prof.exec_sw_fused[a] if a in fused_on
                else prof.exec_time(a, p, accels)
            )

    # (2) + (5): one PLink lane per accelerator partition.  A megastep
    # launch stages/retires k buffers' worth of tokens per boundary
    # round-trip, so τ's effective buffer is k·b — the per-launch latency
    # term ξ's fixed cost amortizes over k iterations.
    k_mega = max(
        1, prof.megastep_k if megastep_k is None else int(megastep_k)
    )
    T_lane: Dict[str, float] = {}
    link = prof.links["plink"]
    for apid in used_accels:
        hw_times = [
            prof.exec_time(a, apid, accels)
            for a, p in assignment.items()
            if p == apid
        ]
        t_hw = max(hw_times) if hw_times else 0.0
        t_w = t_r = 0.0
        for ch in graph.channels:
            key = ch.key
            n = prof.tokens.get(key, 0)
            b = prof.buffers.get(key, prof.default_buffer) * k_mega
            s_hw = assignment[ch.src] == apid
            t_hw_side = assignment[ch.dst] == apid
            if t_hw_side and not s_hw:
                t_w += link.tau(n, b)
            elif s_hw and not t_hw_side:
                t_r += link.tau(n, b)
        T_lane[apid] = t_hw + t_w + t_r
    T_plink = max(T_lane.values()) if T_lane else 0.0

    # (6)-(9): intra-thread communication.  With in-situ profiles the same-
    # thread FIFO time is already inside exec(a, p), so the term is zero.
    intra = prof.links["intra"]
    t_intra = {p: 0.0 for p in threads}
    if not prof.in_situ:
        for ch in graph.channels:
            key = ch.key
            n = prof.tokens.get(key, 0)
            b = prof.buffers.get(key, prof.default_buffer)
            ps, pt = assignment[ch.src], assignment[ch.dst]
            if ps == pt and ps not in accels:
                t_intra[ps] += intra.tau(n, b)
            # (7): host<->accel staging also costs the PLink's thread
            if p1 is not None and (
                (ps == p1 and pt in accels) or (ps in accels and pt == p1)
            ):
                t_intra[p1] += intra.tau(n, b)
    T_intra = max(t_intra.values()) if t_intra else 0.0

    # (10): inter-thread communication; with in-situ profiles only the *extra*
    # cost over a same-thread channel is charged.
    inter = prof.links["inter"]
    T_inter = 0.0
    for ch in graph.channels:
        key = ch.key
        n = prof.tokens.get(key, 0)
        b = prof.buffers.get(key, prof.default_buffer)
        ps, pt = assignment[ch.src], assignment[ch.dst]
        if ps == pt:
            continue
        s_acc, t_acc = ps in accels, pt in accels
        crosses_thread = (
            not s_acc and not t_acc
        ) or (
            p1 is not None and (
                (t_acc and not s_acc and ps != p1)
                or (s_acc and not t_acc and pt != p1)
            )
        )
        if crosses_thread:
            cost = inter.tau(n, b)
            if prof.in_situ:
                cost = max(0.0, cost - intra.tau(n, b))
            T_inter += cost

    # (3) — with fewer cores than threads, thread times serialize; on a single
    # core even the XLA device program shares it, so T_plink adds rather than
    # overlapping.
    cores = prof.n_cores
    thread_times = list(T_p.values())
    if cores is not None and thread_times and len(thread_times) > cores:
        # pack thread loads onto cores (LPT bound: max(sum/cores, max))
        total = sum(thread_times)
        peak_sw = max(total / cores, max(thread_times))
    else:
        peak_sw = max(thread_times) if thread_times else 0.0
    if cores == 1:
        peak = peak_sw + T_plink
    else:
        peak = max(peak_sw, T_plink)
    T_exec = peak + T_intra + T_inter
    return {
        "T_exec": T_exec,
        "T_plink": T_plink,
        "T_intra": T_intra,
        "T_inter": T_inter,
        **{f"T_plink_{p}": v for p, v in T_lane.items() if len(T_lane) > 1},
        **{f"T_{p}": v for p, v in T_p.items()},
    }


# ---------------------------------------------------------------------------
# LM pipeline profiles (the TPU application of the same model)
# ---------------------------------------------------------------------------


def lm_layer_profile(
    cfg,
    *,
    seq_len: int,
    global_batch: int,
    chips_per_stage: int,
    mfu: float = 0.4,
    train: bool = True,
) -> Tuple[List[str], NetworkProfile]:
    """Per-layer actor profile for an LM: actors = embed, L blocks, head.

    exec_hw(a) = layer FLOPs / (chips·peak·mfu); exec_sw is effectively infinite
    (a CPU host cannot run a 4k-token training step competitively) but finite so
    the model stays total.  Channel tokens = activation elements per step.
    """
    tokens = seq_len * global_batch
    mult = 3.0 if train else 1.0
    d = cfg.d_model
    names: List[str] = ["embed"]
    prof = NetworkProfile()
    pc = cfg.param_counts()

    def hw_time(flops: float) -> float:
        return flops / (chips_per_stage * TPU_PEAK_FLOPS * mfu)

    embed_flops = 2.0 * tokens * d * mult  # gather + scale (cheap)
    prof.exec_hw["embed"] = hw_time(embed_flops)
    prof.exec_sw["embed"] = embed_flops / 50e9
    for i in range(cfg.num_layers):
        name = f"block{i}"
        names.append(name)
        kind = cfg.block_kind(i)
        f = 0.0
        if kind.mixer == "attn":
            f += 2.0 * tokens * d * (cfg.d_attn + 2 * cfg.num_kv_heads * cfg.head_dim)
            f += 2.0 * tokens * cfg.d_attn * d
            f += 4.0 * tokens * seq_len * cfg.d_attn * (0.5 if train else 1.0)
        else:
            di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
            f += 2.0 * tokens * d * (2 * di + 2 * ds + nh) + 2.0 * tokens * di * d
            f += 4.0 * tokens * cfg.ssm_chunk * di  # intra-chunk quadratic
            f += 6.0 * tokens * di * ds  # state update + output
        if kind.ffn == "dense":
            f += 6.0 * tokens * d * cfg.d_ff
        elif kind.ffn == "moe":
            active = cfg.experts_per_token + cfg.num_shared_experts
            f += 6.0 * tokens * d * cfg.moe_d_ff * active * cfg.capacity_factor
            f += 2.0 * tokens * d * cfg.num_experts / 1e3  # router (negligible)
        f *= mult
        prof.exec_hw[name] = hw_time(f)
        prof.exec_sw[name] = f / 50e9  # ~50 GFLOP/s host
    names.append("head")
    head_flops = 2.0 * tokens * d * cfg.padded_vocab * mult
    prof.exec_hw["head"] = hw_time(head_flops)
    prof.exec_sw["head"] = head_flops / 50e9

    act_bytes = 2  # bf16 stream
    for i in range(len(names) - 1):
        key = (names[i], "OUT", names[i + 1], "IN")
        prof.tokens[key] = tokens * d
        prof.buffers[key] = tokens * d
    prof.links = dict(DEFAULT_LINKS)
    prof.links["plink"] = prof.links["ici"]  # stage crossings ride ICI/DCN
    for k in prof.links:
        prof.links[k] = LinkModel(
            prof.links[k].name, prof.links[k].latency_s,
            prof.links[k].bandwidth_Bps, token_bytes=act_bytes,
        )
    return names, prof
