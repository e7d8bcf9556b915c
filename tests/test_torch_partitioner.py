"""The profile-guided partitioner of the PyTorch port against the JAX package,
on the CPU.

Pure-Python parts (cost model, MILP solvers, design-space exploration, link
fits, telemetry and trace ingestion) must agree bitwise: the same
``NetworkProfile`` gives the same assignments, the same objectives and the
same XCF text.  ``Program.profile(device="cpu")`` counts the same tokens and
buffers as the reference's ``profile_host`` and times the same actors on the
device side.  The multi-partition exploration runs on a pinned profile, so
the placement it checks cannot follow the host's load.
"""

import dataclasses
import math

import numpy as np
import pytest

import repro_torch
from repro.apps.streams import NETWORKS as JNETS
from repro.core import cost_model as jcost
from repro.core import milp as jmilp
from repro.core import partitioner as jpart
from repro.core import profiler as jprof
from repro.serve_stream.telemetry import ServerTelemetry as JTelemetry
from repro_torch.apps.streams import NETWORKS as TNETS
from repro_torch.core import cost_model as tcost
from repro_torch.core import milp as tmilp
from repro_torch.core import partitioner as tpart
from repro_torch.core import profiler as tprof
from repro_torch.serve_stream.telemetry import ServerTelemetry as TTelemetry

GRAPHS = {"IDCT8": 16, "TopFilter": 256, "FIR32": 64}


def _graphs(name, size=None, taps=None):
    size = GRAPHS[name] if size is None else size
    out = []
    for nets in (JNETS, TNETS):
        if name == "FIR32":
            net, _ = nets[name](taps=taps or 32, n=size)
        else:
            net, _ = nets[name](size)
        out.append(net.graph())
    return out


def _profiles(graph, seed):
    """The same hand-built profile in both packages."""
    out = []
    for cost in (jcost, tcost):
        prof = cost.NetworkProfile()
        r = np.random.default_rng(seed)
        for a in sorted(graph.actors):
            prof.exec_sw[a] = float(r.uniform(1e-4, 5e-3))
            if graph.actors[a].device_ok:
                prof.exec_hw[a] = float(r.uniform(1e-6, 1e-3))
            if r.random() < 0.5:
                prof.exec_sw_fused[a] = prof.exec_sw[a] * 0.3
        for ch in graph.channels:
            prof.tokens[ch.key] = int(r.integers(100, 5000))
            prof.buffers[ch.key] = int(r.choice([256, 1024, 4096]))
        prof.links["intra"] = cost.LinkModel("intra-core", 2e-7, 3e9)
        prof.links["inter"] = cost.LinkModel("inter-core", 3e-6, 1e9)
        prof.n_cores = 4
        out.append(prof)
    return out


def _same_solution(a, b):
    assert a.assignment == b.assignment
    assert a.objective == b.objective  # bitwise
    assert a.detail == b.detail
    assert a.solver == b.solver


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_matches_reference(name, seed):
    jg, tg = _graphs(name)
    jp, tp = _profiles(jg, seed)
    actors = sorted(jg.actors)
    rng = np.random.default_rng(seed + 7)
    for _ in range(8):
        asg = {}
        for a in actors:
            choices = ["t0", "t1"] + (["accel"] if jg.actors[a].device_ok else [])
            asg[a] = str(rng.choice(choices))
        assert tcost.evaluate(tg, asg, tp) == jcost.evaluate(jg, asg, jp)


@pytest.mark.parametrize("name", ["IDCT8", "TopFilter"])
@pytest.mark.parametrize("solver", ["solve", "solve_exact", "solve_bb", "solve_anneal"])
def test_solvers_match_reference(name, solver):
    jg, tg = _graphs(name)
    jp, tp = _profiles(jg, 3)
    parts = ["t0", "t1", "accel"]
    kw = dict(iters=400, restarts=2) if solver == "solve_anneal" else {}
    j = getattr(jmilp, solver)(jg, jp, parts, **kw)
    t = getattr(tmilp, solver)(tg, tp, parts, **kw)
    _same_solution(t, j)


def test_anneal_and_bb_on_fir32_match_reference():
    """FIR32's 36 actors are past the exact solver: ``solve`` anneals."""
    jg, tg = _graphs("FIR32")
    jp, tp = _profiles(jg, 5)
    parts = ["t0", "t1", "accel"]
    _same_solution(
        tmilp.solve_anneal(tg, tp, parts, iters=300, restarts=1, seed=4),
        jmilp.solve_anneal(jg, jp, parts, iters=300, restarts=1, seed=4),
    )
    jg, tg = _graphs("FIR32", taps=4)
    jp, tp = _profiles(jg, 6)
    _same_solution(
        tmilp.solve_bb(tg, tp, ["t0", "accel"]),
        jmilp.solve_bb(jg, jp, ["t0", "accel"]),
    )


def test_chain_dp_matches_reference():
    rng = np.random.default_rng(11)
    names = [f"l{i}" for i in range(9)]
    exec_time = {n: float(rng.uniform(0.1, 2.0)) for n in names}
    cost = {i: float(rng.uniform(0.0, 0.3)) for i in range(1, 9)}
    for k in (1, 2, 3, 5):
        assert tmilp.solve_chain_dp(names, exec_time, cost.get, k) == (
            jmilp.solve_chain_dp(names, exec_time, cost.get, k)
        )


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_explore_matches_reference(name):
    jg, tg = _graphs(name, taps=4)
    jp, tp = _profiles(jg, 2)
    kw = dict(thread_counts=(1, 2), accel_options=(False, True), megastep_k=4)
    jpts = jpart.explore(jg, jp, **kw)
    tpts = tpart.explore(tg, tp, **kw)
    assert len(tpts) == len(jpts) > 0
    for t, j in zip(tpts, jpts):
        _same_solution(t.solution, j.solution)
        assert t.xcf.to_xml() == j.xcf.to_xml()
        assert (t.n_threads, t.use_accel, t.accel_ids) == (j.n_threads, j.use_accel, j.accel_ids)
        assert t.hw_actors() == j.hw_actors()
    assert tpart.best_point(tpts).xcf.to_xml() == jpart.best_point(jpts).xcf.to_xml()
    assert [p.xcf.to_xml() for p in tpart.pareto(tpts)] == [
        p.xcf.to_xml() for p in jpart.pareto(jpts)
    ]


def test_explore_lm_matches_reference():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    kw = dict(seq_len=2048, global_batch=64, total_chips=8, stage_options=(1, 2, 4))
    jplans = jpart.explore_lm(jget("smollm-135m"), **kw)
    tplans = tpart.explore_lm(tget("smollm-135m"), **kw)
    assert [(p.num_stages, p.stage_of_layer, p.bottleneck_s) for p in tplans] == [
        (p.num_stages, p.stage_of_layer, p.bottleneck_s) for p in jplans
    ]


def test_fit_link_model_is_bitwise():
    sizes = [256, 1024, 4096, 16384, 65536]
    times = [1.3e-5, 1.9e-5, 4.4e-5, 1.41e-4, 5.2e-4]
    t = tprof.fit_link_model("pcie", sizes, times)
    j = jprof.fit_link_model("pcie", sizes, times)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _telemetry(cls):
    t = cls()
    t.actor_fired("source", 512, 2_000_000)
    t.actor_fired("descale", 512, 3_000_000)
    t.actor_fired("hostfused:idct+clip", 64, 5_000_000)
    t.link_moved(("source", "OUT", "descale", "IN"), 512)
    t.link_moved(("descale", "OUT", "idct", "IN"), 512)
    t.device_dispatched(3, 512, width=4)
    t.device_retired(512, 7_000_000)
    return t.snapshot()


def test_profile_from_telemetry_matches_reference():
    jg, tg = _graphs("IDCT8")
    jbase, tbase = _profiles(jg, 9)
    j = jprof.profile_from_telemetry(jg, _telemetry(JTelemetry), jbase)
    t = tprof.profile_from_telemetry(tg, _telemetry(TTelemetry), tbase)
    for field in ("exec_sw", "exec_sw_fused", "exec_hw", "tokens", "buffers", "n_cores"):
        assert getattr(t, field) == getattr(j, field), field


def test_profile_from_trace_matches_reference():
    net, _ = TNETS["IDCT8"](32)
    rep = repro_torch.compile(net, backend="device", block=64, device="cpu").run(trace=True)
    jg, tg = _graphs("IDCT8", 32)
    j = jprof.profile_from_trace(jg, rep.trace)
    t = tprof.profile_from_trace(tg, rep.trace)
    assert t.exec_sw and t.tokens
    for field in ("exec_sw", "exec_sw_fused", "exec_hw", "tokens"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("name", ["IDCT8", "TopFilter", "ZigZag"])
def test_program_profile_on_cpu_matches_reference_counts(name):
    size = {"IDCT8": 16, "TopFilter": 256, "ZigZag": 4}[name]
    jnet, _ = JNETS[name](size)
    jg = jnet.graph()
    jp, _rt = jprof.profile_host(jg)
    jp = jprof.profile_device(jg, jp, block=128)

    net, _ = TNETS[name](size)
    prof = repro_torch.compile(net, device="cpu").profile(block=128, bandwidth_sizes=(64, 256))
    assert prof.tokens == jp.tokens
    assert prof.buffers == jp.buffers
    assert set(prof.exec_hw) == set(jp.exec_hw) != set()
    assert set(prof.exec_sw) == set(jp.exec_sw)
    times = [*prof.exec_hw.values(), *prof.exec_sw.values(), *prof.exec_sw_fused.values()]
    assert all(math.isfinite(x) and x > 0 for x in times), times
    assert prof.links["intra"].bandwidth_Bps > 0 and prof.links["inter"].bandwidth_Bps > 0


def _pinned_idct8(cost):
    """IDCT8's profile with the device far cheaper than the host: the MILP
    places all three device actors whatever the host's load."""
    jg, _ = _graphs("IDCT8")
    prof = cost.NetworkProfile()
    for a in jg.actors:
        prof.exec_sw[a] = 1e-2
        if jg.actors[a].device_ok:
            prof.exec_hw[a] = 1e-5
    for ch in jg.channels:
        prof.tokens[ch.key] = 128
        prof.buffers[ch.key] = 4096
    prof.n_cores = 4
    return prof


def test_explore_emits_multi_partition_points_on_a_pinned_profile():
    net, got = TNETS["IDCT8"](16)
    prog = repro_torch.compile(net, block=128, device="cpu")
    kw = dict(thread_counts=(1,), accel_options=(0, 1, 2), accel_capacity=2)
    points = prog.explore(_pinned_idct8(tcost), **kw)
    jpoints = jpart.explore(_graphs("IDCT8")[0], _pinned_idct8(jcost), megastep_k=4, **kw)
    assert [p.xcf.to_xml() for p in points] == [p.xcf.to_xml() for p in jpoints]
    by_accels = {p.n_accels: p for p in points}
    assert set(by_accels) == {0, 1, 2}
    two = by_accels[2]
    used = {pid for pid in two.solution.assignment.values() if pid in two.accel_ids}
    assert len(used) == 2  # capacity 2 cannot hold all three device actors
    hw_parts = [p for p in two.xcf.partitions.values() if p.code_generator == "hw"]
    assert len(hw_parts) == 2 and all(0 < len(p.instances) <= 2 for p in hw_parts)

    single = prog.repartition(backend="device")
    single.run()
    ref = list(got)
    placed = prog.repartition(xcf=two.xcf)
    assert len(placed.hw_partitions) == 2
    rep = placed.run()
    assert rep.plink_launches > 0
    assert list(got) == ref  # 2 partitions == 1 partition, bitwise


def test_measure_device_link_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the link is measured by chip_smoke.py")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tprof.measure_device_link()


def test_graphed_step_refuses_arguments_off_its_device(monkeypatch):
    """``capture_step`` (the CUDA-graph capture ``profile_device`` times on
    the card, ROADMAP C8) refuses arguments that lie elsewhere instead of
    running them eagerly; on the CPU ``profile_device`` times the eager
    step and captures no graph."""
    import torch

    step = lambda state, ins: (state, ins, None)  # noqa: E731
    cpu_ins = {"a.x": (torch.zeros(4), torch.ones(4, dtype=torch.bool))}
    for device in ("cuda:0", "cpu"):
        with pytest.raises(ValueError, match="must lie on one CUDA device"):
            tprof.capture_step(step, {}, cpu_ins, device)

    def refuse(*a, **k):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(tprof, "capture_step", refuse)
    net, _ = TNETS["IDCT8"](64)
    prog = repro_torch.compile(net, block=64, device="cpu")
    prof = prog.profile(block=64, include_links=False)
    assert prof.exec_hw and all(t > 0 for t in prof.exec_hw.values())


# Bitonic8: ce0 feeds ce4 on the device and ce5 on the host, and both feed
# ce8, so {ce0, ce4, ce8} is one connected part that a path through the host
# leaves (ce0 -> ce5) and re-enters (ce5 -> ce8)
SELF_FEEDING = {"ce0", "ce4", "ce8"}


@pytest.mark.parametrize("name, hw, loops", [
    ("Bitonic8", SELF_FEEDING, True),
    ("Bitonic8", {"ce0", "ce4"}, False),  # ce0 -> ce5 -> ce8 never comes back
    ("Bitonic8", {f"ce{i}" for i in range(24)}, False),
    ("IDCT8", {"descale", "clip"}, False),  # two parts, idct between them
    ("IDCT8", {"descale", "idct", "clip"}, False),
])
def test_self_feeding_placements_are_refused(name, hw, loops):
    """A placement whose connected device part feeds itself through the host
    (which ``explore()`` can emit where device placements tie) raises at
    compile time instead of stalling PLink; every other placement compiles
    and runs bitwise the host."""
    from repro_torch.core.xcf import make_xcf
    from repro_torch.frontend.dsl import FrontendError
    from repro_torch.runtime.device_runtime import feeds_itself

    net, got = TNETS[name](16)
    prog = repro_torch.compile(net, backend="host", block=128, device="cpu")
    prog.run()
    host = list(got)
    xcf = make_xcf(name, {a: ("accel" if a in hw else "t0") for a in prog.graph.actors})
    assert (feeds_itself(prog.graph.channels, hw) is not None) == loops
    if loops:
        assert feeds_itself(prog.graph.channels, hw) == ("ce0", "ce8")
        with pytest.raises(FrontendError, match="'accel' feeds itself"):
            prog.repartition(xcf=xcf)
        return
    placed = prog.repartition(xcf=xcf)
    rep = placed.run()
    assert rep.plink_launches > 0
    out = list(got)
    assert len(out) == len(host) > 0
    if name == "Bitonic8":
        assert out == host
    else:
        assert np.allclose(out, host, rtol=1e-5, atol=1e-4)
