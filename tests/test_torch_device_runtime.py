"""The port's device partitions against the JAX package's.

For every Table-I network, fused and unfused, the two packages' compiled
partitions agree in their boundary ports, staging quanta and megastep shape,
and one launch on the same staged ``(vals, mask)`` blocks (numpy-seeded)
gives the same outputs, masks and idle flag: bitwise for TopFilter, Bitonic8
and ZigZag; for FIR32 and IDCT8 within ``rtol=1e-6, atol=1e-5`` (XLA may
contract ``a + c*x`` into an FMA and may sum ``matmul8`` in another order;
the port does neither).  A stateful partition's state carries across
packages through numpy, both ways, and continues bitwise.
"""

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.apps.streams import NETWORKS as JNETS
from repro.core import actor as jactor
from repro.core import graph as jgraph
from repro.core.xcf import make_xcf as jmake_xcf
from repro_torch.apps.streams import NETWORKS as TNETS
from repro_torch.core import actor as tactor
from repro_torch.core import graph as tgraph
from repro_torch.core.xcf import make_xcf as tmake_xcf
from repro_torch.runtime.device_runtime import (
    resolve_pe_device,
    state_from_numpy,
    state_to_numpy,
)

BLOCK = 64
EXACT = {"TopFilter", "Bitonic8", "ZigZag"}


def _build(nets, name):
    return nets[name](n=64) if name == "FIR32" else nets[name](8)


def _programs(name, **kw):
    jnet, _ = _build(JNETS, name)
    tnet, _ = _build(TNETS, name)
    jp = repro.compile(jnet, backend="device", block=BLOCK, **kw).device_program()
    tp = repro_torch.compile(
        tnet, backend="device", block=BLOCK, device="cpu", **kw
    ).device_program()
    return jp, tp


def _staged(prog, seed=0):
    """One launch's staged inputs: integer-valued tokens (as the sources
    make them), the first few hundred positions valid."""
    rng = np.random.default_rng(seed)
    shape = (prog.megastep_k, BLOCK) if prog.megastep_k > 1 else (BLOCK,)
    n_valid = int(np.prod(shape)) * 3 // 4
    out = {}
    for (a, p, _dt) in prog.in_ports:
        vals = rng.integers(0, 256, size=shape).astype(np.float32)
        mask = (np.arange(vals.size) < n_valid).reshape(shape)
        out[f"{a}.{p}"] = (vals, mask)
    return out


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", sorted(JNETS))
def test_partition_matches_jax(name, fuse):
    jp, tp = _programs(name, fuse=fuse)
    assert tp.in_ports == jp.in_ports and tp.out_ports == jp.out_ports
    assert tp.in_quanta == jp.in_quanta and tp.in_groups == jp.in_groups
    assert (tp.megastep_k, tp.flat_megastep) == (jp.megastep_k, jp.flat_megastep)
    assert tp.actors == jp.actors and tp.fused == jp.fused
    assert tp.device == torch.device("cpu")

    staged = _staged(jp)
    _js, jouts, jidle = jp.launch(jp.init_state, staged)
    _ts, touts, tidle = tp.launch(
        tp.init_state,
        {k: (torch.from_numpy(v), torch.from_numpy(m)) for k, (v, m) in staged.items()},
    )
    assert bool(tidle) == bool(jidle) is False
    assert sorted(touts) == sorted(jouts)
    for key, (jv, jm) in jouts.items():
        tv, tm = touts[key]
        jv, jm = np.asarray(jv), np.asarray(jm)
        np.testing.assert_array_equal(tm.numpy(), jm)
        if name in EXACT:
            np.testing.assert_array_equal(tv.numpy(), jv)
        else:
            np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-5)


def test_idle_flag_on_an_empty_block():
    jp, tp = _programs("IDCT8")
    staged = {
        k: (torch.zeros_like(torch.from_numpy(v)), torch.zeros_like(torch.from_numpy(m)))
        for k, (v, m) in _staged(jp).items()
    }
    _s, _o, idle = tp.launch(tp.init_state, staged)
    assert idle.dtype == torch.bool and idle.shape == () and bool(idle)


def _chain(pkg_actor, pkg_graph, make_xcf, stateful=True):
    """source -> dev (a running sum, or a stateless doubling) -> sink; small
    integers, so float32 sums are exact."""
    g = pkg_graph.ActorGraph("mega")
    g.add(pkg_actor.source_actor(
        "source", lambda st: ({"i": st.get("i", 0) + 1}, 1.0),
        has_next=lambda st: st.get("i", 0) < 64,
    ))

    def fn(st, v):
        acc = st.get("acc", 0.0) + v
        return {"acc": acc}, acc

    if stateful:
        g.add(pkg_actor.simple_actor("dev", fn, state={"acc": 0.0}))
    else:
        g.add(pkg_actor.simple_actor("dev", lambda st, v: (st, v * 2.0)))
    g.add(pkg_actor.sink_actor("sink", lambda st, v: st))
    g.connect("source", "dev")
    g.connect("dev", "sink")
    return g, make_xcf(g.name, {"source": "t0", "dev": "accel", "sink": "t0"})


def _chain_blocks(n, seed=3):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-3, 4, size=(n, BLOCK)).astype(np.float32)
    mask = np.ones((n, BLOCK), bool)
    mask[-1, BLOCK // 2:] = False  # a ragged last block
    return [{"dev.IN": (vals[i], mask[i])} for i in range(n)]


def test_state_carries_across_packages_bitwise():
    jg, jx = _chain(jactor, jgraph, jmake_xcf)
    tg, tx = _chain(tactor, tgraph, tmake_xcf)
    jp = repro.compile(jg, jx, block=BLOCK).device_program()
    tp = repro_torch.compile(tg, tx, block=BLOCK, device="cpu").device_program()
    assert jp.megastep_k == tp.megastep_k == 1  # stateful: clamped

    blocks = _chain_blocks(6)
    jstate = jax.tree.map(lambda x: x, jp.init_state)
    for b in blocks[:3]:  # a few steps in JAX
        jstate, _o, _i = jp.step(jstate, b)
    carried = jax.device_get(jstate)

    # JAX -> port: continue in the port, bitwise equal to JAX continuing
    tstate = state_from_numpy(tp, carried)
    assert tstate["dev"]["acc"].dtype == torch.float32
    jcont = jax.tree.map(np.asarray, carried)
    for b in blocks[3:]:
        jcont, jouts, jidle = jp.step(jcont, b)
        tstate, touts, tidle = tp.step(
            tstate, {k: (torch.from_numpy(v), torch.from_numpy(m)) for k, (v, m) in b.items()}
        )
        for key, (jv, jm) in jouts.items():
            np.testing.assert_array_equal(touts[key][0].numpy(), np.asarray(jv))
            np.testing.assert_array_equal(touts[key][1].numpy(), np.asarray(jm))
        assert bool(tidle) == bool(jidle)
    back = state_to_numpy(tp, tstate)
    np.testing.assert_array_equal(back["dev"]["acc"], np.asarray(jcont["dev"]["acc"]))

    # port -> JAX: the port's state continues in JAX as the port continues
    extra = _chain_blocks(2, seed=4)
    jstate2 = jax.device_put(back)
    for b in extra:
        jstate2, jouts, _ = jp.step(jstate2, b)
        tstate, touts, _ = tp.step(
            tstate, {k: (torch.from_numpy(v), torch.from_numpy(m)) for k, (v, m) in b.items()}
        )
        np.testing.assert_array_equal(
            touts["dev.OUT"][0].numpy(), np.asarray(jouts["dev.OUT"][0])
        )
    assert state_to_numpy(tp)["dev"]["acc"] == np.float32(0.0)  # init untouched


def test_resolve_pe_device():
    cpu = torch.device("cpu")
    assert resolve_pe_device("tpu-v5e-16x16", cpu) == cpu
    assert resolve_pe_device("", cpu) == cpu
    assert resolve_pe_device("x86_64", "cuda:0") == torch.device("cuda", 0)
    assert resolve_pe_device("gpu", cpu) == torch.device("cuda", 0)
    assert resolve_pe_device("gpu:1", cpu) == torch.device("cuda", 1)
    assert resolve_pe_device("CUDA:2", cpu) == torch.device("cuda", 2)
    assert resolve_pe_device("cpu", "cuda:0") == cpu


def test_legacy_graph_partition_intersects_masks():
    """``compile_partition(graph, names)`` lowers on the spot, unfused: a
    dynamic-rate filter on a partly valid block keeps only valid tokens
    below its threshold, as the reference's does."""
    from repro_torch.apps.streams import topfilter
    from repro_torch.runtime.device_runtime import compile_partition

    net, _ = topfilter(64)
    prog = compile_partition(net.graph(), ["filter"], block=16, device="cpu")
    vals = torch.arange(16, dtype=torch.float32) * 10.0
    mask = torch.arange(16) < 10
    _st, outs, idle = prog.step(prog.init_state, {"filter.IN": (vals, mask)})
    ovals, omask = outs["filter.OUT"]
    assert omask.tolist() == (mask & (vals < 50)).tolist()
    assert ovals[omask].tolist() == [0.0, 10.0, 20.0, 30.0, 40.0]
    assert not bool(idle)


def test_plink_staging_ring_stats_and_trace():
    """The port's PLink: a ring of four (k, block) staging slots, the
    stage/dispatch/sync/retire split, and one trace lane per partition."""
    from repro_torch.observability import phase_totals, validate_chrome_trace

    tg, tx = _chain(tactor, tgraph, tmake_xcf, stateful=False)
    prog = repro_torch.compile(tg, tx, block=BLOCK, megastep=2, device="cpu")
    rt = prog._build_runtime()
    rt.run_threads()
    (plink,) = rt.plinks.values()
    assert plink.k == 2 and len(plink._slots) == 4
    for slot in plink._slots:
        vals, mask, _v, _m = slot["dev.IN"]
        assert vals.shape == mask.shape == (2, BLOCK)
    s = plink.stats
    assert s.launches >= 1 and s.tokens_out == 64
    assert s.stage_ns > 0 and s.dispatch_ns > 0 and s.retire_ns > 0

    rep = prog.run(trace=True)
    assert validate_chrome_trace(
        rep.trace, require_cats=["plink", "run"], require_tracks=["lane:"]
    ) == []
    assert phase_totals(rep.trace)
