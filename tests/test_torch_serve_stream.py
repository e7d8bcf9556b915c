"""StreamServe in the PyTorch port, on the CPU, holding the invariants of the
reference's serving tests (``tests/test_{serve_stream,continuous_batching,
reliability}.py``): a batched lane is bitwise the unbatched step, every
session's output is bitwise its isolated ``run()``, chunked admission splits
a hog, kill-and-recover is bitwise, and an online repartition keeps the
outputs.  Against the JAX package's ``StreamServer`` fed the same
submissions: bitwise on TopFilter, Bitonic8 and ZigZag, and on FIR32 and
IDCT8 within ``tests/test_fusion.py``'s tolerance (``rtol=1e-5,
atol=1e-4``: the JAX device step may contract ``a + c*x`` into an FMA).
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.apps.streams import NETWORKS as JNETS
from repro_torch.apps.streams import NETWORKS as TNETS
from repro_torch.core import cost_model as tcost
from repro_torch.serve_stream import OnlineRepartitioner, ServeError, StreamServer
from repro_torch.serve_stream.batcher import LANE_SLACK, DeviceBatcher

from helpers import drain_source

BLOCK = 256
SIZES = {  # three per-session workload sizes each (staggered on purpose)
    "TopFilter": [900, 1200, 600],
    "FIR32": [400, 600, 500],
    "Bitonic8": [32, 48, 40],
    "IDCT8": [32, 48, 40],
    "ZigZag": [6, 9, 7],
}
EXACT = {"TopFilter", "Bitonic8", "ZigZag"}
EGRESS = {"FIR32": "sink"}  # FIR also has the x-forward xsink


def _build(nets, name, size):
    return nets[name](n=size) if name == "FIR32" else nets[name](size)


def _compiled(name, size, block=BLOCK, **kw):
    net, _ = _build(TNETS, name, size)
    return repro_torch.compile(net, backend="device", block=block, device="cpu", **kw)


def _refs(name, sizes, **kw):
    """Each stream's isolated port ``run()`` and its exact input stream."""
    refs, streams = [], []
    for sz in sizes:
        net, got = _build(TNETS, name, sz)
        prog = repro_torch.compile(net, backend="device", block=BLOCK, device="cpu", **kw)
        streams.append(drain_source(prog.graph))
        prog.run()
        refs.append(list(got))
    return refs, streams


def _serve(server, streams, chunks=(96, 160, 64)):
    """Interleaved, uneven submissions: sessions progress at different
    speeds.  Returns the sessions, drained."""
    sessions = [server.open_session() for _ in streams]
    offsets = [0] * len(sessions)
    while any(o < len(st) for o, st in zip(offsets, streams)):
        for i, s in enumerate(sessions):
            if offsets[i] < len(streams[i]):
                c = streams[i][offsets[i]:offsets[i] + chunks[i % len(chunks)]]
                s.submit(c)
                offsets[i] += len(c)
    for s in sessions:
        s.close()
    assert server.drain(timeout=120)
    return sessions


def _payloads(dp, lanes, seed):
    """Random staged payloads for ``lanes`` lanes, masks ragged per lane."""
    rng = np.random.default_rng(seed)
    k = dp.megastep_k
    shape = (k, dp.block) if k > 1 else (dp.block,)
    out = []
    for lane in range(lanes):
        pay = {}
        for (a, p, _dt) in dp.in_ports:
            key = f"{a}.{p}"
            vals = (rng.random(shape) * 200 - 100).astype(np.float32)
            mask = np.zeros(shape, bool)
            n = dp.block - dp.block % dp.in_quanta[key] - lane * dp.in_quanta[key]
            mask.reshape(-1, dp.block)[:, :max(n, 0)] = True
            pay[key] = (vals, mask)
        out.append(pay)
    return out


def _eq(a, b):
    assert torch.equal(a, b) or (
        a.dtype.is_floating_point and torch.equal(a.view(torch.int32), b.view(torch.int32))
    )


# ---------------------------------------------------------------------------
# Batched entry points of the device program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TNETS))
@pytest.mark.parametrize("kw", [{}, {"fuse": False}, {"megastep": 3}],
                         ids=["fused", "unfused", "megastep"])
def test_batched_lane_equals_unbatched_step(name, kw):
    dp = _compiled(name, SIZES[name][0], block=64 if name != "ZigZag" else 128,
                   **kw).device_program()
    B = 3
    payloads = _payloads(dp, B, seed=len(name))
    batched = dp.batched_megastep(B) if dp.megastep_k > 1 else dp.batched_step(B)
    state_b, outs_b, idle_b = batched(dp.stack_states([dp.init_state] * B),
                                      dp.pack_lanes(payloads))
    assert idle_b.shape == (B,)
    for b in range(B):
        lane = {k: (v[0], m[0]) for k, (v, m) in dp.pack_lanes([payloads[b]]).items()}
        state, outs, idle = dp.launch(
            {a: dict(s) for a, s in dp.init_state.items()}, lane
        )
        assert set(outs) == set(outs_b)
        for k in outs:
            _eq(outs[k][0], outs_b[k][0][b])
            _eq(outs[k][1], outs_b[k][1][b])
        assert bool(idle) == bool(idle_b[b])
        assert repr(state) == repr(dp.unstack_state(state_b, b))
    assert dp.lane_flat == (kw.get("fuse", True) and name != "TopFilter")


@pytest.mark.parametrize("name, hw", [
    ("Bitonic8", {"ce0", "ce4", "ce2"}),
    ("FIR32", {"mac0", "mac1", "mac5"}),
])
@pytest.mark.parametrize("megastep", [False, "auto"], ids=["step", "megastep"])
def test_mixed_partition_launches_its_region_once_a_round(name, hw, megastep, monkeypatch):
    """A partition holding a fused region beside an unfused actor (as
    ``explore()``'s scattered points make): a batched round of B lanes
    calls the region's stream op once, whatever B and k, where the
    unbatched launches call it once a chunk; lane *i* stays bitwise."""
    from repro_torch.core.xcf import make_xcf
    from repro_torch.ir import fusion

    calls = []
    real = fusion.fused_stream
    monkeypatch.setattr(fusion, "fused_stream",
                        lambda inputs, prog: calls.append(inputs[0].shape) or real(inputs, prog))
    net, _ = _build(TNETS, name, SIZES[name][0])
    xcf = make_xcf(name, {a: ("accel" if a in hw else "t0") for a in net.graph().actors})
    dp = repro_torch.compile(net, xcf, block=64, megastep=megastep,
                             device="cpu").device_program()
    fused = [a for a in dp.actors if dp.fused and a in dp.fused]
    assert len(fused) == 1 and len(dp.actors) == 2 and not dp.lane_flat
    assert dp.megastep_k == (1 if megastep is False else 4)
    B = 3
    payloads = _payloads(dp, B, seed=7)
    batched = dp.batched_megastep(B) if dp.megastep_k > 1 else dp.batched_step(B)
    calls.clear()
    _state_b, outs_b, idle_b = batched(dp.stack_states([dp.init_state] * B),
                                       dp.pack_lanes(payloads))
    assert calls == [(B * dp.megastep_k, dp.block)]  # one call for the round
    for b in range(B):
        lane = {k: (v[0], m[0]) for k, (v, m) in dp.pack_lanes([payloads[b]]).items()}
        calls.clear()
        _state, outs, idle = dp.launch({a: dict(s) for a, s in dp.init_state.items()}, lane)
        assert len(calls) == dp.megastep_k  # the unbatched megastep loops its chunks
        for k in outs:
            _eq(outs[k][0], outs_b[k][0][b])
            _eq(outs[k][1], outs_b[k][1][b])
        assert bool(idle) == bool(idle_b[b])


def test_pack_stack_unstack_round_trip():
    dp = _compiled("FIR32", 400, block=64, fuse=False, megastep=False).device_program()
    payloads = _payloads(dp, 4, seed=1)
    packed = dp.pack_lanes(payloads)
    for k, (v, m) in packed.items():
        assert v.shape == (4, dp.block) and v.dtype == torch.float32
        for i, pay in enumerate(payloads):
            np.testing.assert_array_equal(v[i].numpy(), pay[k][0])
            np.testing.assert_array_equal(m[i].numpy(), pay[k][1])
    states = [
        {"a": {"x": torch.tensor(float(i)), "n": torch.tensor(i, dtype=torch.int32)},
         "b": {}}
        for i in range(3)
    ]
    stacked = dp.stack_states(states)
    assert stacked["a"]["x"].shape == (3,) and stacked["b"] == {}
    for i, st in enumerate(states):
        back = dp.unstack_state(stacked, i)
        assert back["a"]["x"] == st["a"]["x"] and back["a"]["n"] == st["a"]["n"]
    init = dp.batched_init_state(5)
    assert set(init) == set(dp.init_state)


def test_width_memoization_is_ragged_not_pow2():
    b = DeviceBatcher(_compiled("FIR32", 64, block=64).device_program(), max_batch=32)
    assert LANE_SLACK == 4 / 3
    assert [b._width(n) for n in (3, 3, 4, 31, 24, 10, 32)] == [3, 3, 4, 31, 31, 10, 32]
    assert b._widths == {3, 4, 10, 31, 32}


# ---------------------------------------------------------------------------
# Sessions: bitwise their isolated runs, and the reference server's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TNETS))
def test_sessions_match_isolated_runs_and_the_reference_server(name):
    refs, streams = _refs(name, SIZES[name])
    with _compiled(name, SIZES[name][0]).serve(batching=True) as server:
        sessions = _serve(server, streams)
        outs = [s.output(EGRESS.get(name)) for s in sessions]
        t = server.telemetry.lifetime()
    for out, ref in zip(outs, refs):
        assert out == ref  # bitwise
    assert t.device_lanes > t.device_dispatches >= 1  # sessions shared rounds

    jnet, _ = _build(JNETS, name, SIZES[name][0])
    with repro.compile(jnet, backend="device", block=BLOCK).serve(batching=True) as jserver:
        jouts = [s.output(EGRESS.get(name)) for s in _serve(jserver, streams)]
    for out, jout in zip(outs, jouts):
        assert len(out) == len(jout) > 0
        if name in EXACT:
            assert out == jout
        else:
            np.testing.assert_allclose(out, jout, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("batching", [True, False], ids=["continuous", "sequential"])
def test_megastep_sessions_match_isolated_runs(batching):
    refs, streams = _refs("FIR32", SIZES["FIR32"], megastep=3)
    prog = _compiled("FIR32", SIZES["FIR32"][0], megastep=3)
    assert prog.device_program().megastep_k > 1 and prog.device_program().flat_megastep
    with prog.serve(batching=batching) as server:
        for s, ref in zip(_serve(server, streams), refs):
            assert s.output("sink") == ref


def test_two_partition_sessions_match_isolated_runs():
    from repro_torch.core.xcf import make_xcf

    refs, streams = _refs("IDCT8", SIZES["IDCT8"])
    net, _ = _build(TNETS, "IDCT8", SIZES["IDCT8"][0])
    two = make_xcf(
        "IDCT8",
        {"source": "t0", "descale": "dA", "idct": "dB", "clip": "dB", "sink": "t0"},
        accel=("dA", "dB"),
    )
    prog = repro_torch.compile(net, two, block=BLOCK, device="cpu")
    with prog.serve() as server:
        for s, ref in zip(_serve(server, streams), refs):
            assert s.output() == ref


def test_mixed_partition_sessions_match_isolated_runs():
    """Bitonic8 served on a partition of one fused region beside an unfused
    compare-exchange: every session bitwise its isolated run."""
    from repro_torch.core.xcf import make_xcf

    refs, streams = _refs("Bitonic8", SIZES["Bitonic8"])
    net, _ = _build(TNETS, "Bitonic8", SIZES["Bitonic8"][0])
    hw = {"ce0", "ce4", "ce2"}
    xcf = make_xcf("Bitonic8", {a: ("accel" if a in hw else "t0") for a in net.graph().actors})
    prog = repro_torch.compile(net, xcf, block=BLOCK, device="cpu")
    assert not prog.device_program().lane_flat
    with prog.serve() as server:
        for s, ref in zip(_serve(server, streams), refs):
            assert s.output() == ref


def test_chunked_admission_splits_a_hog():
    (hog_ref,), (hog_stream,) = _refs("TopFilter", [4096])
    small_refs, small_streams = _refs("TopFilter", [256, 256, 256])
    prog = _compiled("TopFilter", 4096, block=128)
    with prog.serve(admission_depth=256, admission_chunk=128) as server:
        hog = server.open_session()
        smalls = [server.open_session() for _ in small_streams]
        done = []

        def run_hog():
            hog.submit(hog_stream)  # >> admission_depth: split at admission
            done.append(time.perf_counter_ns())
            hog.close()

        th = threading.Thread(target=run_hog)
        th.start()
        for s, st in zip(smalls, small_streams):
            s.submit(st)
            s.close()
        th.join(timeout=120)
        assert not th.is_alive() and done
        assert server.drain(timeout=120)
        assert hog.output() == hog_ref
        for s, ref in zip(smalls, small_refs):
            assert s.output() == ref
            assert s.first_delivery_ns is not None and s.first_delivery_ns < done[0]
        t = server.telemetry.lifetime()
    assert t.chunks_split >= 1
    assert t.chunks_submitted > len(small_streams) + 1


# ---------------------------------------------------------------------------
# Kill and recover; online repartition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(TNETS))
def test_kill_and_recover_bitwise(name, tmp_path):
    size = SIZES[name][1]
    (ref,), (stream,) = _refs(name, [size])
    half = len(stream) // 2
    server = _compiled(name, size).serve(start=True)
    s = server.open_session()
    s.submit(stream[:half])
    if half >= 2 * BLOCK:  # big streams: checkpoint after real delivery
        deadline = time.time() + 60
        while s.first_delivery_ns is None and time.time() < deadline:
            time.sleep(0.005)
        assert s.first_delivery_ns is not None
    assert server.checkpoint(tmp_path).exists()
    server.kill()  # no shutdown flush: an engine crash

    server2 = StreamServer.recover(_compiled(name, size), tmp_path, start=True)
    try:
        assert not server2.recovery.sessions[0].finished
        s2 = server2.session(0)
        s2.submit(stream[half:])
        s2.close()
        assert server2.drain(timeout=120)
        assert s2.output(EGRESS.get(name)) == ref  # bitwise
    finally:
        server2.stop()


def test_periodic_checkpoint_recovers(tmp_path):
    from repro_torch import checkpoint as ckpt

    (ref,), (stream,) = _refs("FIR32", [600])
    server = _compiled("FIR32", 600).serve(
        start=True, checkpoint_dir=tmp_path, checkpoint_every_s=0.05,
    )
    s = server.open_session()
    s.submit(stream[:300])
    deadline = time.time() + 60
    while ckpt.latest_step(tmp_path) is None and time.time() < deadline:
        time.sleep(0.01)
    assert ckpt.latest_step(tmp_path) is not None
    server.kill()
    server2 = StreamServer.recover(_compiled("FIR32", 600), tmp_path, start=True)
    try:
        s2 = server2.session(0)
        s2.submit(stream[300:])
        s2.close()
        assert server2.drain(timeout=120)
        assert s2.output("sink") == ref
    finally:
        server2.stop()


def test_online_repartition_moves_the_placement_and_keeps_outputs():
    """Host-only serving with a calibration profile that prices the device
    actor near zero: the first solve moves it onto the device partition,
    mid-stream, and every output stays bitwise (TopFilter: host and device
    compare the same float32 tokens)."""
    (ref,), (stream,) = _refs("TopFilter", [2000])
    net, _ = _build(TNETS, "TopFilter", 2000)
    prog = repro_torch.compile(net, backend="host", block=BLOCK, device="cpu")
    base = tcost.NetworkProfile()
    base.exec_hw["filter"] = 1e-9
    rep = OnlineRepartitioner(interval_s=0.0, min_window_s=0.0, min_gain=0.0,
                              thread_counts=(1,), base_profile=base)
    with prog.serve(repartitioner=rep) as server:
        s = server.open_session()
        s.submit(stream[:1000])
        deadline = time.time() + 60
        while not server.telemetry.swap_log and time.time() < deadline:
            time.sleep(0.005)
        assert server.telemetry.swap_log, "the repartitioner never moved the placement"
        s.submit(stream[1000:])
        s.close()
        assert server.drain(timeout=120)
        assert s.output() == ref
        assert server.program.hw_partitions  # now on the device partition
        assert server.telemetry.swap_log[0]["to"]["filter"] == "accel"
    assert any(swapped for _c, _b, swapped in rep.decisions)


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "cuda"])
def test_failed_launches_degrade_to_the_host_only_off_the_card(on_card):
    """Every launch fails.  A partition on the CPU degrades to the all-host
    placement and the stream completes bitwise, as in the reference's
    reliability contract; a partition on a CUDA device never moves to the
    host: its session fails loudly and nothing is swapped."""
    (ref,), (stream,) = _refs("TopFilter", [1200])
    prog = _compiled("TopFilter", 1200)
    with prog.serve(chaos="launch:*|after=1", launch_retries=1,
                    retry_base_s=0.001) as server:
        if on_card:
            # the chaos site fails every launch before any staging, so no
            # tensor is ever sent to the card this batcher names
            for b in server._batchers.values():
                b.program = dataclasses.replace(b.program, device=torch.device("cuda", 0))
        s = server.open_session()
        s.submit(stream)
        s.close()
        assert server.drain(timeout=120)
        assert server._c_faults.value >= 2  # the launch and its retry
        if on_card:
            with pytest.raises(ServeError, match="cuda:0"):
                s.output()
            assert server._g_degraded.value == 0
            assert not server._quarantined
            assert server.program.hw_partitions  # still the device placement
            assert server.telemetry.lifetime().swaps == 0
        else:
            assert s.output() == ref
            assert server._g_degraded.value == 1
            assert server.program.hw_partition is None  # now all-host
