"""The port's main path end to end: ``repro_torch.compile(net, xcf).run()``
on the five Table-I networks against ``repro.compile(...).run()``, on the CPU.

Against the JAX package: TopFilter, Bitonic8 and ZigZag match bitwise; FIR32
and IDCT8 within ``rtol=1e-6, atol=1e-5`` (the JAX device step may contract
``a + c*x`` into an FMA and sums ``matmul8`` in XLA's order; the port does
neither).  Within the port, bitwise: fused == unfused, megastep ==
per-iteration, and a 2-partition IDCT8 == the single partition.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.apps.streams import NETWORKS as JNETS
from repro_torch.apps.streams import NETWORKS as TNETS
from repro_torch.core.xcf import make_xcf
from repro_torch.frontend import FrontendError

SIZES = {"TopFilter": 1200, "FIR32": 600, "Bitonic8": 48, "IDCT8": 48, "ZigZag": 12}
EXACT = {"TopFilter", "Bitonic8", "ZigZag"}
BLOCK = 256


def _build(nets, name, size=None):
    size = SIZES[name] if size is None else size
    return nets[name](n=size) if name == "FIR32" else nets[name](size)


def _run(net, got, **kw):
    report = repro_torch.compile(net, device="cpu", **kw).run()
    return list(got), report


@pytest.mark.parametrize("name", sorted(TNETS))
def test_slice_matches_jax_and_holds_its_invariants(name):
    jnet, jgot = _build(JNETS, name)
    repro.compile(jnet, backend="device", block=BLOCK).run()
    ref = list(jgot)

    net, got = _build(TNETS, name)
    fused, rep = _run(net, got, backend="device", block=BLOCK)
    assert rep.plink_launches >= 1
    assert len(fused) == len(ref) > 0
    if name in EXACT:
        assert fused == ref
    else:
        np.testing.assert_allclose(fused, ref, rtol=1e-6, atol=1e-5)

    unfused, _ = _run(net, got, backend="device", block=BLOCK, fuse=False)
    assert unfused == fused
    per_iter, _ = _run(net, got, backend="device", block=BLOCK, megastep=False)
    assert per_iter == fused
    mega4, _ = _run(net, got, backend="device", block=BLOCK, megastep=4)
    assert mega4 == fused

    host, _ = _run(net, got, backend="host")
    np.testing.assert_allclose(fused, host, rtol=1e-5, atol=1e-4)


def test_codegen_tags():
    net, _ = _build(TNETS, "IDCT8", 16)
    prog = repro_torch.compile(net, backend="device", block=64, device="cpu")
    assert {v["codegen"] for v in prog.module.meta["fused"].values()} == {"cuda"}
    assert prog.device_program().flat_megastep
    net, _ = _build(TNETS, "IDCT8", 16)
    prog = repro_torch.compile(net, backend="device", block=60, device="cpu")
    # block % block_unit != 0: the megastep loops over its chunks instead
    assert not prog.device_program().flat_megastep


def test_two_partition_idct8_equals_single_partition():
    net, got = _build(TNETS, "IDCT8", 64)
    single, _ = _run(net, got, backend="device", block=128)
    two = make_xcf(
        "IDCT8",
        {"source": "t0", "descale": "dA", "idct": "dB", "clip": "dB", "sink": "t0"},
        accel=("dA", "dB"),
    )
    prog = repro_torch.compile(net, two, block=128, device="cpu")
    assert prog.hw_partitions == ["dA", "dB"]
    rep = prog.run()
    assert list(got) == single
    assert rep.plink_launches >= 2


def test_mixed_placement_matches_host():
    net, got = _build(TNETS, "FIR32", 400)
    g = net.graph()
    assignment = {
        a: "accel" if act.device_ok else ("t0" if a == "source" else "t1")
        for a, act in g.actors.items()
    }
    host, _ = _run(net, got, backend="host")
    prog = repro_torch.compile(net, make_xcf(g.name, assignment), block=128, device="cpu")
    assert prog.hw_partition == "accel" and len(prog.module.sw_regions()) == 2
    rep = prog.run()
    assert rep.plink_launches >= 1
    np.testing.assert_allclose(list(got), host, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("remat", ["block", "save_dispatch", "none"])
def test_batch_chunks_match_reference(remat):
    """``batch_chunks=2`` (in-block batch chunking, the aux losses summed
    over chunks) on the reduced deepseek-moe-16b: loss and gradients against
    the reference's ``batch_chunks=2`` under each remat policy."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.model import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.model import lm
    from repro_torch.model.convert import params_from_numpy
    from repro_torch.pytree import tree_paths

    kw = dict(dtype="float32", param_dtype="float32", batch_chunks=2, remat=remat)
    jcfg = dataclasses.replace(jget_config("deepseek-moe-16b").reduced(), use_pallas="off", **kw)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(), **kw)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams), cfg,
                               device="cpu")
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (jloss, jm), jgrads = jax.value_and_grad(lambda p: jlm.lm_loss(p, jcfg, {
        k: jnp.asarray(v) for k, v in batch.items()}), has_aux=True)(jparams)
    keys, leaves = zip(*tree_paths(params))
    loss, m = lm.lm_loss(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves))
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(m["moe_balance"]), float(jm["moe_balance"]), rtol=1e-5)
    jflat = {"/".join(str(p.key) for p in path): np.asarray(g) for path, g in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for k, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=2e-4, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("entry", ["serve", "profile", "explore"])
def test_entry_points_run_on_cpu(entry):
    net, got = _build(TNETS, "IDCT8", 8)
    prog = repro_torch.compile(net, backend="device", block=64, device="cpu")
    if entry == "serve":
        from helpers import drain_source

        stream = drain_source(prog.graph)
        prog.run()
        ref = list(got)
        with prog.serve() as server:
            s = server.open_session()
            s.submit(stream)
            s.close()
            assert server.drain(timeout=60)
            assert s.output() == ref
    elif entry == "profile":
        prof = prog.profile(block=64, bandwidth_sizes=(64, 256))
        assert set(prof.exec_hw) == {"descale", "idct", "clip"}
        assert prof.tokens and prof.links["inter"].bandwidth_Bps > 0
    else:
        points = prog.explore(thread_counts=(1,), accel_options=(False, True))
        assert {p.n_accels for p in points} == {0, 1}
        best = min(points, key=lambda p: p.predicted)
        assert prog.repartition(xcf=best.xcf).run().fires > 0


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    net, _ = _build(TNETS, "IDCT8", 8)
    with pytest.raises(FrontendError, match="CUDA is not available"):
        repro_torch.compile(net, backend="device", block=64)
    # host-only placements need no device
    repro_torch.compile(net, backend="host").run()


def test_port_runs_without_jax_or_repro():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch\n"
        "from repro_torch.apps.streams import idct8\n"
        "net, got = idct8(16)\n"
        "r = repro_torch.compile(net, backend='device', block=64, device='cpu').run()\n"
        "assert r.plink_launches >= 1 and len(got) == 128, r\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_defines_each_name_once():
    """A later phase's helper must not rebind an earlier phase's name."""
    import ast
    from collections import Counter

    tree = ast.parse((Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text())
    names = Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(x.id for t in node.targets for x in ast.walk(t) if isinstance(x, ast.Name))
    assert [n for n, c in names.items() if c > 1] == []
