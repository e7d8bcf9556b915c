"""The port's dry-run (``repro_torch.launch.dryrun`` and ``hlo_analysis``)
held to the JAX package's spec functions and its HLO analysis.

* ``default_accum_steps``, ``cell_specs`` and ``cache_specs`` against the
  reference's, for every arch and shape cell: leaf shapes, dtypes and
  logical axes.
* Per-device argument bytes on the production meshes (a ``fake`` process
  group of 256 / 512 ranks) against the shard shapes of the reference's
  PartitionSpecs; ``model_flops_global`` and the parameter counts.
* Unsharded FLOPs of a meta trace against the reference's ``analyze()`` on
  its compiled HLO, within the 5% of its own analyzer test
  (``tests/test_system.py:58``).
* Hand-counted sharded cases on a fake 16 x 16 and 2 x 16 x 16.
* The fake-group analysis on (2, 2) and (1, 4) against a real 4-rank gloo
  run of the same steps (``torch_ranks.case_dryrun``): FLOPs and
  collectives per kind exactly.
* The MoE's static-shape expert counts, and the command line.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import SHAPE_CELLS as JSHAPE_CELLS
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeCell as JShapeCell
from repro.distributed.sharding import make_rules as jmake_rules
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze as janalyze
from repro_torch.configs import SHAPE_CELLS, get_config, list_archs
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun, steps
from repro_torch.launch.hlo_analysis import StepCounter, stats_dict, tensor_bytes
from repro_torch.pytree import tree_paths
from torch_ranks import spawn

SRC = Path(__file__).resolve().parents[1] / "src"
FLOP_REL = 0.05  # tests/test_system.py::test_hlo_analysis_loop_multiplication

CELLS = [(a, s) for a in list_archs() for s in SHAPE_CELLS
         if get_config(a).cell_supported(SHAPE_CELLS[s])[0]]


def _jpaths(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _axes_paths(tree, path=()):
    """``{key path: logical axes}`` of a tree of axis tuples."""
    if _is_axes(tree):
        return {"/".join(path): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items for k, v in _axes_paths(sub, path + (str(key),)).items()}


# ---------------------------------------------------------------------------
# Spec functions
# ---------------------------------------------------------------------------


def test_default_accum_steps_is_the_reference_policy():
    for arch in list_archs():
        for over in ({}, {"accum_steps": 3}, {"batch_chunks": 4}):
            cfg = dataclasses.replace(get_config(arch), **over)
            jcfg = dataclasses.replace(jget_config(arch), **over)
            for name, cell in SHAPE_CELLS.items():
                got = steps.default_accum_steps(cfg, cell)
                assert got == jsteps.default_accum_steps(jcfg, JSHAPE_CELLS[name]), (
                    arch, name, over)
    cell = ShapeCell("odd", 64, 200, "train")  # 200 // 32 = 6 does not divide 200: 5
    assert steps.default_accum_steps(get_config("smollm-135m"), cell) == 5


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_match_the_reference(arch, shape):
    cfg, cell = get_config(arch), SHAPE_CELLS[shape]
    _, args, logical = steps.cell_specs(cfg, cell)
    _, jargs, jlogical = jsteps.cell_specs(jget_config(arch), JSHAPE_CELLS[shape])
    assert len(args) == len(jargs)
    for a, la, ja, jla in zip(args, logical, jargs, jlogical):
        got = dict(tree_paths(a))
        want = _jpaths(ja)
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta", k
            assert tuple(t.shape) == tuple(want[k].shape), k
            assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k
        assert _axes_paths(la) == _jpaths(jla, is_leaf=_is_axes)
    if cell.kind == "train":  # the trainer's parameters require grad
        assert all(t.requires_grad for _, t in tree_paths(args[0]))


def test_cache_specs_match_the_reference():
    for arch in ("smollm-135m", "mamba2-130m", "jamba-v0.1-52b", "starcoder2-7b"):
        got, glog = steps.cache_specs(get_config(arch), 8, 4096)
        want, wlog = jsteps.cache_specs(jget_config(arch), 8, 4096)
        want = _jpaths(want)
        assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for k, t in tree_paths(got)} == {
            k: (tuple(t.shape), str(t.dtype)) for k, t in want.items()}
        assert _axes_paths(glog) == _jpaths(wlog, is_leaf=_is_axes)


def _ref_arg_bytes(arch, shape, multi_pod):
    """Sum over every argument leaf of its shard's bytes under the
    reference's PartitionSpecs on the production mesh."""
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        AbstractMesh((16, 16), ("data", "model"))
    cfg = jget_config(arch)
    rules = jmake_rules(cfg, mesh)
    _, args, logical = jsteps.cell_specs(cfg, JSHAPE_CELLS[shape])
    total = 0
    for a, lg in zip(args, logical):
        specs = jsteps.specs_to_pspecs(a, lg, mesh, rules)
        leaves = jax.tree.leaves(a)
        pspecs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for s, p in zip(leaves, pspecs):
            shard = list(s.shape)
            for d, e in enumerate(p):
                for ax in (e if isinstance(e, tuple) else (e,) if e else ()):
                    shard[d] //= mesh.shape[ax]
            total += math.prod(shard) * s.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_argument_bytes_per_device_match_the_reference_shards(multi_pod):
    with dryrun.fake_world(512 if multi_pod else 256):
        mesh = dryrun.production_mesh(multi_pod)
        for arch, shape in CELLS:
            cfg = get_config(arch)
            rules = dryrun.make_rules(cfg, mesh)
            _, args, logical = steps.cell_specs(cfg, SHAPE_CELLS[shape])
            placed = [dryrun.place_meta(a, lg, mesh, rules) for a, lg in zip(args, logical)]
            assert tensor_bytes(placed) == _ref_arg_bytes(arch, shape, multi_pod), (arch, shape)


def test_model_flops_and_parameter_counts_match_the_reference():
    for arch, shape in CELLS:
        cfg, jcfg, cell = get_config(arch), jget_config(arch), SHAPE_CELLS[shape]
        jpc = jcfg.param_counts()
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
        want = 2.0 * jpc["active"] * tokens * (3.0 if cell.kind == "train" else 1.0)
        assert dryrun.model_flops(cfg, cell) == want, (arch, shape)
        pc = cfg.param_counts()
        assert (pc["total"], pc["active"]) == (jpc["total"], jpc["active"]), arch


# ---------------------------------------------------------------------------
# Unsharded FLOPs against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _decode_extra(cfg, cell) -> float:
    """FLOPs the port's decode computes beyond the reference's: its two
    attention products read the (B, S, kv, hd) cache as it lies, one
    product over every (kv head, slot) pair of which the diagonal kv blocks
    are kept (``model/attention.py::_cache_scores`` / ``_cache_mix``), so
    kv - 1 of every kv blocks are extra."""
    attn_layers = sum(cfg.block_kind(i).mixer == "attn" for i in range(cfg.num_layers))
    per_product = 2.0 * cell.global_batch * cfg.num_heads * cell.seq_len * cfg.head_dim
    return attn_layers * 2 * per_product * (cfg.num_kv_heads - 1)


FLOP_CELLS = [(a, k, True) for a in ("smollm-135m", "mamba2-130m", "deepseek-moe-16b")
              for k in ("train", "prefill", "decode")] + [("smollm-135m", "train", False)]


@pytest.mark.parametrize("arch,kind,reduced", FLOP_CELLS,
                         ids=[f"{a}-{k}{'' if r else '-full'}" for a, k, r in FLOP_CELLS])
def test_unsharded_flops_match_the_reference_hlo(arch, kind, reduced):
    cfg, jcfg = get_config(arch), jget_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    cell = ShapeCell(kind, 64, 4, kind)
    got = dryrun.analyze_cell(cfg, cell)
    step, args, _ = jsteps.cell_specs(jcfg, JShapeCell(kind, 64, 4, kind))
    want = janalyze(jax.jit(step).lower(*args).compile().as_text()).flops
    flops = got["analyzed"]["flops"]
    extra = _decode_extra(cfg, cell) if kind == "decode" else 0.0
    print(f"{arch} {kind} reduced={reduced}: port/ref {flops / want:.4f}, "
          f"less the decode's extra products {(flops - extra) / want:.4f}")
    assert flops - extra == pytest.approx(want, rel=FLOP_REL), (flops, extra, want)
    assert got["status"] == "ok" and got["memory_analysis"]["argument_size_in_bytes"] == \
        tensor_bytes(steps.cell_specs(cfg, cell)[1])


def test_decode_extra_products_are_the_off_diagonal_blocks():
    """The decode's counted attention FLOPs are kv times the reference's
    einsums: one layer's products, counted op by op."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), num_layers=1,
                              use_kernels="off")
    cell = ShapeCell("d", 64, 4, "decode")
    step, args, _ = steps.cell_specs(cfg, cell)
    seen = []

    class Products(StepCounter):
        def _count(self, func, a, kw, out):
            if func._overloadpacket is torch.ops.aten.bmm:
                seen.append(2.0 * math.prod(out.shape) * a[0].shape[-1])
            super()._count(func, a, kw, out)

    with Products():
        step(*args)
    einsums = 2 * (2.0 * 4 * cfg.num_heads * 64 * cfg.head_dim)
    assert sum(seen) == einsums * cfg.num_kv_heads == einsums + _decode_extra(cfg, cell)


# ---------------------------------------------------------------------------
# Hand-counted sharded cases
# ---------------------------------------------------------------------------


def test_sharded_and_replicated_matmuls_count_local_flops():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with dryrun.fake_world(256):
        mesh = dryrun.production_mesh(False)
        x = DTensor.from_local(torch.empty(256, 2048, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(2048, 512, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        assert tuple(x.shape) == (4096, 2048) and tuple(w.shape) == (2048, 8192)
        with StepCounter() as c:
            y = x @ w
        assert c.stats.flops == 2 * 256 * 2048 * 512 == 536870912  # not 1.37e11
        assert c.stats.collective_bytes == 0 and tuple(y.to_local().shape) == (256, 512)
        a = DTensor.from_local(torch.empty(64, 128, device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(128, 32, device="meta"), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with StepCounter() as c:
            a @ b
        assert c.stats.flops == 2 * 64 * 128 * 32
        # a model-axis all-gather and a shard-to-shard all-to-all, both ICI
        z = DTensor.from_local(torch.empty(256, 16, 64, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        with StepCounter() as c:
            z.redistribute(mesh, [Shard(0), Shard(2)])
            z.redistribute(mesh, [Shard(0), Replicate()])
        d = stats_dict(c.stats)
        assert d["per_op"]["all-to-all"] == {"bytes": 256 * 16 * 64 * 4, "count": 1}
        assert d["per_op"]["all-gather"] == {"bytes": 256 * 16 * 64 * 4, "count": 1}
        assert d["ici_bytes"] == 2 * 256 * 16 * 64 * 4 and d["dcn_bytes"] == 0


def test_a_collective_over_pod_counts_as_dcn():
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate

    with dryrun.fake_world(512):
        mesh = dryrun.production_mesh(True)
        x = DTensor.from_local(torch.empty(1024, device="meta"), mesh,
                               [Partial(), Replicate(), Replicate()], run_check=False)
        with StepCounter() as c:
            x.redistribute(mesh, [Replicate()] * 3)
            dist.all_reduce(torch.empty(256, device="meta"), group=mesh.get_group("pod"))
            dist.all_reduce(torch.empty(256, device="meta"), group=mesh.get_group("data"))
        d = stats_dict(c.stats)
        assert d["per_op"]["all-reduce"] == {"bytes": (1024 + 256 + 256) * 4, "count": 3}
        assert d["dcn_bytes"] == (1024 + 256) * 4 and d["ici_bytes"] == 256 * 4


# ---------------------------------------------------------------------------
# Fake process group against a real 4-rank gloo run
# ---------------------------------------------------------------------------

GLOO_ARCHS = ("smollm-135m", "mamba2-130m", "deepseek-moe-16b")
GLOO_MESHES = ((2, 2), (1, 4))
GLOO_CELL = ("train", 64, 4, "train")


def test_fake_group_counts_equal_a_real_gloo_run(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.hlo_analysis import COLLECTIVES

    real = spawn(tmp_path, "dryrun", 4, {"archs": GLOO_ARCHS, "meshes": GLOO_MESHES,
                                         "cell": GLOO_CELL})
    with dryrun.fake_world(4):
        for shape in GLOO_MESHES:
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
            for arch in GLOO_ARCHS:
                got = dryrun.analyze_cell(get_config(arch).reduced(), ShapeCell(*GLOO_CELL),
                                          mesh)["analyzed"]
                tag = f"{arch}/{shape[0]}x{shape[1]}"
                assert got["per_op"]["all-reduce"]["count"] > 0, tag
                for r, res in enumerate(real):
                    assert float(res[f"{tag}/flops"]) == got["flops"], (tag, r)
                    for kind in COLLECTIVES:
                        assert float(res[f"{tag}/{kind}/count"]) == got["per_op"][kind]["count"], (
                            tag, r, kind)
                        assert float(res[f"{tag}/{kind}/bytes"]) == got["per_op"][kind]["bytes"], (
                            tag, r, kind)


# ---------------------------------------------------------------------------
# The MoE's counts, and the command line
# ---------------------------------------------------------------------------


def test_moe_counts_are_bincount_bitwise_and_moe_steps_run_on_meta():
    from repro_torch.model.moe import _group_dispatch

    rng = np.random.default_rng(7)
    for G, N, E, k in ((1, 64, 8, 2), (3, 40, 64, 6), (2, 128, 16, 1)):
        probs = torch.from_numpy(rng.random((G, N, E), dtype=np.float32))
        x = torch.from_numpy(rng.standard_normal((G, N, 8), dtype=np.float32))
        _, meta = _group_dispatch(x, probs, k, capacity=N * k)
        counts, gate_idx = meta[3], meta[4]
        base = torch.arange(G)[:, None] * E
        want = torch.bincount((gate_idx.reshape(G, -1) + base).reshape(-1),
                              minlength=G * E).reshape(G, E)
        assert counts.dtype == want.dtype and torch.equal(counts, want)
    cfg = get_config("deepseek-moe-16b").reduced()
    for kind in ("train", "prefill"):
        res = dryrun.analyze_cell(cfg, ShapeCell(kind, 64, 4, kind))
        assert res["status"] == "ok" and res["analyzed"]["flops"] > 0


def _cli(out, *extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-135m",
         "--shape", "decode_32k", "--out", str(out), *extra],
        env=env, capture_output=True, text=True, timeout=300)


def test_command_line_writes_an_ok_cell_and_exits_1_on_an_error(tmp_path):
    p = _cli(tmp_path / "ok")
    assert p.returncode == 0, p.stdout + p.stderr
    res = json.loads((tmp_path / "ok" / "smollm-135m__decode_32k__16x16.json").read_text())
    assert res["status"] == "ok" and res["mesh"] == "16x16"
    assert set(res["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                           "temp_size_in_bytes", "alias_size_in_bytes"}
    assert set(res["analyzed"]) == {"flops", "bytes", "bytes_fused", "collective_bytes",
                                    "ici_bytes", "dcn_bytes", "per_op"}
    for key in ("model_flops_global", "params_total", "params_active", "t_trace_s"):
        assert key in res
    # the decode's cache is updated in place: it is the aliased output
    assert res["memory_analysis"]["alias_size_in_bytes"] > 0
    assert res["analyzed"]["flops"] > 0 and res["analyzed"]["collective_bytes"] > 0
    assert "[cached]" in _cli(tmp_path / "ok").stdout
    # 9 query heads over 4 kv heads: the GQA reshape cannot divide
    p = _cli(tmp_path / "bad", "--set", "num_kv_heads=4")
    assert p.returncode == 1, p.stdout + p.stderr
    bad = json.loads((tmp_path / "bad" / "smollm-135m__decode_32k__16x16.json").read_text())
    assert bad["status"] == "error" and bad["error"] and bad["traceback"]


def test_train_step_gives_zero_gradients_to_leaves_the_loss_does_not_reach():
    """A model fed embeddings never reads its token embedding: the step
    gives that leaf a zero gradient, as ``jax.grad`` does, and trains."""
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = dataclasses.replace(get_config("internvl2-2b").reduced(), dtype="float32",
                              param_dtype="float32", use_kernels="off")
    params = lm.init_model(cfg, 0, device="cpu")
    state = init_opt_state(params, OptConfig())
    rng = np.random.default_rng(0)
    batch = {"embeds": torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model),
                                                            dtype=np.float32)),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32))}
    _, new_state, metrics = steps.make_train_step(cfg, OptConfig())(params, state, batch)
    assert torch.count_nonzero(new_state["m"]["embed"]["tok"]) == 0
    assert torch.count_nonzero(new_state["m"]["frontend"]["proj"]) > 0
    assert math.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
