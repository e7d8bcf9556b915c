"""The port's logical-axis sharding (``distributed/sharding.py``,
``launch/mesh.py``) against the reference's, and its DTensor pieces on a
one-rank gloo mesh in this process.

* ``BASE_RULES``, ``make_rules`` and ``full_dp_rules`` equal the
  reference's for every config on the (16, 16) and (2, 16, 16) meshes (the
  reference's own abstract meshes, ``tests/helpers.py::abstract_mesh``);
  ``make_pspec`` trees of every config's parameters and decode cache equal
  the reference's entry for entry.
* ``logical_axes``, ``param_count`` and ``abstract_model`` against the
  reference's for every config; ``make_production_mesh``'s shapes and names.
* ``to_placements``: tuple entries in mesh order, the raise on a reversed
  tuple, size-1 mesh dims replicated.
* ``constrain``: the identity without a context, a raise on a plain tensor
  inside one; ``make_test_mesh`` raises without a process group.
* Each kernel boundary (``kernels/*/ops.py``) on DTensors: the placements it
  keeps and gathers, and its values bitwise the plain op's (one rank: the
  shards are the whole tensors).
* One sharded training step of the reduced smollm-135m on a (1, 1) mesh
  equals the unsharded step bitwise, the claim the card checks at full
  width.
"""

import dataclasses
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from helpers import abstract_mesh
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.distributed import sharding as jsh
from repro.model import layers as jlayers
from repro.model import lm as jlm
from repro_torch.configs import get_config, list_archs
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh, make_test_mesh
from repro_torch.model import layers, lm
from repro_torch.pytree import tree_flatten, tree_paths

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _archs():
    from repro.configs import load_all as jload
    from repro_torch.configs import load_all

    jload()
    load_all()
    assert sorted(list_archs()) == sorted(jlist_archs())
    return sorted(list_archs())


ARCHS = _archs()
CASES = [(a, m) for a in ARCHS for m in range(len(MESHES))]


def _meshes(i):
    shape, names = MESHES[i]
    return abstract_mesh(shape, names), AbstractMesh(shape, names)


def test_base_rules_equal_reference():
    assert sh.BASE_RULES == jsh.BASE_RULES


@pytest.mark.parametrize("arch,mesh", CASES)
def test_rules_equal_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    assert sh.make_rules(get_config(arch), tm) == jsh.make_rules(jget_config(arch), jm)
    assert sh.full_dp_rules(get_config(arch), tm) == jsh.full_dp_rules(jget_config(arch), jm)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_pspecs_equal_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for rules_of in (lambda c, m, s: s.make_rules(c, m), lambda c, m, s: s.full_dp_rules(c, m)):
        want = jsh.defs_pspecs(jlm.model_defs(jcfg), jm, rules_of(jcfg, jm, jsh))
        got = sh.defs_pspecs(lm.model_defs(tcfg), tm, rules_of(tcfg, tm, sh))
        jflat = {"/".join(str(p.key) for p in path): tuple(s) for path, s in
                 jax.tree_util.tree_flatten_with_path(
                     want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        assert {k: tuple(s) for k, s in _spec_paths(got)} == jflat


def _spec_paths(tree, prefix=""):
    """``(key path, spec)`` of a tree whose leaves are PartitionSpecs."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        assert isinstance(tree, sh.PartitionSpec)
        yield prefix, tree


@pytest.mark.parametrize("arch,mesh", CASES)
def test_cache_pspecs_equal_reference(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    B, S = 128, 4096
    jshapes = jax.eval_shape(lambda: jlm.init_cache(jcfg, B, S))
    want = jsh.tree_pspecs(jlm.cache_logical(jcfg), jax.tree.map(lambda a: a.shape, jshapes),
                           jm, jsh.make_rules(jcfg, jm))
    tshapes = lm.init_cache(tcfg, B, S, device="meta")
    got = sh.tree_pspecs(lm.cache_logical(tcfg),
                         {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in
                          tshapes.items()}, tm, sh.make_rules(tcfg, tm))
    jflat = {"/".join(str(p.key) for p in path): tuple(s) for path, s in
             jax.tree_util.tree_flatten_with_path(
                 want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert {k: tuple(s) for k, s in _spec_paths(got)} == jflat
    assert lm.cache_logical(tcfg) == jlm.cache_logical(jcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_param_count_and_abstract_model_equal_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jdefs, tdefs = jlm.model_defs(jcfg), lm.model_defs(tcfg)
    assert layers.param_count(tdefs) == jlayers.param_count(jdefs)
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    jaxes = {"/".join(str(p.key) for p in path): a for path, a in
             jax.tree_util.tree_flatten_with_path(jlayers.logical_axes(jdefs), is_leaf=is_axes)[0]}
    taxes = dict(_paths(layers.logical_axes(tdefs)))
    assert taxes == jaxes
    jabs = {"/".join(str(p.key) for p in path): (tuple(a.shape), str(a.dtype)) for path, a in
            jax.tree_util.tree_flatten_with_path(jlm.abstract_model(jcfg))[0]}
    tabs = {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in
            tree_paths(lm.abstract_model(tcfg))}
    assert tabs == jabs
    assert all(t.device.type == "meta" for _, t in tree_paths(lm.abstract_model(tcfg)))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def test_production_mesh_shapes_and_names():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert dict(one.shape) == {"data": 16, "model": 16} and one.axis_names == ("data", "model")
    assert dict(two.shape) == {"pod": 2, "data": 16, "model": 16}
    assert two.axis_names == ("pod", "data", "model") and two.size == 512


def test_to_placements_tuple_entries_follow_the_mesh_order():
    m = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    spec = sh.make_pspec(("batch", "seq", None), (8, 16, 4), m, sh.BASE_RULES)
    assert spec == sh.P(("pod", "data"), "model", None)
    assert sh.to_placements(spec, m) == (Shard(0), Shard(0), Shard(1))
    assert sh.to_placements(sh.P(None, "data"), m) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's axis order"):
        sh.to_placements(sh.P(("data", "pod"), None), m)
    with pytest.raises(ValueError, match="not an axis"):
        sh.to_placements(sh.P("stage"), m)
    one = AbstractMesh((1, 4), ("data", "model"))  # a size-1 dim replicates
    assert sh.to_placements(sh.P("data", "model"), one) == (Replicate(), Shard(1))


def test_constrain_is_identity_without_a_context():
    x = torch.ones(4, 8)
    assert sh.current_ctx() is None
    assert sh.constrain(x, ("batch", "seq")) is x
    assert sh.replicate(x) is x


def test_make_test_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_test_mesh()


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        yield make_test_mesh()
    finally:
        dist.destroy_process_group()


def test_test_mesh_and_constrain_on_one_rank(one_rank):
    mesh = one_rank
    assert mesh.device_type == "cpu" and tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    cfg = get_config("smollm-135m").reduced()
    with sh.shard_ctx(mesh, sh.make_rules(cfg, mesh)):
        with pytest.raises(TypeError, match="left the mesh"):
            sh.constrain(torch.ones(4, 8), ("batch", "seq"))
        x = distribute_tensor(torch.arange(32.0).reshape(4, 8), mesh, [Shard(0), Shard(1)])
        y = sh.constrain(x, ("batch", "seq"))
        assert tuple(y.placements) == (Replicate(), Replicate())  # size-1 dims
        assert torch.equal(y.full_tensor(), x.full_tensor())
        r = sh.replicate(torch.ones(3))
        assert isinstance(r, DTensor) and tuple(r.placements) == (Replicate(), Replicate())


def _shards(mesh, t, *placements):
    return distribute_tensor(t, mesh, list(placements))


def test_kernel_boundaries_keep_what_they_take_and_match_the_plain_ops(one_rank):
    """Shards on the dims a kernel takes locally stay; others are gathered;
    the values are the plain op's bit for bit."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import grouped_matmul
    from repro_torch.kernels.quant.ops import quantize_int8
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    mesh = one_rank
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    q, k, v = r(2, 128, 4, 16), r(2, 128, 2, 16), r(2, 128, 2, 16)
    out = flash_attention(_shards(mesh, q, Shard(0), Shard(2)), _shards(mesh, k, Shard(0), Shard(2)),
                          _shards(mesh, v, Shard(0), Shard(2)))
    assert tuple(out.placements) == (Shard(0), Shard(2))
    assert torch.equal(out.to_local(), flash_attention(q, k, v))
    out = flash_attention(_shards(mesh, q, Shard(1), Shard(2)), _shards(mesh, k, Shard(1), Shard(2)),
                          _shards(mesh, v, Shard(1), Shard(2)))
    assert tuple(out.placements) == (Replicate(), Shard(2))  # the sequence is gathered

    x, s = r(2, 8, 64), r(64)
    y = rmsnorm(_shards(mesh, x, Shard(0), Shard(2)), _shards(mesh, s, Replicate(), Replicate()))
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert torch.equal(y.to_local(), rmsnorm(x, s))

    xs, dt, A = r(2, 16, 4, 8), torch.rand(2, 16, 4, generator=g), -torch.rand(4, generator=g)
    Bm, Cm = r(2, 16, 8), r(2, 16, 8)
    ys, st = ssd_scan(*(_shards(mesh, t, *pl) for t, pl in (
        (xs, (Shard(0), Shard(2))), (dt, (Shard(0), Shard(2))), (A, (Replicate(), Shard(0))),
        (Bm, (Shard(0), Replicate())), (Cm, (Shard(0), Replicate())))), chunk=8)
    assert tuple(ys.placements) == (Shard(0), Shard(2)) and tuple(st.placements) == (Shard(0),
                                                                                       Shard(1))
    yp, sp = ssd_scan(xs, dt, A, Bm, Cm, chunk=8)
    assert torch.equal(ys.to_local(), yp) and torch.equal(st.to_local(), sp)

    xe, we = r(4, 8, 16), r(4, 16, 32)
    o = grouped_matmul(_shards(mesh, xe, Shard(1), Shard(0)), _shards(mesh, we, Shard(1), Shard(0)))
    assert tuple(o.placements) == (Shard(1), Shard(0))
    assert torch.equal(o.to_local(), grouped_matmul(xe, we))

    qx = r(6, 32)
    qq, qs = quantize_int8(_shards(mesh, qx, Shard(0), Shard(1)))
    assert tuple(qq.placements) == (Shard(0), Replicate())
    pq, ps = quantize_int8(qx)
    assert torch.equal(qq.to_local(), pq) and torch.equal(qs.to_local(), ps)


def test_one_rank_sharded_step_is_the_unsharded_step_bitwise(one_rank):
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state

    mesh = one_rank
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="float32",
                              param_dtype="float32")
    params = lm.init_model(cfg, 0, device="cpu")
    toks = np.random.default_rng(7).integers(3, cfg.vocab_size, (4, 33)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    rules = sh.make_rules(cfg, mesh)
    placed = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
    step, opt = make_train_step(cfg, OptConfig()), OptConfig()
    new, _, m = step(params, init_opt_state(params, opt), batch)
    with sh.shard_ctx(mesh, rules):
        snew, _, sm = step(placed, init_opt_state(placed, opt), batch)
    assert float(m["loss"]) == float(sm["loss"].full_tensor())
    assert float(m["grad_norm"]) == float(sm["grad_norm"])
    leaves = tree_flatten(snew)[0]
    assert all(isinstance(t, DTensor) for t in leaves)
    for (k, a), b in zip(tree_paths(new), leaves):
        assert torch.equal(a, b.full_tensor()), k


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-moe-16b"])
def test_recompute_in_another_thread_keeps_the_context(one_rank, arch):
    """On a card the backward (and each checkpoint's recompute) runs in
    autograd's device thread, where the forward's thread-local context is
    not set: the recompute must run under the forward's context all the
    same.  Here the backward runs in a thread of its own."""
    import threading

    mesh = one_rank
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              param_dtype="float32")
    params = lm.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rules = sh.make_rules(cfg, mesh)
    placed = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
    want = torch.autograd.grad(lm.lm_loss(params, cfg, batch)[0], tree_flatten(params)[0])
    with sh.shard_ctx(mesh, rules):
        sb = {k: distribute_tensor(v, mesh, sh.ctx_placements(("batch", "seq"), v.shape))
              for k, v in batch.items()}
        loss, _ = lm.lm_loss(placed, cfg, sb)
    got = []
    worker = threading.Thread(target=lambda: got.append(
        torch.autograd.grad(loss, tree_flatten(placed)[0])))
    worker.start()
    worker.join()
    assert got, "the backward in another thread raised"
    for a, b in zip(want, got[0]):
        assert torch.equal(a, b.full_tensor())
