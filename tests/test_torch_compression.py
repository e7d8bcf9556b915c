"""The port's gradient compression against the JAX package.

* Error feedback: on a numpy-seeded gradient tree shaped like
  ``smollm-135m.reduced()``'s parameters (bfloat16 leaves beside the float32
  norm scales, as the model has them, or all float32), with a 0-d leaf
  added, 20 rounds of the port's ``ef_compress_grads`` equal the reference's
  bitwise at every round, in the compressed grads and in the error state,
  and the summed compressed grads come within 1% of the summed true ones
  (the bound of ``tests/test_checkpoint_fault.py``).
* The slice as a whole: the reduced model's ``lm_loss`` grads from each
  package, from the same numpy parameters, then one round each: at least
  99.9% of the int8 codes equal, and every compressed element within one
  quantization step of its row plus the grads' own tolerance (2e-4,
  ``tests/test_torch_lm.py``).
* ``all_reduce_int8`` over 4 gloo processes on the CPU against the
  reference's collective under ``jax.vmap(..., axis_name="d")`` on the same
  4 shards, within rtol 1e-6 (the sums may run in another order); every
  rank's result bitwise the same.  Each process group meets in a
  ``FileStore`` under ``tmp_path``, and the ranks are joined with a time
  limit, so a hung rank fails the test.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jget_config
from repro.distributed.compression import all_reduce_int8 as jall_reduce_int8
from repro.distributed.compression import ef_compress_grads as jef_compress_grads
from repro.distributed.compression import init_ef_state as jinit_ef_state
from repro.kernels.quant.ref import quantize_int8_ref as jquantize
from repro.model import lm as jlm
from repro_torch.configs import get_config
from repro_torch.distributed.compression import (
    all_reduce_int8,
    ef_compress_grads,
    init_ef_state,
)
from repro_torch.kernels.quant import dequantize_int8, kernel, quantize_int8
from repro_torch.model import lm
from repro_torch.model.convert import params_from_numpy
from repro_torch.pytree import tree_leaves, tree_map, tree_paths

SRC = Path(__file__).resolve().parents[1] / "src"
ROUNDS = 20
RANKS = 4
JOIN_SECONDS = 120


def grad_tree(dtype: str, seed: int = 0) -> dict:
    """numpy float32 values, rounded to each leaf's type, and the types: the
    reduced smollm-135m parameter tree's shapes, each leaf at its own scale,
    plus a 0-d leaf."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype=dtype,
                              param_dtype=dtype)
    params = lm.init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(seed)

    def leaf(p):
        x = rng.standard_normal(tuple(p.shape)) * 10.0 ** rng.uniform(-4, 0)
        t = torch.from_numpy(x.astype(np.float32)).to(p.dtype)
        return t.float().numpy(), p.dtype

    tree = tree_map(leaf, params)
    tree["loss_scale"] = (np.array(0.37, np.float32), torch.float32)
    return tree


def as_torch(tree):
    return tree_map(lambda t: torch.from_numpy(t[0]).to(t[1]), tree,
                    is_leaf=lambda t: isinstance(t, tuple))


def as_jax(tree):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    return tree_map(lambda t: jnp.asarray(t[0]).astype(jdt[t[1]]), tree,
                    is_leaf=lambda t: isinstance(t, tuple))


def flat32(tree) -> dict:
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in tree_paths(tree)}


def tree_norm(leaves) -> float:
    return float(np.sqrt(sum(float(np.sum(np.square(x, dtype=np.float64))) for x in leaves)))


@pytest.mark.parametrize("use_kernels", ["cuda", "off"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ef_rounds_match_reference_bitwise(dtype, use_kernels):
    tree = grad_tree(dtype)
    tg, jg = as_torch(tree), as_jax(tree)
    te, je = init_ef_state(tg), jinit_ef_state(jg)
    true = flat32(tg)
    total_c = {k: np.zeros_like(v) for k, v in true.items()}
    for r in range(ROUNDS):
        tc, te = ef_compress_grads(tg, te, use_kernels=use_kernels)
        jc, je = jef_compress_grads(jg, je)
        got_c, want_c = flat32(tc), flat32(jax.tree.map(np.asarray, jc))
        got_e, want_e = flat32(te), flat32(jax.tree.map(np.asarray, je))
        for k in true:
            assert np.array_equal(got_c[k], want_c[k]), (r, k)
            assert np.array_equal(got_e[k], want_e[k]), (r, k)
            total_c[k] += got_c[k]
        assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(tc), tree_leaves(tg)))
    rel = tree_norm(total_c[k] - ROUNDS * true[k] for k in true) / tree_norm(
        ROUNDS * v for v in true.values())
    assert rel < 0.01


def test_ef_state_is_updated_in_place_and_0d_leaves_pass_through():
    tg = as_torch(grad_tree("float32", seed=1))
    ef = init_ef_state(tg)
    before = [id(e) for e in tree_leaves(ef)]
    launches = kernel.LAUNCHES
    out, ef2 = ef_compress_grads(tg, ef)
    assert [id(e) for e in tree_leaves(ef2)] == before
    assert torch.equal(out["loss_scale"], tg["loss_scale"])
    assert out["loss_scale"] is not tg["loss_scale"]
    assert float(ef2["loss_scale"]) == 0.0
    assert kernel.LAUNCHES == launches  # CPU tensors: the plain version
    with pytest.raises(ValueError, match="use_kernels"):
        ef_compress_grads(tg, ef, use_kernels="pallas")


def test_slice_grads_then_one_ef_round_match_reference():
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), dtype="float32",
                               param_dtype="float32", use_pallas="off")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="float32",
                               param_dtype="float32", use_kernels="cuda")
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                tcfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    jgrads = jax.grad(lambda p: jlm.lm_loss(p, jcfg, {k: jnp.asarray(v) for k, v in
                                                      batch.items()})[0])(jparams)
    loss, _ = lm.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    keys = [k for k, _ in tree_paths(tparams)]
    tgrads = dict(zip(keys, torch.autograd.grad(loss, [v for _, v in tree_paths(tparams)])))
    jflat = {k: v for k, v in tree_paths(jax.tree.map(np.asarray, jgrads))}
    assert sorted(jflat) == sorted(tgrads)

    tc, _ = ef_compress_grads(tgrads, init_ef_state(tgrads), use_kernels="cuda")
    jc, _ = jef_compress_grads(jflat, jinit_ef_state(jflat))
    equal = total = 0
    for k, g in tgrads.items():
        rows = g.reshape(-1, g.shape[-1]) if g.dim() > 1 else g.reshape(1, -1)
        q, s = quantize_int8(rows)
        qj, sj = jquantize(jnp.asarray(rows.numpy()))
        equal += int((q.numpy() == np.asarray(qj)).sum())
        total += q.numel()
        step = np.maximum(s.numpy(), np.asarray(sj)).reshape(g.shape[:-1] + (1,))
        if g.dim() == 1:
            step = step.reshape(1)
        got, want = tc[k].numpy(), np.asarray(jc[k])
        assert (np.abs(got - want) <= step + 2e-4 + 2e-4 * np.abs(want)).all(), k
    assert equal / total >= 0.999, (equal, total)


def test_all_reduce_int8_one_rank_is_the_round_trip(tmp_path):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 96)).astype(np.float32))
    v = x[0].clone()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        got, got_v = all_reduce_int8(x), all_reduce_int8(v)
    finally:
        dist.destroy_process_group()
    assert torch.equal(got, dequantize_int8(*quantize_int8(x)))
    assert torch.equal(got_v, dequantize_int8(*quantize_int8(v[None]))[0])


RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import all_reduce_int8

    rank, world, store, shards = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        data = np.load(shards)
        out = {k: all_reduce_int8(torch.from_numpy(data[k][rank])).numpy() for k in data.files}
        np.savez(shards.replace(".npz", f"_out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
""")


def test_all_reduce_int8_four_gloo_ranks_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    shards = {
        "rows": rng.standard_normal((RANKS, 16, 576)).astype(np.float32),
        "vector": rng.standard_normal((RANKS, 576)).astype(np.float32),
        "stacked": (rng.standard_normal((RANKS, 2, 8, 128))
                    * np.array([1, 10, 0.1, 3], np.float32)[:, None, None, None]),
    }
    shards["stacked"] = shards["stacked"].astype(np.float32)
    path = tmp_path / "shards.npz"
    np.savez(path, **shards)
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(RANKS), str(tmp_path / "store"), str(path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * RANKS, logs
    outs = [np.load(tmp_path / f"shards_out{r}.npz") for r in range(RANKS)]
    collective = jax.vmap(lambda a: jall_reduce_int8(a, "d"), axis_name="d")
    for k, y in shards.items():
        want = np.asarray(collective(jnp.asarray(y)))
        for r in range(RANKS):
            assert outs[r][k].shape == y.shape[1:] and outs[r][k].dtype == np.float32
            assert np.array_equal(outs[r][k], outs[0][k]), (k, r)
            np.testing.assert_allclose(outs[r][k], want[r], rtol=1e-6, atol=0, err_msg=k)
