"""Sharded steps of the port over 4 gloo ranks on the CPU (``torch_ranks``),
held to the JAX package's unsharded functions, which is GSPMD's contract:
the function computed under a mesh is the one computed on one device.

* Training: the reduced smollm-135m, mamba2-130m and deepseek-moe-16b, a
  smollm whose query heads do not divide the model axis (``make_rules``
  picks ``seq_q``, the context-parallel chunked path) and deepseek with
  ``batch_chunks=2``, on a (2, 2) and a (1, 4) mesh under ``make_rules``:
  loss and every gradient within 2e-4 of ``jax.value_and_grad`` of the
  reference, within 1e-5 of the port's unsharded step; one AdamW step
  (moments as DTensors of their parameter's placements) within 1e-5 of
  the unsharded one.
* The MoE at B*S > 4096 with ``seq`` on the model axis (P = 2), held to the
  reference's ``moe_ffn`` on ``x.reshape(B*P, S/P, d)``: the same groups,
  capacity and balance mean.
* ``make_generate(cfg, mesh, rules)``: greedy tokens equal to the port's
  unsharded generate (a kv-head and a kv-sequence split of the cache).
* Decode steps after a prefill, teacher-forced: every step's sharded logits
  and the final cache within 1e-5 of the port's unsharded decode, whose
  logits are within 2e-4 of the reference's ``decode_step`` at the same
  positions; on the (1, 4) mesh the writes cross a kv-sequence shard.
* ``all_reduce_int8(x, "data")`` against the reference's collective.
* A checkpoint of parameters placed on (2, 2) restored onto (1, 4) by
  ``restore(shardings=)`` and ``TrainSupervisor(shardings=)``, bitwise.

Every spawn runs under ``torch_ranks.JOIN_SECONDS`` and every process group
under a 60 s collective limit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.distributed.compression import all_reduce_int8 as jall_reduce_int8
from repro.model import lm as jlm
from repro.model.moe import moe_ffn as jmoe_ffn
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import AbstractMesh
from torch_ranks import save_tree, spawn

# (name, arch, config changes, one AdamW step too)
RUNS = {
    (2, 2): [
        ("smollm", "smollm-135m", {}, True),
        ("mamba2", "mamba2-130m", {}, True),
        ("deepseek", "deepseek-moe-16b", {}, True),
        ("seq_q", "smollm-135m", {"num_heads": 3, "num_kv_heads": 1, "use_kernels": "off"},
         False),
        ("chunks", "deepseek-moe-16b", {"batch_chunks": 2}, False),
    ],
    (1, 4): [
        ("smollm", "smollm-135m", {}, True),
        ("mamba2", "mamba2-130m", {}, True),
        ("deepseek", "deepseek-moe-16b", {}, True),
        ("seq_q", "smollm-135m", {"num_heads": 6, "num_kv_heads": 2, "use_kernels": "off"},
         False),
    ],
}
CASES = [(m, r[0]) for m, runs in RUNS.items() for r in runs]
STEPS = [(m, r[0]) for m, runs in RUNS.items() for r in runs if r[3]]
REF_TOL, PORT_TOL = 2e-4, 1e-5


def _batch(cfg, B, S, seed=7):
    toks = np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :2] = -1  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jcfg(arch, extra):
    extra = dict(extra)
    mode = extra.pop("use_kernels", "cuda")
    return dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                               param_dtype="float32",
                               use_pallas="interpret" if mode == "cuda" else "off", **extra)


def _tcfg(arch, extra):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               param_dtype="float32", **extra)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Per mesh: rank 0's results and the reference's loss and gradients."""
    tmp = tmp_path_factory.mktemp("train")
    out = {}
    for mesh, runs in RUNS.items():
        args, refs = [], {}
        for name, arch, extra, step in runs:
            jcfg = _jcfg(arch, extra)
            jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
            batch = _batch(jcfg, B=4, S=32)
            (jloss, _), jgrads = jax.jit(jax.value_and_grad(
                lambda p, b, c=jcfg: jlm.lm_loss(p, c, b), has_aux=True
            ))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
            refs[name] = (float(jloss), _jflat(jgrads))
            args.append({
                "name": name, "arch": arch, "extra": extra, "step": step,
                "params": save_tree(tmp / f"{mesh}_{name}_p.npz", _jflat(jparams)),
                "batch": save_tree(tmp / f"{mesh}_{name}_b.npz", batch),
            })
        res = spawn(tmp / f"m{mesh[0]}x{mesh[1]}", "train", 4, {"mesh": list(mesh), "runs": args})
        out[mesh] = (res[0], refs)
    return out


def test_heads_that_do_not_divide_pick_context_parallel():
    for mesh, runs in RUNS.items():
        m = AbstractMesh(mesh, ("data", "model"))
        for name, arch, extra, _ in runs:
            rules = make_rules(_tcfg(arch, extra), m)
            assert (rules["seq_q"] == "model") == (name == "seq_q"), (mesh, name)


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_loss_and_grads_match_reference(trained, mesh, name):
    res, refs = trained[mesh]
    jloss, jgrads = refs[name]
    np.testing.assert_allclose(res[f"{name}/loss/sharded"], jloss, atol=REF_TOL, rtol=REF_TOL)
    keys = sorted(k.split("/", 2)[2].rsplit("/", 1)[0] for k in res
                  if k.startswith(f"{name}/grad/") and k.endswith("/sharded"))
    assert keys == sorted(jgrads)
    for k in keys:
        np.testing.assert_allclose(res[f"{name}/grad/{k}/sharded"], jgrads[k], atol=REF_TOL,
                                   rtol=REF_TOL, err_msg=k)


@pytest.mark.parametrize("mesh,name", CASES)
def test_sharded_matches_unsharded_port(trained, mesh, name):
    res, _ = trained[mesh]
    np.testing.assert_allclose(res[f"{name}/loss/sharded"], res[f"{name}/loss/port"],
                               atol=PORT_TOL, rtol=PORT_TOL)
    for k in res:
        if k.startswith(f"{name}/grad/") and k.endswith("/sharded"):
            np.testing.assert_allclose(res[k], res[k[:-len("sharded")] + "port"],
                                       atol=PORT_TOL, rtol=PORT_TOL, err_msg=k)


@pytest.mark.parametrize("mesh,name", STEPS)
def test_sharded_adamw_step_matches_unsharded(trained, mesh, name):
    res, _ = trained[mesh]
    np.testing.assert_allclose(res[f"{name}/grad_norm/sharded"], res[f"{name}/grad_norm/port"],
                               atol=PORT_TOL, rtol=PORT_TOL)
    keys = [k for k in res if k.startswith(f"{name}/step/") and k.endswith("/sharded")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(res[k], res[k[:-len("sharded")] + "port"], atol=PORT_TOL,
                                   rtol=PORT_TOL, err_msg=k)


def test_moe_sequence_groups_match_reference(tmp_path):
    """P = 2 sequence shards a row: the reference's ``moe_ffn`` on the
    (B*P, S/P, d) reshape is the function the sharded MoE computes."""
    jcfg = _jcfg("deepseek-moe-16b", {})
    layer = jlm.init_model(jcfg, jax.random.PRNGKey(0))["layers"]["pos0"]["ffn"]
    jp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a[0], np.float32)), layer)
    B, S, d, P = 2, 2304, jcfg.d_model, 2
    x = np.random.default_rng(3).standard_normal((B, S, d)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)

    def ref(p, x):
        y, aux = jmoe_ffn(p, x.reshape(B * P, S // P, d), jcfg)
        y = y.reshape(B, S, d)
        return jnp.sum(y * y) + aux["moe_balance"], (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(ref, has_aux=True)(jp, jnp.asarray(x))
    res = spawn(tmp_path, "moe_groups", 4, {
        "mesh": [2, 2], "arch": "deepseek-moe-16b",
        "params": save_tree(tmp_path / "p.npz", _jflat(jp)), "x": str(tmp_path / "x.npy"),
    })[0]
    assert int(res["P"]) == P
    np.testing.assert_allclose(res["y"], np.asarray(jy), atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(res["balance"], float(jaux["moe_balance"]), atol=REF_TOL,
                               rtol=REF_TOL)
    np.testing.assert_allclose(res["zloss"], float(jaux["moe_zloss"]), atol=REF_TOL,
                               rtol=REF_TOL)
    for k, g in _jflat(jg).items():
        np.testing.assert_allclose(res[f"grad/{k}"], g, atol=REF_TOL, rtol=REF_TOL, err_msg=k)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    runs = [{"name": f"{arch}_{m[0]}x{m[1]}", "arch": arch, "mesh": list(m)}
            for m in ((2, 2), (1, 4))
            for arch in ("smollm-135m", "mamba2-130m", "deepseek-moe-16b")]
    return runs, spawn(tmp_path_factory.mktemp("gen"), "generate", 4, {"runs": runs})


@pytest.mark.parametrize("i", range(6))
def test_sharded_generate_matches_unsharded(generated, i):
    runs, res = generated
    name = runs[i]["name"]
    for r in res:  # every rank returns the gathered tokens
        assert r[f"{name}/sharded"].shape == (4, 8)
        np.testing.assert_array_equal(r[f"{name}/sharded"], r[f"{name}/port"], err_msg=name)
        assert r[f"{name}/steps"].tolist() == [8, 8]


DECODE_ARCHS = ("smollm-135m", "mamba2-130m", "deepseek-moe-16b")
DECODE = [(m, a) for m in ((2, 2), (1, 4)) for a in DECODE_ARCHS]
DECODE_B, DECODE_S0, DECODE_S = 4, 16, 24


def _splice(big, small):
    """The reference's splice of a prefill cache into a decode cache."""
    return jax.tree.map(
        lambda b, s: jnp.pad(s.astype(b.dtype), [(0, x - y) for x, y in zip(b.shape, s.shape)]),
        big, small)


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    """The reference's decode logits per arch, and every rank's results."""
    tmp = tmp_path_factory.mktemp("decode")
    B, S0, S = DECODE_B, DECODE_S0, DECODE_S
    runs, refs = [], {}
    for arch in DECODE_ARCHS:
        jcfg = _jcfg(arch, {})
        jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(5).integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
        np.save(tmp / f"{arch}_t.npy", tokens)
        _, jcache = jax.jit(lambda p, t, c=jcfg: jlm.prefill(p, c, tokens=t))(
            jparams, jnp.asarray(tokens[:, :S0]))
        jcache = _splice(jlm.init_cache(jcfg, B, S), jcache)
        jdecode = jax.jit(lambda p, c, t, i, cf=jcfg: jlm.decode_step(p, cf, c, t, i))
        logs = []
        for i in range(S0, S):
            jpos = jnp.int32(i) if i % 2 else jnp.full((B,), i, jnp.int32)
            jlog, jcache = jdecode(jparams, jcache, jnp.asarray(tokens[:, i]), jpos)
            logs.append(np.asarray(jlog))
        refs[arch] = np.stack(logs)
        params = save_tree(tmp / f"{arch}_p.npz", _jflat(jparams))
        runs += [{"name": f"{arch}_{m[0]}x{m[1]}", "arch": arch, "mesh": list(m),
                  "params": params, "tokens": str(tmp / f"{arch}_t.npy")}
                 for m in ((2, 2), (1, 4))]
    return refs, spawn(tmp, "decode", 4, {"runs": runs, "S0": S0, "S": S})


@pytest.mark.parametrize("mesh,arch", DECODE)
def test_sharded_decode_logits_match_unsharded_and_reference(decoded, mesh, arch):
    refs, res = decoded
    name = f"{arch}_{mesh[0]}x{mesh[1]}"
    for r in res:  # logits and the cache are gathered on every rank
        np.testing.assert_allclose(r[f"{name}/sharded"], r[f"{name}/port"], atol=PORT_TOL,
                                   rtol=PORT_TOL, err_msg=name)
        caches = [k for k in r if k.startswith(f"{name}/cache/") and k.endswith("/sharded")]
        assert caches
        for k in caches:
            np.testing.assert_allclose(r[k], r[k[:-len("sharded")] + "port"], atol=PORT_TOL,
                                       rtol=PORT_TOL, err_msg=k)
    np.testing.assert_allclose(res[0][f"{name}/port"], refs[arch], atol=REF_TOL, rtol=REF_TOL,
                               err_msg=name)


def test_decode_writes_cross_a_kv_sequence_shard(decoded):
    """On (1, 4) smollm's decode cache is split 4 ways along its sequence,
    and the decode writes positions of two different shards."""
    _, res = decoded
    ways = int(res[0]["smollm-135m_1x4/kv_seq_ways"])
    assert ways == 4 and int(res[0]["smollm-135m_2x2/kv_seq_ways"]) == 1
    shard = DECODE_S // ways
    assert DECODE_S0 // shard != (DECODE_S - 1) // shard


def test_kv_sequence_split_is_what_the_rules_pick():
    """smollm's 2 kv heads do not divide a model axis of 4: the decode cache
    of the (1, 4) generate above is split along its sequence."""
    from repro_torch.configs import get_config

    rules = make_rules(get_config("smollm-135m").reduced(), AbstractMesh((1, 4), ("data", "model")))
    assert rules["kv_seq"] == "model" and rules["kv_heads"] is None


def test_all_reduce_int8_over_a_mesh_axis_matches_reference(tmp_path):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((4, 16, 96)) * np.array([1, 10, 0.1, 3])[:, None, None])
    np.save(tmp_path / "x.npy", x.astype(np.float32))
    res = spawn(tmp_path, "int8", 4, {"mesh": [2, 2], "x": str(tmp_path / "x.npy")})
    x = x.astype(np.float32)
    collective = jax.vmap(lambda a: jall_reduce_int8(a, "d"), axis_name="d")
    for model in (0, 1):  # each data group: the two ranks of one model coordinate
        ranks = [r for r in range(4) if res[r]["coord"].tolist()[1] == model]
        want = np.asarray(collective(jnp.asarray(x[ranks])))
        for j, r in enumerate(ranks):
            np.testing.assert_allclose(res[r]["out"], want[j], rtol=1e-6, atol=0)
            assert np.array_equal(res[r]["out"], res[ranks[0]]["out"])


def test_restore_onto_another_mesh_is_bitwise(tmp_path):
    res = spawn(tmp_path, "restore", 4, {"from": [2, 2], "to": [1, 4], "arch": "smollm-135m",
                                         "dir": str(tmp_path / "ckpt")})
    for r in res:
        assert int(r["leaves"]) > 0 and r["bitwise"].all()
        assert int(r["step"]) == 3
