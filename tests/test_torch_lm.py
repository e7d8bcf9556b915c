"""The port's LM stack against the JAX package, on ``smollm-135m.reduced()``.

The JAX package initialises the parameters; ``params_from_numpy`` carries
them into the port, and the same numpy-seeded batch goes through both.  In
float32: attention within 1e-5 (the reference's own bound,
``tests/test_kernels.py``) on the plain path (``use_kernels="off"`` against
``use_pallas="off"``) and on the kernel path (the kernels' plain versions on
the CPU against the Pallas kernels in interpret mode); ``lm_loss`` within 1e-5
and every gradient within 2e-4; AdamW within 1e-6; one train step's loss and
gradient norm within 1e-5.  In bfloat16 the forward loss agrees within 2e-2.
The reference's steps are built directly (no mesh, no sharding context).
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.model import lm as jlm
from repro.model.attention import attention as jattention
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_update as jadamw_update
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.model import lm
from repro_torch.model.attention import attention
from repro_torch.model.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import OptConfig, adamw_update, init_opt_state
from repro_torch.pytree import tree_flatten, tree_map, tree_paths, tree_unflatten

JMODE = {"off": "off", "cuda": "interpret"}  # port use_kernels -> JAX use_pallas


def _cfgs(mode="off", dtype="float32"):
    jcfg = dataclasses.replace(
        jget_config("smollm-135m").reduced(), dtype=dtype, param_dtype=dtype,
        use_pallas=JMODE[mode],
    )
    tcfg = dataclasses.replace(
        get_config("smollm-135m").reduced(), dtype=dtype, param_dtype=dtype,
        use_kernels=mode,
    )
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(as_np, tcfg, device="cpu")


def _batch(cfg, B=2, S=64, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _flat(tree):
    return {k: v.detach().float().numpy() for k, v in tree_paths(tree)}


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(p.key) for p in path)] = np.asarray(leaf, np.float32)
    return out


def test_params_round_trip_and_structure():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    back = dict(tree_paths(params_to_numpy(tparams)))
    want = _jflat(jparams)
    assert back.keys() == want.keys()
    for key in want:
        assert np.array_equal(back[key], want[key]), key
    init = dict(tree_paths(params_to_numpy(lm.init_model(tcfg, 0, device="cpu"))))
    assert {k: v.shape for k, v in init.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("mode", ["off", "cuda"])
def test_attention_matches_reference(mode):
    jcfg, tcfg = _cfgs(mode)
    jparams, tparams = _params(jcfg, tcfg)
    B, S = 2, 64
    x = np.random.default_rng(2).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["pos0"])["mixer"]
    tp = {k: v[0] for k, v in tparams["layers"]["pos0"]["mixer"].items()}
    want, _ = jattention(jp, jnp.asarray(x), jcfg, jnp.arange(S, dtype=jnp.int32))
    got, _ = attention(tp, torch.from_numpy(x), tcfg, torch.arange(S))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["off", "cuda"])
def test_lm_loss_and_grads_match_reference(mode):
    jcfg, tcfg = _cfgs(mode)
    jparams, tparams = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b), has_aux=True
    ))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = lm.lm_loss(tparams, tcfg, tbatch)
    keys = [k for k, _ in tree_paths(tparams)]
    grads = torch.autograd.grad(loss, [v for _, v in tree_paths(tparams)])
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=1e-5)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"]) == batch["labels"].size - 3
    want = _jflat(jgrads)
    assert sorted(keys) == sorted(want)
    for key, g in zip(keys, grads):
        np.testing.assert_allclose(g.numpy(), want[key], atol=2e-4, rtol=2e-4, err_msg=key)


def test_adamw_matches_reference():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _params(jcfg, tcfg)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jopt, topt = JOptConfig(**kw), OptConfig(**kw)
    jstate, tstate = jinit_opt_state(jparams, jopt), init_opt_state(tparams, topt)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in _jflat(jparams).items()}
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(g["/".join(str(p.key) for p in path)]), jparams
        )
        tgrads = params_from_numpy(jax.tree.map(np.asarray, jgrads), tcfg, device="cpu")
        jparams, jstate, jm = jadamw_update(jparams, jgrads, jstate, jopt)
        tparams, tstate, tm = adamw_update(tparams, tgrads, tstate, topt)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for name, jt, tt in (("params", jparams, tparams), ("m", jstate["m"], tstate["m"]),
                         ("v", jstate["v"], tstate["v"])):
        want, got = _jflat(jt), _flat(tt)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name}/{key}")


@pytest.mark.parametrize("mode,accum", [("cuda", 1), ("off", 2)])
def test_train_step_matches_reference(mode, accum):
    jcfg, tcfg = _cfgs(mode)
    jparams, tparams = _params(jcfg, tcfg)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt, topt = JOptConfig(**kw), OptConfig(**kw)
    batch = _batch(jcfg, B=4, S=64, seed=4)
    jstep = jax.jit(jmake_train_step(jcfg, jopt, accum))
    _, _, jm = jstep(jparams, jinit_opt_state(jparams, jopt),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    _, _, tm = make_train_step(tcfg, topt, accum)(tparams, init_opt_state(tparams, topt), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               atol=1e-5, rtol=1e-5)


def test_bf16_forward_loss_matches_reference():
    jcfg, tcfg = _cfgs("cuda", dtype="bfloat16")
    jparams, tparams = _params(jcfg, tcfg)
    assert tparams["embed"]["tok"].dtype == torch.bfloat16
    batch = _batch(jcfg, seed=5)
    jloss, _ = jax.jit(lambda p, b: jlm.lm_loss(p, jcfg, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    with torch.no_grad():
        loss, _ = lm.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-2, rtol=2e-2)


def test_tree_helpers_release_their_leaves_without_the_collector():
    """The tree walkers form no reference cycle: a parameter tree is freed as
    soon as its last reference goes, not at the next cyclic collection (on
    a card a lingering tree is a second copy of the weights)."""
    tree = {"a": [torch.ones(3), (torch.zeros(2),)], "b": {"c": torch.ones(1)}}
    ref = weakref.ref(tree["b"]["c"])
    enabled = gc.isenabled()
    gc.disable()
    try:
        leaves, treedef = tree_flatten(tree)
        tree = tree_unflatten(treedef, leaves)
        tree = tree_map(lambda t: t * 1, tree)
        tree_paths(tree)
        del leaves, tree
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_unported_paths_raise():
    """MoE and SSM training run through the kernel path (its plain versions
    on the CPU; ``tests/test_torch_train_kernels.py`` holds them to the
    reference); ``batch_chunks > 1`` runs (the dense model's rows are
    independent, so two chunks give the one-chunk hidden states) and raises
    only on a batch it does not divide; a remat policy the reference does
    not have raises."""
    _, tcfg = _cfgs()
    tparams = lm.init_model(tcfg, 0, device="cpu")
    tokens = torch.zeros(2, 64, dtype=torch.int32)
    for arch in ("deepseek-moe-16b", "mamba2-130m"):
        cfg = get_config(arch).reduced()
        assert cfg.use_kernels == "cuda"
        params = lm.init_model(cfg, 0, device="cpu")
        leaves = [v for _, v in tree_paths(params)]
        loss, _ = lm.lm_loss(params, cfg, {"tokens": tokens[:, :16], "labels": tokens[:, :16]})
        grads = torch.autograd.grad(loss, leaves)
        assert torch.isfinite(loss) and all(bool(torch.isfinite(g).all()) for g in grads), arch
    one, _, _ = lm.forward_hidden(tparams, tcfg, tokens)
    two, _, _ = lm.forward_hidden(tparams, dataclasses.replace(tcfg, batch_chunks=2), tokens)
    torch.testing.assert_close(two, one, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="batch_chunks=3 does not divide"):
        lm.forward_hidden(tparams, dataclasses.replace(tcfg, batch_chunks=3), tokens)
    with pytest.raises(NotImplementedError, match="remat policy 'offload'"):
        lm.forward_hidden(tparams, dataclasses.replace(tcfg, remat="offload"), tokens)
    # without CUDA the helpers refuse the default device instead of the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm.init_model(tcfg, 0)
