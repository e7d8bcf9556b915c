"""The port's MoE FFN (``repro_torch/model/moe.py``) against the JAX package.

On ``deepseek-moe-16b.reduced()`` (8 routed experts, top-2, expert width 32,
d 64, 2 shared experts), with weights carried across as numpy arrays:

* ``moe_ffn`` against the JAX ``moe_ffn`` in both dispatch branches (one
  global group for ``B * S <= 4096``; one group per batch row above): y within
  1e-5 in float32, the load-balance and z-loss within 1e-6;
* a tie in bfloat16: two experts with equal router columns, so equal bf16
  logits; where they meet at the k-th place the lower index wins in both
  packages, and the port's experts equal the JAX dispatch's exactly;
* an overflow: a router that sends every token to one expert; the counts,
  the dropped assignments and y equal the JAX function's;
* the bfloat16 combine equals the JAX ``_group_combine`` bitwise on the CPU
  (the same additions in the same order);
* the model: the ``forward_hidden`` aux and ``lm_loss`` (and its gradients)
  under ``use_kernels="off"`` against the JAX model in float32; under
  ``"cuda"`` the FFN's gradients equal the ``"off"`` path's (the kernel
  path against the reference is ``tests/test_torch_train_kernels.py``).

Prefill and decode of the MoE configs against the JAX model and engine are in
``tests/test_torch_serving.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.model import lm as jlm
from repro.model import moe as jmoe
from repro.model.layers import init_params as jinit_params
from repro_torch.configs import get_config
from repro_torch.model import lm, moe
from repro_torch.model.convert import params_from_numpy
from repro_torch.pytree import tree_flatten

ARCH = "deepseek-moe-16b"
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _cfgs(dtype="float32", mode="off", **kw):
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype, param_dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype, param_dtype=dtype,
                               use_kernels=mode, **kw)
    return jcfg, tcfg


def _ffn_params(jcfg, dtype, seed=0):
    """The MoE FFN's parameters in both packages, from one JAX draw."""
    jp = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed), dtype)
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = jax.tree.map(
        lambda a, j: torch.from_numpy(np.array(a)).to(TD[str(j.dtype)]), as_np, jp)
    return jp, tp


def _x(B, S, d, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    return jnp.asarray(x, JD[dtype]), torch.from_numpy(x).to(TD[dtype])


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("B,S", [(2, 8), (3, 40), (2, 2056)])
@pytest.mark.parametrize("mode", ["off", "cuda"])
def test_moe_ffn_matches_reference(B, S, mode):
    jcfg, tcfg = _cfgs(mode=mode)
    jp, tp = _ffn_params(jcfg, "float32")
    jx, tx = _x(B, S, jcfg.d_model, "float32")
    jy, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        ty, taux = moe.moe_ffn(tp, tx, tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    for k in ("moe_balance", "moe_zloss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def _bf16_probs(x, router):
    """float32 probabilities of bfloat16 logits, as moe_ffn makes them."""
    logits = torch.matmul(x, router.bfloat16()).float()
    return torch.softmax(logits, dim=-1)


def _jax_experts(meta, n_tokens, capacity):
    """Each token's chosen experts (ascending) and its dropped (token, expert)
    pairs from the JAX dispatch metadata."""
    t, e, slot, _, counts = (np.asarray(a) for a in meta)
    chosen = [sorted(e[t == i].tolist()) for i in range(n_tokens)]
    drop = slot >= capacity
    return chosen, sorted(zip(t[drop].tolist(), e[drop].tolist())), counts


def _port_experts(meta):
    _, kept, _, counts, gate_idx = meta
    asc = torch.sort(gate_idx.reshape(-1, gate_idx.shape[-1]), dim=-1).values
    chosen = asc.tolist()
    dropped = sorted((t, e) for t, (es, ks) in enumerate(zip(chosen, kept.tolist()))
                     for e, k in zip(es, ks) if not k)
    return chosen, dropped, counts.reshape(-1).numpy()


def test_router_tie_goes_to_the_lower_expert():
    jcfg, tcfg = _cfgs("bfloat16", mode="cuda")
    jp, tp = _ffn_params(jcfg, "bfloat16")
    router = np.array(jp["router"])
    router[:, 5] = router[:, 3]  # experts 3 and 5: equal logits for every token
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    B, S, k = 2, 32, jcfg.experts_per_token
    jx, tx = _x(B, S, jcfg.d_model, "bfloat16", seed=2)
    probs = _bf16_probs(tx.reshape(B * S, -1), tp["router"])
    assert torch.equal(probs[:, 3], probs[:, 5])
    above = (probs > probs[:, 3:4]).sum(-1)  # experts strictly ahead of the tied pair
    at_kth = above == k - 1  # the pair straddles the cut: one place for two experts
    assert int(at_kth.sum()) >= 4  # ties at the k-th place do occur
    cap = moe._capacity(B * S, k, jcfg.num_experts, jcfg.capacity_factor)
    # the dispatch, from the same probabilities in both packages
    jx2 = jnp.asarray(tx.float().numpy(), jnp.bfloat16).reshape(B * S, -1)
    _, jmeta = jmoe._group_dispatch(jx2, jnp.asarray(probs.numpy()), k, cap)
    _, tmeta = moe._group_dispatch(tx.reshape(1, B * S, -1), probs[None], k, cap)
    j_chosen, _, _ = _jax_experts(jmeta, B * S, cap)
    t_chosen, _, _ = _port_experts(tmeta)
    assert t_chosen == j_chosen
    for i in torch.nonzero(at_kth)[:, 0].tolist():
        assert 3 in t_chosen[i] and 5 not in t_chosen[i], (i, t_chosen[i])
    # and the whole FFN
    jy, _ = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        ty, _ = moe.moe_ffn(tp, tx, tcfg)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_overflow_drops_as_the_reference(dtype):
    jcfg, tcfg = _cfgs(dtype, mode="cuda")
    jp, tp = _ffn_params(jcfg, dtype)
    router = np.array(jp["router"])
    router[:, 0] = 0.5  # x > 0 below: expert 0 wins for every token
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    B, S, d, k = 2, 32, jcfg.d_model, jcfg.experts_per_token
    x = np.abs(np.random.default_rng(3).standard_normal((B, S, d))).astype(np.float32)
    jx, tx = jnp.asarray(x, JD[dtype]), torch.from_numpy(x).to(TD[dtype])
    cap = moe._capacity(B * S, k, jcfg.num_experts, jcfg.capacity_factor)
    probs = torch.softmax(torch.matmul(tx, tp["router"].to(tx.dtype)).float(), -1)
    _, jmeta = jmoe._group_dispatch(jx.reshape(B * S, d), jnp.asarray(probs.reshape(B * S, -1)
                                                                      .numpy()), k, cap)
    _, tmeta = moe._group_dispatch(tx.reshape(1, B * S, d), probs.reshape(1, B * S, -1), k, cap)
    j_chosen, j_dropped, j_counts = _jax_experts(jmeta, B * S, cap)
    t_chosen, t_dropped, t_counts = _port_experts(tmeta)
    assert t_chosen == j_chosen
    np.testing.assert_array_equal(t_counts, np.asarray(j_counts))
    assert int(t_counts[0]) == B * S > cap
    assert t_dropped == j_dropped and len(t_dropped) == B * S - cap
    jy, jaux = jmoe.moe_ffn(jp, jx, jcfg)
    with torch.no_grad():
        ty, taux = moe.moe_ffn(tp, tx, tcfg)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux["moe_balance"]), float(jaux["moe_balance"]),
                               atol=1e-6, rtol=1e-6)


def test_bf16_combine_is_the_reference_scatter_add_bitwise():
    jcfg, _ = _cfgs("bfloat16")
    E, k, d, N = jcfg.num_experts, jcfg.experts_per_token, jcfg.d_model, 48
    rng = np.random.default_rng(4)
    probs = torch.softmax(torch.from_numpy(rng.standard_normal((N, E)).astype(np.float32)), -1)
    x = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32)).bfloat16()
    cap = 8  # some assignments drop
    _, jmeta = jmoe._group_dispatch(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                    jnp.asarray(probs.numpy()), k, cap)
    _, tmeta = moe._group_dispatch(x[None], probs[None], k, cap)
    assert not bool(tmeta[1].all())
    out = rng.standard_normal((E, cap, d)).astype(np.float32) * 3
    jy = jmoe._group_combine(jnp.asarray(out, jnp.bfloat16), jmeta, N)
    ty = moe._group_combine(torch.from_numpy(out).bfloat16(), tmeta)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))


def _model(mode="off"):
    jcfg, tcfg = _cfgs(mode=mode)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jcfg, tcfg, jparams, params_from_numpy(as_np, tcfg, device="cpu")


def _batch(cfg, B=2, S=24, seed=5):
    toks = np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_forward_aux_matches_reference():
    jcfg, tcfg, jparams, tparams = _model()
    toks = _batch(jcfg)["tokens"]
    _, jaux, _ = jlm.forward_hidden(jparams, jcfg, jnp.asarray(toks))
    with torch.no_grad():
        _, taux, _ = lm.forward_hidden(tparams, tcfg, torch.from_numpy(toks))
        _, caux, _ = lm.forward_hidden(tparams, tcfg, torch.from_numpy(toks), collect_cache=True)
    for k in ("moe_balance", "moe_zloss"):
        assert float(jaux[k]) > 0
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), atol=1e-6, rtol=1e-6)
        assert float(caux[k]) == float(taux[k])


def test_lm_loss_and_grads_match_reference_off():
    jcfg, tcfg, jparams, tparams = _model("off")
    batch = _batch(jcfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves, treedef = tree_flatten(tparams)
    loss, metrics = lm.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["moe_balance"].detach()), float(jm["moe_balance"]),
                               atol=1e-6, rtol=1e-6)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=2e-4, rtol=2e-4)


def test_kernel_path_refuses_autograd():
    """The kernel path no longer refuses autograd: under ``"cuda"`` (the
    grouped matmul's plain version on the CPU, its backward the
    ``GroupedMatmul`` Function's) y, the aux and every gradient equal the
    ``"off"`` path's within 1e-6, and no kernel launch is counted; without
    autograd y keeps its shape."""
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel

    jcfg, tcfg = _cfgs(mode="cuda")
    ocfg = dataclasses.replace(tcfg, use_kernels="off")
    _, tp = _ffn_params(jcfg, "float32")
    leaves = tree_flatten(tp)[0]
    for leaf in leaves:
        leaf.requires_grad_(True)
    _, tx = _x(1, 4, tcfg.d_model, "float32")
    tx.requires_grad_(True)
    before = (gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES)
    got = []
    for cfg in (tcfg, ocfg):
        y, aux = moe.moe_ffn(tp, tx, cfg)
        loss = (y * y).sum() + aux["moe_balance"] + aux["moe_zloss"]
        got.append((y.detach(), torch.autograd.grad(loss, [tx] + leaves)))
    assert (gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES) == before
    np.testing.assert_allclose(got[0][0].numpy(), got[1][0].numpy(), atol=1e-6, rtol=1e-6)
    for g, o in zip(got[0][1], got[1][1]):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        y, _ = moe.moe_ffn(tp, tx, tcfg)
    assert y.shape == tx.shape
