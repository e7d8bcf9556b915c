"""Training through the kernel path (``use_kernels="cuda"``) against the JAX
package, on the CPU, where each kernel's wrapper runs its plain version.

* ``lm_loss`` and every gradient leaf on the reduced mamba2-130m (the
  ``SSDScan`` Function), deepseek-moe-16b (the ``GroupedMatmul`` Function),
  jamba-v0.1-52b (both) and qwen3-moe-235b-a22b, in float32, against
  ``jax.value_and_grad`` of the reference's ``lm_loss`` (flash in interpret
  mode): the loss within 1e-5, every gradient within 2e-4, the tolerances of
  ``tests/test_torch_lm.py``.
* ``torch.autograd.gradcheck`` in float64 of both Functions at tiny shapes.
* ``ref.ssd_scan_bwd_ref``, the SSD backward kernels' stages in plain
  PyTorch, in float64 against the vjp of ``ssd_chunked`` (the final state's
  cotangent given and ``None``; P and N off 8; da > 0 in some chunks; a long
  chunk, finite in float32 too); ``SSDScan``'s backward on CPU tensors is that
  vjp, bit for bit, and launches nothing; ``kernel.ssd_bwd_plan``.
* ``remat="save_dispatch"``: gradients bitwise equal to ``remat="block"``'s
  in the port, and within 2e-4 of the reference's ``save_dispatch``.
* The LM head (``lm.head_logits``): on CPU tensors it is the float32 cast
  path, bit for bit; the backward of its CUDA Function (``lm._head_bwd``)
  equals autograd of that cast path bit for bit.
* ``REPRO_BF16_DOTS=1`` at its two sites, ``dense`` and the decode's QK
  scores, against the reference with the variable set.
* AdamW's slice-wise update equals the whole-leaf update bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.model import lm as jlm
from repro.model.attention import attention as jattention
from repro.model.layers import dense as jdense
from repro_torch.configs import get_config
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm.ops import GroupedMatmul
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref
from repro_torch.model import lm
from repro_torch.model.attention import attention
from repro_torch.model.convert import params_from_numpy
from repro_torch.model.layers import dense
from repro_torch.model.ssm import SSDScan, ssd_chunked
from repro_torch.optim import OptConfig, adamw, adamw_update, init_opt_state
from repro_torch.pytree import tree_paths

TRAINED = ["mamba2-130m", "deepseek-moe-16b", "jamba-v0.1-52b", "qwen3-moe-235b-a22b"]
MOE = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), dtype="float32",
                               param_dtype="float32", use_pallas="interpret", **kw)
    tcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               param_dtype="float32", use_kernels="cuda", **kw)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    as_np = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    return jparams, params_from_numpy(as_np, tcfg, device="cpu")


def _batch(cfg, B=2, S=32, seed=7):
    toks = np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, :2] = -1  # masked positions
    return {"tokens": toks[:, :-1], "labels": labels}


def _jflat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(tparams, tcfg, batch):
    keys = [k for k, _ in tree_paths(tparams)]
    loss, _ = lm.lm_loss(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [v for _, v in tree_paths(tparams)])
    return float(loss.detach()), dict(zip(keys, grads))


def _ref_grads(jparams, jcfg, batch):
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b), has_aux=True
    ))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jloss), _jflat(jgrads)


def _hold(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(loss, jloss, atol=1e-5, rtol=1e-5)
    assert sorted(grads) == sorted(jgrads)
    for key, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=2e-4, rtol=2e-4, err_msg=key)


@pytest.mark.parametrize("arch", TRAINED)
def test_kernel_path_loss_and_grads_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    batch = _batch(jcfg)
    ssd0, gmm0, dx0 = ssd_kernel.LAUNCHES, gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES
    loss, grads = _port_grads(tparams, tcfg, batch)
    # the CPU runs the plain versions: nothing is launched
    assert (ssd_kernel.LAUNCHES, gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES) == (ssd0, gmm0, dx0)
    _hold(loss, grads, *_ref_grads(jparams, jcfg, batch))


@pytest.mark.parametrize("arch", MOE)
def test_save_dispatch_matches_block_bitwise_and_reference(arch):
    jcfg, tcfg = _cfgs(arch, remat="save_dispatch")
    jparams, tparams = _params(jcfg, tcfg)
    batch = _batch(jcfg, seed=11)
    loss, grads = _port_grads(tparams, tcfg, batch)
    loss_b, grads_b = _port_grads(tparams, dataclasses.replace(tcfg, remat="block"), batch)
    assert loss == loss_b
    for key, g in grads.items():
        assert torch.equal(g, grads_b[key]), key
    _hold(loss, grads, *_ref_grads(jparams, jcfg, batch))


def test_ssd_function_gradcheck():
    rng = np.random.default_rng(3)
    B, S, nh, P, N, chunk = 1, 8, 2, 3, 4, 4

    def t(*shape, lo=None, hi=None):
        a = rng.uniform(lo, hi, shape) if lo is not None else rng.standard_normal(shape)
        return torch.from_numpy(a).double().requires_grad_(True)

    x, dt, A = t(B, S, nh, P), t(B, S, nh, lo=0.05, hi=0.5), t(nh, lo=-2.0, hi=-0.5)
    B_, C_ = t(B, S, N), t(B, S, N)
    assert torch.autograd.gradcheck(lambda *a: SSDScan.apply(*a, chunk), (x, dt, A, B_, C_))
    # with the final state's cotangent left out (None) as the mixer leaves it
    assert torch.autograd.gradcheck(lambda *a: SSDScan.apply(*a, chunk)[0], (x, dt, A, B_, C_))
    # and the backward is the vjp of ssd_chunked's
    y, st = SSDScan.apply(x, dt, A, B_, C_, chunk)
    y2, st2 = ssd_chunked(x, dt, A, B_, C_, chunk)
    gy, gs = torch.randn_like(y), torch.randn_like(st)
    g1 = torch.autograd.grad((y, st), (x, dt, A, B_, C_), (gy, gs))
    g2 = torch.autograd.grad((y2, st2), (x, dt, A, B_, C_), (gy, gs))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=1e-12)


def test_ssd_chunked_grads_stay_finite_over_a_long_chunk():
    """Segment sums above the diagonal that overflow ``exp`` (da of -2 over
    256 positions) give finite gradients: the decay is selected away before
    the exponential, not only after it."""
    rng = np.random.default_rng(5)
    B, S, nh, P, N = 1, 256, 2, 4, 8
    x = torch.from_numpy(rng.standard_normal((B, S, nh, P)).astype(np.float32)).requires_grad_()
    dt = torch.full((B, S, nh), 0.5, requires_grad=True)
    A = torch.tensor([-4.0, -0.1], requires_grad=True)
    B_, C_ = (torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
              .requires_grad_() for _ in range(2))
    y, _ = SSDScan.apply(x, dt, A, B_, C_, 256)
    grads = torch.autograd.grad(y.square().sum(), (x, dt, A, B_, C_))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# (B, S, nh, P, N, chunk, rising): every second head's A > 0 makes da > 0
SSD_BWD_CASES = {
    "small": (2, 16, 3, 5, 6, 4, False),
    "ragged": (1, 24, 2, 3, 5, 8, False),      # P, N not multiples of 8
    "rising": (2, 32, 4, 8, 8, 8, True),
    "long_chunk": (1, 256, 2, 4, 8, 256, False),
}


def _ssd_bwd_inputs(case, dtype, seed=21):
    B, S, nh, P, N, chunk, rising = SSD_BWD_CASES[case]
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(dtype)

    x, Bm, Cm = t(B, S, nh, P), t(B, S, N), t(B, S, N)
    if case == "long_chunk":  # the finite-gradient test's: segment sums overflow exp above it
        dt, A = torch.full((B, S, nh), 0.5, dtype=dtype), torch.tensor([-4.0, -0.1], dtype=dtype)
    else:
        dt = torch.from_numpy(rng.uniform(0.05, 0.5, (B, S, nh))).to(dtype)
        A = torch.from_numpy(rng.uniform(-2.0, -0.5, nh)).to(dtype)
        if rising:
            A[1::2] = 0.3
    gy, gs = t(B, S, nh, P), t(B, nh, P, N)
    return (x, dt, A, Bm, Cm), chunk, gy, gs


def _fold_bwd_ref(ins, chunk, gy, gs):
    """ssd_scan_bwd_ref in the kernel's layout, its cotangents in the model's."""
    x, dt, A, Bm, Cm = ins
    B, S, nh, P = x.shape
    dx, ddt, dA, dB, dC = ssd_scan_bwd_ref(
        x.transpose(1, 2).reshape(B * nh, S, P), dt.transpose(1, 2).reshape(B * nh, S), A, Bm,
        Cm, gy.transpose(1, 2).reshape(B * nh, S, P),
        None if gs is None else gs.reshape(B * nh, P, -1), nheads=nh, chunk=chunk)
    return (dx.reshape(B, nh, S, P).transpose(1, 2), ddt.reshape(B, nh, S).transpose(1, 2), dA,
            dB, dC)


@pytest.mark.parametrize("with_state", [True, False], ids=["dstate", "no_dstate"])
@pytest.mark.parametrize("case", list(SSD_BWD_CASES))
def test_ssd_bwd_ref_is_the_vjp_of_ssd_chunked(case, with_state):
    ins, chunk, gy, gs = _ssd_bwd_inputs(case, torch.float64)
    gs = gs if with_state else None
    ins = [t.requires_grad_() for t in ins]
    y, st = ssd_chunked(*ins, chunk)
    outs, cots = ((y, st), (gy, gs)) if with_state else ((y,), (gy,))
    want = torch.autograd.grad(outs, ins, cots)
    got = _fold_bwd_ref([t.detach() for t in ins], chunk, gy, gs)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10, msg=name)


def test_ssd_bwd_ref_stays_finite_over_a_long_chunk_in_float32():
    ins, chunk, gy, gs = _ssd_bwd_inputs("long_chunk", torch.float32)
    got = _fold_bwd_ref(ins, chunk, gy, gs)
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_ssd_backward_on_cpu_tensors_is_the_plain_vjp_bit_for_bit():
    """bf16 CPU tensors keep the vjp of ssd_chunked; no kernel launches."""
    ins, chunk, gy, _ = _ssd_bwd_inputs("small", torch.float32)
    x, dt, A, Bm, Cm = ins  # dt and A stay float32, as the mixer gives them
    ins = [x.to(torch.bfloat16), dt, A, Bm.to(torch.bfloat16), Cm.to(torch.bfloat16)]
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    launches = ssd_kernel.BWD_LAUNCHES
    y, _ = SSDScan.apply(*a, chunk)
    got = torch.autograd.grad(y, a, gy.to(y.dtype))
    y2, _ = ssd_chunked(*b, chunk)
    want = torch.autograd.grad(y2, b, gy.to(y2.dtype))
    assert ssd_kernel.BWD_LAUNCHES == launches
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # and the kernels' wrapper refuses CPU tensors
    x = ins[0]
    B, S, nh, _ = x.shape
    dtf = ins[1].transpose(1, 2).reshape(B * nh, S).contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_scan_bwd_cuda(x, dtf, dtf, ins[2], ins[3], ins[4], x, None, chunk=chunk)


def test_ssd_bwd_plan_launches_five_kernels_of_their_own():
    plan = ssd_kernel.ssd_bwd_plan(24 * 24, 2048, 64, 128, 24, 256)
    assert [st.kernel for st in plan.stages] == [
        "ssd_bwd_chunk_state_kernel", "ssd_bwd_state_pass_kernel", "ssd_bwd_keys_kernel",
        "ssd_bwd_queries_kernel", "ssd_bwd_dda_kernel"]
    # the forward's names are counted as forward calls by name substring
    assert not any(f in st.kernel for st in plan.stages
                   for f in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out"))
    assert [st.grid for st in plan.stages] == [(576 * 8, 2, 1), (576, 4, 1), (24 * 8, 4, 1),
                                              (24 * 8, 4, 1), (576 * 8, 1, 1)]
    assert max(st.smem for st in plan.stages) <= ssd_kernel.SMEM_LIMIT
    assert plan.head_group == 24 and plan.tma
    assert not ssd_kernel.ssd_bwd_plan(2 * 3, 192, 33, 20, 3, 96).tma  # P, N off 8
    assert ssd_kernel.ssd_bwd_plan(6, 192, 40, 24, 3, 64).stages[2].grid == (2 * 3, 1, 1)


def test_grouped_matmul_function_gradcheck():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 4))).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((3, 4, 6))).requires_grad_(True)
    before = (gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES)
    assert torch.autograd.gradcheck(GroupedMatmul.apply, (x, w))
    assert (gmm_kernel.LAUNCHES, gmm_kernel.DX_LAUNCHES) == before
    # float32: dx and dw against autograd of the batched matmul
    xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    got = torch.autograd.grad(GroupedMatmul.apply(xf, wf), (xf, wf), g)
    want = torch.autograd.grad(torch.matmul(xf, wf), (xf, wf), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gmm_kernel.grouped_matmul_cuda(xf.detach(), wf.detach(), dx=True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_cpu_path_is_the_cast_path(dtype):
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32)).to(dtype)
    h.requires_grad_(True)
    w.requires_grad_(True)
    for mode in ("cuda", "off"):
        got = lm.head_logits(h, w, mode)
        want = torch.matmul(h.float(), w.float())
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert "HeadF32" not in type(got.grad_fn).__name__
    g = torch.from_numpy(rng.standard_normal((12, 40)).astype(np.float32))
    want = torch.autograd.grad(torch.matmul(h.reshape(12, 16).float(), w.float()), (h, w), g)
    got = lm._head_bwd(h.detach().reshape(12, 16), w.detach(), g)
    assert torch.equal(got[0].reshape(h.shape), want[0]) and got[0].dtype == dtype
    assert torch.equal(got[1], want[1]) and got[1].dtype == dtype


@pytest.mark.parametrize("wdtype", ["bfloat16", "float32"])
def test_bf16_dots_dense_matches_reference(monkeypatch, wdtype):
    monkeypatch.setenv("REPRO_BF16_DOTS", "1")
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, getattr(jnp, wdtype))
    want = np.asarray(jdense(jx, jw).astype(jnp.float32))
    got = dense(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).to(getattr(torch, wdtype)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bf16_dots_decode_scores_match_reference(monkeypatch):
    """One bf16 decode step of attention: under either setting of the
    switch the port equals the reference bit for bit, and the port without
    the switch differs from the reference with it, so the comparison tells
    the QK scores' bf16 rounding apart."""
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), dtype="bfloat16",
                               param_dtype="bfloat16", use_pallas="off")
    tcfg = dataclasses.replace(get_config("smollm-135m").reduced(), dtype="bfloat16",
                               param_dtype="bfloat16", use_kernels="off")
    jparams, tparams = _params(jcfg, tcfg)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["pos0"])["mixer"]
    tp = {k: v[0].detach().bfloat16() for k, v in tparams["layers"]["pos0"]["mixer"].items()}
    rng = np.random.default_rng(10)
    B, S, kv, hd = 2, 16, tcfg.num_kv_heads, tcfg.head_dim
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32) * 4
    ck, cv = (rng.standard_normal((B, S, kv, hd)).astype(np.float32) * 4 for _ in range(2))
    pos = 9

    def run():
        want, _ = jattention(jp, jnp.asarray(x, jnp.bfloat16), jcfg, jnp.full((1,), pos),
                             cache=(jnp.asarray(ck, jnp.bfloat16), jnp.asarray(cv, jnp.bfloat16)),
                             write_pos=jnp.int32(pos))
        with torch.no_grad():
            got, _ = attention(tp, torch.from_numpy(x).bfloat16(), tcfg,
                               torch.full((1,), pos),
                               cache=(torch.from_numpy(ck).bfloat16(),
                                      torch.from_numpy(cv).bfloat16()),
                               write_pos=pos)
        return got.float().numpy(), np.asarray(want.astype(jnp.float32))

    got0, want0 = run()
    monkeypatch.setenv("REPRO_BF16_DOTS", "1")
    got1, want1 = run()
    np.testing.assert_array_equal(got0, want0)
    np.testing.assert_array_equal(got1, want1)
    assert not np.array_equal(got0, want1)


def test_adamw_slices_equal_the_whole_leaf(monkeypatch):
    rng = np.random.default_rng(12)
    params = {"a": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).bfloat16(),
              "b": torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(np.float32))}
    grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)).to(v.dtype)
             for k, v in params.items()}
    opt = OptConfig(lr=1e-2, warmup_steps=1, total_steps=5, keep_master=True)
    state = init_opt_state(params, opt)
    whole = adamw_update(params, grads, state, opt)
    monkeypatch.setattr(adamw, "SLICE", 5)
    sliced = adamw_update(params, grads, state, opt)
    for a, b in ((whole[0], sliced[0]), (whole[1]["m"], sliced[1]["m"]),
                 (whole[1]["v"], sliced[1]["v"]), (whole[1]["master"], sliced[1]["master"])):
        for k in params:
            assert torch.equal(a[k], b[k]), k
