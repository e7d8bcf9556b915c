"""The port's SSD scan and Mamba-2 mixer against the JAX package.

* The SSD scan's plain version (what ``ssd_scan`` runs for CPU tensors) and
  the JAX Pallas kernel in interpret mode, at the shapes of
  ``tests/test_kernels.py``, are each held within 2e-3 (the reference's
  tolerance) to the port's sequential oracle and to the JAX ``ssd_ref``.
* The port's plain ``ssd_chunked`` equals the JAX ``ssd_chunked`` in float32
  within 1e-5.
* ``ssm_mixer`` on ``mamba2-130m.reduced()`` in float32, weights carried
  across with ``params_from_numpy``: prefill with its returned cache and
  several decode steps, against the JAX mixer, within 1e-5 on the plain path
  (``use_kernels="off"``) and 1e-4 on the kernel path (its plain version: the
  chunked dual form in float32 where the JAX mixer runs ``ssd_chunked``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.ssd_scan.ops import ssd_scan as jssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
from repro.model import lm as jlm
from repro.model.ssm import ssd_chunked as jssd_chunked
from repro.model.ssm import ssm_mixer as jssm_mixer
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import kernel, ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref, ssd_scan_ref
from repro_torch.model.convert import params_from_numpy
from repro_torch.model.ssm import ssd_chunked, ssm_mixer

SHAPES = [(2, 256, 4, 32, 16, 64), (1, 128, 2, 64, 128, 32), (2, 64, 3, 16, 8, 64)]


def _ssd_inputs(B, S, nh, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, nh)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    B_ = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, dt, A, B_, C_


def _fold(x, dt, A, nh):
    B, S = x.shape[:2]
    xf = x.transpose(0, 2, 1, 3).reshape(B * nh, S, -1)
    dtf = dt.transpose(0, 2, 1).reshape(B * nh, S)
    return xf, dtf, dtf * np.repeat(A[None, :], B, 0).reshape(B * nh)[:, None]


@pytest.mark.parametrize("B,S,nh,P,N,chunk", SHAPES)
def test_ssd_scan_plain_and_pallas_match_oracles(B, S, nh, P, N, chunk):
    x, dt, A, B_, C_ = _ssd_inputs(B, S, nh, P, N)
    t = [torch.from_numpy(a) for a in (x, dt, A, B_, C_)]
    y, st = ssd_scan(*t, chunk=chunk)
    jy, jst = jssd_scan(*(jnp.asarray(a) for a in (x, dt, A, B_, C_)), chunk=chunk,
                        interpret=True)
    xf, dtf, daf = _fold(x, dt, A, nh)
    yr, sr = ssd_ref(*(torch.from_numpy(a) for a in (xf, dtf, daf, B_, C_)), nheads=nh)
    jyr, jsr = jssd_ref(*(jnp.asarray(a) for a in (xf, dtf, daf, B_, C_)), nheads=nh)
    yr = yr.reshape(B, nh, S, P).transpose(1, 2).numpy()
    jyr = np.asarray(jyr).reshape(B, nh, S, P).transpose(0, 2, 1, 3)
    tol = dict(atol=2e-3, rtol=2e-3)
    for got_y, got_s in ((y.numpy(), st.numpy()), (np.asarray(jy), np.asarray(jst))):
        for want_y, want_s in ((yr, sr.numpy()), (jyr, np.asarray(jsr))):
            np.testing.assert_allclose(got_y, want_y, **tol)
            np.testing.assert_allclose(got_s.reshape(B * nh, P, N), want_s, **tol)


@pytest.mark.parametrize("B,S,nh,P,N,chunk", SHAPES)
def test_ssd_chunked_matches_reference(B, S, nh, P, N, chunk):
    x, dt, A, B_, C_ = _ssd_inputs(B, S, nh, P, N, seed=1)
    y, st = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B_, C_)), chunk)
    jy, jst = jssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B_, C_)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=1e-5, rtol=1e-5)


def test_ssd_scan_ref_bf16_keeps_float32_inside():
    x, dt, A, B_, C_ = _ssd_inputs(1, 64, 2, 16, 8, seed=2)
    xf, dtf, daf = _fold(x, dt, A, 2)
    args = [torch.from_numpy(a) for a in (xf, dtf, daf, B_, C_)]
    bf = [args[0].bfloat16(), args[1], args[2], args[3].bfloat16(), args[4].bfloat16()]
    y, st = ssd_scan_ref(*bf, nheads=2, chunk=32)
    y32, _ = ssd_scan_ref(*(a.float() for a in bf), nheads=2, chunk=32)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(y, y32.bfloat16())


def _mixer_setup(mode):
    jcfg = dataclasses.replace(jget_config("mamba2-130m").reduced(), dtype="float32",
                               param_dtype="float32")
    tcfg = dataclasses.replace(get_config("mamba2-130m").reduced(), dtype="float32",
                               param_dtype="float32", use_kernels=mode)
    jparams = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                                tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["pos0"])["mixer"]
    tp = {k: v[0].detach() for k, v in tparams["layers"]["pos0"]["mixer"].items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("mode,tol", [("off", 1e-5), ("cuda", 1e-4)])
def test_ssm_mixer_prefill_and_decode_match_reference(mode, tol):
    jcfg, tcfg, jp, tp = _mixer_setup(mode)
    B, S, steps = 2, 16, 4
    x = np.random.default_rng(4).standard_normal((B, S + steps, jcfg.d_model)).astype(np.float32)
    want, jcache = jssm_mixer(jp, jnp.asarray(x[:, :S]), jcfg, return_cache=True)
    with torch.no_grad():
        got, tcache = ssm_mixer(tp, torch.from_numpy(x[:, :S]), tcfg, return_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol)
    for key in ("state", "conv_x", "conv_b", "conv_c"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=tol, rtol=tol, err_msg=key)
    for i in range(S, S + steps):
        want, jcache = jssm_mixer(jp, jnp.asarray(x[:, i:i + 1]), jcfg, cache=jcache)
        with torch.no_grad():
            got, tcache = ssm_mixer(tp, torch.from_numpy(x[:, i:i + 1]), tcfg, cache=tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=tol,
                                   err_msg=f"decode step {i}")
        np.testing.assert_allclose(tcache["state"].numpy(), np.asarray(jcache["state"]),
                                   atol=tol, rtol=tol)


def test_kernel_path_refuses_autograd_and_never_falls_back():
    """The kernel path trains (``SSDScan``: the scan's plain version on the
    CPU, the vjp of ``ssd_chunked`` behind it): the mixer's output and its
    gradients equal the plain path's within 1e-5; the kernel wrapper still
    refuses CPU tensors and the plain version launches nothing."""
    _, tcfg, _, tp = _mixer_setup("cuda")
    _, ocfg, _, _ = _mixer_setup("off")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 16, tcfg.d_model))
                         .astype(np.float32)).requires_grad_(True)
    leaves = [x] + [v.requires_grad_(True) for v in tp.values()]
    got = []
    for cfg in (tcfg, ocfg):
        y, _ = ssm_mixer(tp, x, cfg)
        got.append((y.detach(), torch.autograd.grad((y * y).sum(), leaves)))
    np.testing.assert_allclose(got[0][0].numpy(), got[1][0].numpy(), atol=1e-5, rtol=1e-5)
    for g, o in zip(got[0][1], got[1][1]):
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=1e-5, rtol=1e-5)
    # the kernel wrapper refuses CPU tensors, and the plain version launches nothing
    before = kernel.LAUNCHES
    x4, dt, A, B_, C_ = (torch.from_numpy(a) for a in _ssd_inputs(1, 32, 2, 16, 8))
    with torch.no_grad():
        ssd_scan(x4, dt, A, B_, C_, chunk=16)
    assert kernel.LAUNCHES == before
    xf = x4.transpose(1, 2).reshape(2, 32, 16).contiguous()
    dtf = dt.transpose(1, 2).reshape(2, 32).contiguous()
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.ssd_scan_cuda(xf, dtf, dtf, B_, C_, nheads=2, chunk=16)
