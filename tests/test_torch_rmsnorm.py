"""The port's RMSNorm module against the JAX package.

The same numpy-seeded rows and scale go through the port's ``rmsnorm`` (its
plain version, what the wrapper runs for CPU tensors) and the JAX Pallas
kernel in interpret mode, at the shapes of ``tests/test_kernels.py``: within
1e-5 in float32 and 2e-2 in bfloat16 (the reference's own tolerances).  The
backward of the autograd ``Function`` (the closed-form gradient) is held to
``jax.grad`` of ``repro.model.layers.rms_norm`` in float32 within 1e-5.  The
CUDA kernel runs only on the card (``chip_smoke.py`` holds it to this plain
version there); here its wrapper's refusals are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ops import rmsnorm as jrmsnorm
from repro.model.layers import rms_norm as jrms_norm
from repro_torch.kernels.rmsnorm import kernel, ref, rmsnorm
from repro_torch.model.layers import rms_norm


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    return x, s


@pytest.mark.parametrize(
    "shape,dtype",
    [((512, 768), "float32"), ((4, 100, 256), "bfloat16"), ((8, 64), "float32")],
)
def test_forward_matches_pallas_interpret(shape, dtype):
    x, s = _inputs(shape)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jrmsnorm(jnp.asarray(x, jd), jnp.asarray(s), interpret=True)
    got = rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(s))
    assert got.dtype == td and tuple(got.shape) == shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("shape", [(4, 33, 96), (16, 768)])
def test_backward_matches_jax_grad(shape):
    x, s = _inputs(shape, seed=1)
    dy = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jdx, jds = jax.grad(
        lambda a, b: jnp.sum(jrms_norm(a, b, 1e-6) * dy), argnums=(0, 1)
    )(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(s).requires_grad_(True)
    dx, ds = torch.autograd.grad(rmsnorm(tx, ts, 1e-6), (tx, ts), torch.from_numpy(dy))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-5, rtol=1e-5)


def test_kernel_mode_of_rms_norm_is_the_plain_function_on_cpu():
    x, s = _inputs((3, 7, 64), seed=3)
    tx, ts = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(s)
    before = kernel.LAUNCHES
    got = rms_norm(tx, ts, 1e-6, "cuda")
    assert torch.equal(got, rms_norm(tx, ts, 1e-6, "off"))
    assert torch.equal(got, ref.rmsnorm_ref(tx, ts, 1e-6))
    assert kernel.LAUNCHES == before  # the plain version launches nothing
    with pytest.raises(ValueError, match="kernels="):
        rms_norm(tx, ts, 1e-6, "pallas")
    with pytest.raises(TypeError, match="kernels"):  # the mode cannot be left out
        rms_norm(tx, ts, 1e-6)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, s = _inputs((8, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.rmsnorm_cuda(torch.from_numpy(x), torch.from_numpy(s))
