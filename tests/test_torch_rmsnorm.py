"""The port's RMSNorm module against the JAX package.

The same numpy-seeded rows and scale go through the port's ``rmsnorm`` (its
plain version, what the wrapper runs for CPU tensors) and the JAX Pallas
kernel in interpret mode, at the shapes of ``tests/test_kernels.py``: within
1e-5 in float32 and 2e-2 in bfloat16 (the reference's own tolerances).  The
backward of the autograd ``Function`` (the closed-form gradient) is held to
``jax.grad`` of ``repro.model.layers.rms_norm`` in float32 within 1e-5.  The
CUDA kernel runs only on the card (``chip_smoke.py`` holds it to this plain
version there); here its wrapper's refusals are exercised, and its launch
plan (``kernel.norm_plan``, a pure function of the shape) is held to hold
every column of a row exactly once.
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


PLAN_SHAPES = [
    # (R, d, dtype): the serving and training paths' norms, deepseek-moe-16b's
    # d 2048, a width off the vector (the scalar instantiation), a row wider
    # than eight warps' registers, few rows, one element
    (16384, 768, torch.bfloat16), (16384, 1536, torch.bfloat16), (16384, 576, torch.bfloat16),
    (16384, 2048, torch.bfloat16), (8, 768, torch.bfloat16), (8, 1536, torch.bfloat16),
    (8, 576, torch.bfloat16), (8, 2048, torch.bfloat16), (16384, 768, torch.float32),
    (16384, 1536, torch.float32), (16384, 771, torch.bfloat16), (8, 771, torch.bfloat16),
    (3, 100000, torch.float32), (300, 64, torch.float32), (1, 1, torch.bfloat16),
    (8, 40000, torch.bfloat16), (8, 100000, torch.float32),  # chip_smoke.py's rows in passes
]


@pytest.mark.parametrize("R,d,dtype", PLAN_SHAPES)
def test_norm_plan_holds_every_column_of_a_row_once(R, d, dtype):
    plan = kernel.norm_plan(R, d, dtype)
    wpr, vpl, vec = plan.warps_per_row, plan.vecs_per_lane, plan.vec
    assert wpr in kernel.WARPS_PER_ROW and wpr * plan.rows_per_block <= kernel.BLOCK_WARPS
    assert vpl in kernel.VPLS
    width = 16 // (torch.finfo(dtype).bits // 8)
    assert vec == (width if d % width == 0 else 1)
    lanes = 32 * wpr
    span = lanes * vpl * vec
    cols = np.array([p * span + (v * lanes + lt) * vec + j for p in range(plan.passes)
                     for v in range(vpl) for lt in range(lanes) for j in range(vec)])
    assert np.array_equal(np.sort(cols[cols < d]), np.arange(d))  # each column once
    assert (plan.passes - 1) * span < d  # no pass wholly past the row
    assert plan.blocks(R) * plan.rows_per_block >= R
    if R < kernel.FEW_ROWS:  # decode: a block a row, each row spread over its warps
        assert plan.rows_per_block == 1 and plan.blocks(R) == R
        assert vpl * vec * 32 * (wpr // 2) < d or wpr == 1
    else:
        assert vpl <= kernel.HELD[vec > 1] or wpr == kernel.WARPS_PER_ROW[-1]


def test_norm_plan_takes_the_scalar_instantiation_off_the_vector():
    assert kernel.norm_plan(16384, 768, torch.bfloat16, aligned=False).vec == 1
    assert kernel.norm_plan(16384, 768, torch.bfloat16).vec == 8
    assert kernel.norm_plan(16384, 770, torch.float32).vec == 1
    assert kernel.norm_plan(8, 1536, torch.bfloat16).warps_per_row == 8
