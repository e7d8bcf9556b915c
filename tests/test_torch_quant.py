"""The port's int8 quantizer against the JAX package.

The same numpy-seeded rows go through the port's ``quantize_int8`` (its plain
version, what the wrapper runs for CPU tensors) and the reference's
``quantize_int8_ref``: bitwise in the codes and in the scales, in float32 and
bfloat16, at the shapes of ``tests/test_kernels.py`` and of the compression
path, with rows of NaN, +-inf, zeros, -0.0 and exact half-way ties.

The Pallas kernel in interpret mode runs under ``jax.jit``, where XLA turns
``max(amax, 1e-12) / 127`` into a multiply by the reciprocal: its scale is
one ulp off the reference's IEEE division in a few rows in a hundred.  It is
held to the port bitwise in every row whose scale is the same, within one
ulp in the others, and to the reference's own oracle (more than 99.9% of the
codes equal) overall.  The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it to this plain version there, bitwise); here its
wrapper's refusals are exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant.ops import quantize_int8 as jquantize_pallas
from repro.kernels.quant.ref import dequantize_int8_ref as jdequantize
from repro.kernels.quant.ref import quantize_int8_ref as jquantize
from repro_torch.kernels.quant import dequantize_int8, kernel, quantize_int8
from repro_torch.kernels.quant.ref import quantize_int8_ref

SHAPES = [(64, 1024), (3, 50, 128), (1, 576), (1, 4097), (17280, 192)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TIES = np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5], np.float32)  # scale 1.0


def rows_with_specials(shape, seed=0) -> np.ndarray:
    """Seeded normal rows; with six rows or more, the first six hold a NaN,
    +inf, -inf, all zeros, all -0.0 and half-way ties."""
    x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
    x2 = x.reshape(-1, shape[-1])
    if x2.shape[0] >= 6:
        x2[0, shape[-1] // 2] = np.nan
        x2[1, 3 % shape[-1]] = np.inf
        x2[2, 7 % shape[-1]] = -np.inf
        x2[3] = 0.0
        x2[4] = -0.0
        x2[5] = np.resize(TIES, shape[-1])
    return x


def both(x: np.ndarray, dtype: str):
    """The same values as a torch and a JAX array of ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_matches_reference_bitwise(shape, dtype):
    t, j = both(rows_with_specials(shape), dtype)
    q, s = quantize_int8(t)
    qr, sr = jquantize(j)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape and tuple(s.shape) == shape[:-1] + (1,)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr), equal_nan=True)
    if len(shape) == 2 and shape[0] >= 6:  # what the special rows became
        assert not q[:5].any()  # NaN, +-inf, zeros, -0.0: all codes 0
        assert torch.isnan(s[0]).all() and torch.isinf(s[1:3]).all()
        assert (s[3:5] == np.float32(1e-12) / np.float32(127)).all()
        assert q[5, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]  # half to even


@pytest.mark.parametrize("values", [[np.nan, 1.0, -2.0], [np.inf, 3.0, 0.0],
                                    [-0.0, -0.0, -0.0], [0.5, -1.5, 127.0]])
def test_single_row_specials_match_reference(values):
    x = np.array([values], np.float32)
    q, s = quantize_int8(torch.from_numpy(x))
    qr, sr = jquantize(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(s.numpy(), np.asarray(sr), equal_nan=True)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_against_pallas_interpret(shape, dtype):
    t, j = both(rows_with_specials(shape, seed=1), dtype)
    q, s = (a.numpy().reshape(-1, a.shape[-1]) for a in quantize_int8(t))
    qk, sk = (np.asarray(a).reshape(-1, a.shape[-1]) for a in jquantize_pallas(j, interpret=True))
    same = (s == sk) | (np.isnan(s) & np.isnan(sk))
    assert np.array_equal(np.isnan(s), np.isnan(sk))
    fin = np.isfinite(s).ravel()
    ulps = np.abs(s.view(np.int32)[fin].astype(np.int64) - sk.view(np.int32)[fin])
    assert ulps.max(initial=0) <= 1  # amax * (1/127) against amax / 127
    assert np.array_equal(q[same.ravel()], qk[same.ravel()])  # bitwise where scales agree
    assert (q == qk).mean() > 0.999  # the reference's own oracle


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_matches_reference_bitwise(dtype):
    x = rows_with_specials((64, 1024), seed=2)
    x[0, 512] = 1.0  # finite rows only: a NaN row dequantizes to NaN on both sides
    t, j = both(x, "float32")
    q, s = quantize_int8(t)
    tdt, jdt = DTYPES[dtype]
    got = dequantize_int8(q, s, tdt)
    want = jdequantize(*jquantize(j), jdt)
    assert got.dtype == tdt
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32), equal_nan=True)
    assert dequantize_int8(q, s).dtype == torch.float32


def test_wrapper_runs_the_plain_version_on_cpu():
    t = torch.from_numpy(rows_with_specials((32, 96), seed=3))
    before = kernel.LAUNCHES
    q, s = quantize_int8(t)
    qr, sr = quantize_int8_ref(t)
    assert torch.equal(q, qr) and torch.equal(s.nan_to_num(), sr.nan_to_num())
    assert kernel.LAUNCHES == before  # the plain version launches nothing


def test_kernel_wrapper_refusals():
    x = torch.zeros(8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        kernel.quantize_int8_cuda(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.quantize_int8_cuda(torch.zeros(64, 8).t())
    with pytest.raises(ValueError, match=r"\(R, d\)"):
        kernel.quantize_int8_cuda(torch.zeros(8))
    with pytest.raises(ValueError, match=r"\(R, d\)"):
        kernel.quantize_int8_cuda(torch.zeros(8, 0))
