"""The port's grouped-matmul module against the JAX package.

The same numpy-seeded ``x (E, C, d)`` and ``w (E, d, f)`` go through the
port's ``grouped_matmul`` (its plain version, what the wrapper runs for CPU
tensors) and the JAX Pallas kernel in interpret mode and its reference, at
the shapes of ``tests/test_kernels.py`` and at C values that no 128 divides
(decode's 6 and 8, a tile's remainder): within 3e-4 in float32 and 3e-2 in
bfloat16, the reference's own tolerances.  The CUDA kernel runs only on the
card (``chip_smoke.py`` holds it to this plain version there); here its
wrapper's refusals are exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm.ops import grouped_matmul as jgrouped_matmul
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jgrouped_matmul_ref
from repro_torch.kernels.moe_gmm import grouped_matmul, kernel, ref

TOL = {"float32": 3e-4, "bfloat16": 3e-2}


def _inputs(E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = (rng.standard_normal((E, d, f)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize(
    "E,C,d,f,dtype,block_c",
    [
        (4, 128, 256, 128, "float32", 128),
        (8, 256, 512, 384, "float32", 128),
        (2, 128, 128, 256, "bfloat16", 128),
        (8, 6, 64, 32, "float32", 128),
        (8, 8, 64, 32, "bfloat16", 128),
        (4, 100, 256, 128, "bfloat16", 128),
        (3, 248, 64, 32, "float32", 8),
    ],
)
def test_plain_version_matches_pallas_interpret(E, C, d, f, dtype, block_c):
    x, w = _inputs(E, C, d, f)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx, jw = jnp.asarray(x, jd), jnp.asarray(w, jd)
    want = jgrouped_matmul(jx, jw, block_c=block_c, interpret=True)
    before = kernel.LAUNCHES
    got = grouped_matmul(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td))
    assert kernel.LAUNCHES == before  # the plain version launches nothing
    assert got.dtype == td and tuple(got.shape) == (E, C, f)
    tol = TOL[dtype]
    for name, other in (("interpret", want), ("ref", jgrouped_matmul_ref(jx, jw))):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(other, np.float32), atol=tol, rtol=tol,
            err_msg=name,
        )


def test_plain_version_rounds_once():
    """float32 products and sums, one rounding: equal to the float32 product
    rounded to bfloat16."""
    x, w = _inputs(2, 5, 64, 24, seed=1)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    want = torch.bmm(tx.float(), tw.float()).bfloat16()
    assert torch.equal(ref.grouped_matmul_ref(tx, tw), want)


@pytest.mark.parametrize(
    "case,match",
    [
        ("cpu", "CUDA tensors"),
        ("dtype", "both bfloat16 or both float32"),
        ("mixed_dtype", "both bfloat16 or both float32"),
        ("contiguous", "contiguous"),
        ("shape", r"\(E, C, d\)"),
        ("bf16_d", "d % 8"),
        ("bf16_f", "f % 8"),
        ("bf16_d0", "d % 8"),
        ("bf16_x_base", "16-byte boundary"),
        ("bf16_w_base", "16-byte boundary"),
        ("bf16_cpu", "CUDA tensors"),
    ],
)
def test_kernel_wrapper_input_checks_raise_without_nvcc(case, match):
    x, w = torch.zeros(4, 8, 64), torch.zeros(4, 64, 32)
    if case == "dtype":
        x, w = x.half(), w.half()
    elif case == "mixed_dtype":
        w = w.bfloat16()
    elif case == "contiguous":
        w = torch.zeros(4, 32, 64).transpose(1, 2)
    elif case == "shape":
        w = torch.zeros(4, 48, 32)
    elif case == "bf16_d":
        x, w = torch.zeros(4, 8, 44).bfloat16(), torch.zeros(4, 44, 32).bfloat16()
    elif case == "bf16_f":
        x, w = x.bfloat16(), torch.zeros(4, 64, 20).bfloat16()
    elif case == "bf16_d0":
        x, w = torch.zeros(4, 8, 0).bfloat16(), torch.zeros(4, 0, 32).bfloat16()
    elif case == "bf16_x_base":
        x, w = _off_16_bytes((4, 8, 64)), w.bfloat16()
    elif case == "bf16_w_base":
        x, w = x.bfloat16(), _off_16_bytes((4, 64, 32))
    elif case == "bf16_cpu":
        x, w = x.bfloat16(), w.bfloat16()
    with pytest.raises(ValueError, match=match):
        kernel.check_inputs(x, w)
    with pytest.raises(ValueError, match=match):
        kernel.grouped_matmul_cuda(x, w)


def _off_16_bytes(shape):
    """A contiguous bf16 tensor whose base lies 2 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)


# (d, f) of deepseek-moe-16b's gate/up and down products
PATH_DF = ((2048, 1408), (1408, 2048))


def test_tile_plan_picks_only_warpgroups_from_c():
    """C picks only the 64-row consumer warpgroups a block: 1 up to 64 rows,
    2 above.  ``chip_smoke.py`` holds rows bitwise on both sides of this
    switch (C = 64 and 65), so a move of it must move that check too."""
    plans = {C: kernel.tile_plan(C) for C in range(1, 4097)}
    assert {C for C, wgs in plans.items() if wgs == 1} == set(range(1, 65))
    assert set(plans.values()) == {1, 2}


@pytest.mark.parametrize("d,f", PATH_DF + ((1408, 1408), (2048, 2048)))
@pytest.mark.parametrize("C", [1, 6, 8, 248, 1984])
def test_check_inputs_takes_every_path_shape(C, d, f):
    """Past every check of shape, type, contiguity and alignment, a CPU
    tensor is refused for its device alone."""
    x, w = torch.zeros(64, C, d, dtype=torch.bfloat16), torch.zeros(64, d, f, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        kernel.check_inputs(x, w)
    with pytest.raises(ValueError, match="must be CUDA tensors"):
        kernel.grouped_matmul_cuda(x, w)

