"""The three-stage math of the port's bfloat16 SSD kernels, against the JAX
package, before the card sees it.

* ``ref.ssd_staged_ref`` (chunk states, state passing, chunk outputs) without
  rounding equals the port's ``ssd_scan_ref`` within 1e-5, and is held to
  the JAX Pallas kernel in interpret mode and to the JAX ``ssd_ref`` within
  2e-3 (the reference's tolerance), at ``tests/test_kernels.py``'s shapes.
* With the kernels' rounding points, at a bf16 shape, it stays within the
  card's tolerance of the JAX kernel, and the final state's error uses under
  half of its 2e-3 (the card's path holds 8x more states) and under a tenth
  of what a state update whose scaled operand is rounded wholly to bf16 uses
  (nearly half at this shape): the bf16 pair keeps the state update's
  operand to about 16 bits.
* Where da > 0 (every second head of ``chip_smoke.py``'s ``SSD_RISING``
  shape, the state and y growing with a_cs), the kernels take W and the
  entering state as bf16 pairs: the rounded stages stay within the y
  tolerance of the JAX kernel and of the JAX ``ssd_ref``, where W and H
  rounded wholly to bf16 (the control) exceed it.
* ``kernel.ssd_plan``, whose grids are the ones the kernels are launched
  with: every stage's grid covers each (row, head, chunk) exactly once,
  every block fits the card's shared memory, and the head group follows the
  card's SM count.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan_fwd as jssd_scan_fwd
from repro.kernels.ssd_scan.ref import ssd_ref as jssd_ref
from repro_torch.kernels.ssd_scan import kernel, ref
from repro_torch.kernels.ssd_scan.ref import rising_pairs, ssd_scan_ref, ssd_staged_ref

SHAPES = [(2, 256, 4, 32, 16, 64), (1, 128, 2, 64, 128, 32), (2, 64, 3, 16, 8, 64)]
BF16_SHAPE = (1, 1024, 8, 64, 128, 256)
SSD_TOL = (2e-2, 2e-3)  # chip_smoke.py SSD_TOL[bfloat16]: (y, state)
SMS = 132  # an H100's SMs


def _inputs(B, S, nh, P, N, seed=0):
    """Folded (BH, S, P) x, (BH, S) dt and da = dt * A, (B, S, N) B and C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, nh, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, nh)))) * 0.1).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    B_ = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    xf = np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * nh, S, P))
    dtf = np.ascontiguousarray(dt.transpose(0, 2, 1).reshape(B * nh, S))
    daf = dtf * np.repeat(A[None, :], B, 0).reshape(B * nh)[:, None]
    return xf, dtf, daf, B_, C_


@pytest.mark.parametrize("B,S,nh,P,N,chunk", SHAPES)
def test_staged_matches_the_scan_and_the_jax_package(B, S, nh, P, N, chunk):
    arrays = _inputs(B, S, nh, P, N)
    t = [torch.from_numpy(a) for a in arrays]
    y, st = ssd_staged_ref(*t, nheads=nh, chunk=chunk)
    y0, st0 = ssd_scan_ref(*t, nheads=nh, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(st.numpy(), st0.numpy(), atol=1e-5, rtol=1e-5)
    j = [jnp.asarray(a) for a in arrays]
    jy, jst = jssd_scan_fwd(*j, nheads=nh, chunk=chunk, interpret=True)
    ry, rst = jssd_ref(*j, nheads=nh)
    for want_y, want_s in ((jy, jst), (ry, rst)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_s), atol=2e-3, rtol=2e-3)


def _share(got: torch.Tensor, want: np.ndarray, tol: float) -> float:
    """The largest |got - want| as a share of allclose's allowance."""
    want = torch.from_numpy(np.array(want, np.float32))
    return float(((got.float() - want).abs() / (tol + tol * want.abs())).max())


def _state_scaled_wholly_bf16(x, dt, da, B_, nheads, Q):
    """The final state with stage 1's scaled operand rounded wholly to bf16
    (no lo part): the design the kernels do not take."""
    BH, S, P = x.shape
    nc, N = S // Q, B_.shape[-1]
    a_cs = torch.cumsum(da.reshape(BH, nc, Q), dim=2)
    s = torch.exp(a_cs[..., -1:] - a_cs) * dt.reshape(BH, nc, Q)
    xs = (x.float().reshape(BH, nc, Q, P) * s[..., None]).bfloat16().float()
    Bh = B_.float().repeat_interleave(nheads, dim=0).reshape(BH, nc, Q, N)
    h = torch.zeros((BH, P, N))
    for c in range(nc):
        h = h * torch.exp(a_cs[:, c, -1])[:, None, None] + xs[:, c].transpose(1, 2) @ Bh[:, c]
    return h


def test_rounded_stages_keep_the_state_within_half_its_tolerance():
    B, S, nh, P, N, chunk = BF16_SHAPE
    xf, dtf, daf, B_, C_ = _inputs(B, S, nh, P, N)
    xb = torch.from_numpy(xf).bfloat16()
    Bb, Cb = torch.from_numpy(B_).bfloat16(), torch.from_numpy(C_).bfloat16()
    dt, da = torch.from_numpy(dtf), torch.from_numpy(daf)
    y, st = ssd_staged_ref(xb, dt, da, Bb, Cb, nheads=nh, chunk=chunk, rounded=True)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    jy, jst = jssd_scan_fwd(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(dtf),
                            jnp.asarray(daf), jnp.asarray(Bb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(Cb.float().numpy(), jnp.bfloat16), nheads=nh,
                            chunk=chunk, interpret=True)
    tol_y, tol_s = SSD_TOL
    assert _share(y, np.asarray(jy, np.float32), tol_y) <= 1.0
    state_share = _share(st, np.asarray(jst), tol_s)
    assert state_share < 0.5
    control = _state_scaled_wholly_bf16(xb, dt, da, Bb, nh, chunk)
    assert state_share < _share(control, np.asarray(jst), tol_s) / 10


RISING_SHAPE = (2, 512, 4, 64, 128, 256)  # chip_smoke.py SSD_RISING


def _rising_inputs(seed):
    """``_inputs`` at ``SSD_RISING``'s shape with ``chip_smoke.py`` phase 6's
    change: every second head's A times -0.05, so its da > 0."""
    B, S, nh, P, N, _ = RISING_SHAPE
    xf, dtf, daf, B_, C_ = _inputs(B, S, nh, P, N, seed)
    odd = np.tile(np.arange(nh) % 2 == 1, B)
    daf = np.where(odd[:, None], daf * np.float32(-0.05), daf).astype(np.float32)
    return xf, dtf, daf, B_, C_


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "control_wholly_bf16"])
def test_rising_chunks_take_bf16_pairs_within_the_y_tolerance(pairs, monkeypatch):
    """The control takes no pair anywhere: W and H rounded wholly to bf16,
    as the kernels did before they took the pairs."""
    if not pairs:
        monkeypatch.setattr(ref, "rising_pairs",
                            lambda da, Q: torch.zeros((da.shape[0], da.shape[1] // Q), dtype=bool))
    B, S, nh, P, N, chunk = RISING_SHAPE
    xf, dtf, daf, B_, C_ = _rising_inputs(300)
    xb = torch.from_numpy(xf).bfloat16()
    Bb, Cb = torch.from_numpy(B_).bfloat16(), torch.from_numpy(C_).bfloat16()
    dt, da = torch.from_numpy(dtf), torch.from_numpy(daf)
    y, st = ssd_staged_ref(xb, dt, da, Bb, Cb, nheads=nh, chunk=chunk, rounded=True)
    j = (jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(dtf), jnp.asarray(daf),
         jnp.asarray(Bb.float().numpy(), jnp.bfloat16),
         jnp.asarray(Cb.float().numpy(), jnp.bfloat16))
    jy, jst = jssd_scan_fwd(*j, nheads=nh, chunk=chunk, interpret=True)
    ry, rst = jssd_ref(*j, nheads=nh)
    tol_y, tol_s = SSD_TOL
    assert float(np.abs(np.asarray(jy, np.float32)).max()) > 50  # y grows with a_cs
    shares = [_share(y, np.asarray(w, np.float32), tol_y) for w in (jy, ry)]
    if pairs:
        assert max(shares) <= 1.0
        assert max(_share(st, np.asarray(w), tol_s) for w in (jst, rst)) <= 1.0
    else:  # the control: the test would have shown the fault
        assert min(shares) > 1.0


def test_rising_pairs_start_at_the_first_chunk_with_some_da_above_zero():
    da = torch.full((3, 8), -0.1)
    da[1, 5] = 0.2  # row 1: chunk 2 of four 2-token chunks rises
    da[2, 0] = 1e-30
    got = rising_pairs(da, 2)
    assert got.tolist() == [[False] * 4, [False, False, True, True], [True] * 4]


PLAN_SHAPES = [
    # (B, S, nh, P, N, chunk): mamba2-130m's prefill, one prompt, a short
    # prompt, ragged P and N, no TMA with Q % 64 != 0, 25 heads
    (8, 2048, 24, 64, 128, 256),
    (1, 2048, 24, 64, 128, 256),
    (2, 16, 24, 64, 128, 256),
    (2, 192, 3, 40, 24, 64),
    (1, 192, 2, 33, 20, 96),
    (2, 512, 25, 64, 128, 128),
]


@pytest.mark.parametrize("B,S,nh,P,N,chunk", PLAN_SHAPES)
def test_plan_covers_every_row_head_and_chunk_once(B, S, nh, P, N, chunk):
    BH = B * nh
    plan = kernel.ssd_plan(BH, S, P, N, nh, chunk, torch.bfloat16, SMS)
    Q, chunks = plan.chunk, plan.chunks
    assert Q == min(chunk, S) and Q * chunks == S
    assert plan.tma == (P % 8 == 0 and N % 8 == 0)
    assert 1 <= plan.head_group <= kernel.MAX_GROUP
    states, passing, outputs = plan.stages
    for st in plan.stages:
        assert st.smem <= kernel.SMEM_LIMIT and st.threads <= 1024
        assert all(0 < n < 2**31 for n in st.grid) and max(st.grid[1:]) <= 65535
    assert 2 * states.smem <= kernel.SMEM_LIMIT  # two chunk-state blocks an SM

    # stage 1: block x = bh * chunks + c
    assert states.grid == (BH * chunks, 1, 1)
    # stage 2: thread (bh, four of a padded 64 x 128 state)
    assert passing.grid[0] * passing.threads >= BH * 64 * 128 // 4
    # stage 3: block (x, y, pair of 64-row query tiles), where y gx + x =
    # (b * chunks + c) gy + head group: a chunk's head groups launch together
    seen = np.zeros((B, chunks, nh, Q), dtype=np.int64)
    gx, gy, gz = outputs.grid
    assert gx == B * chunks
    for lin in range(gx * gy):
        (b, c), grp = divmod(lin // gy, chunks), lin % gy
        heads = range(grp * plan.head_group, min(nh, (grp + 1) * plan.head_group))
        for z in range(gz):
            rows = range(128 * z, min(Q, 128 * z + 128))
            for h in heads:
                seen[b, c, h, rows.start:rows.stop] += 1
    assert (seen == 1).all()
    assert outputs.threads == 384
    shapes = {name: (shape, dtype) for name, shape, dtype in plan.temporaries}
    assert shapes["acs"] == ((BH, S), torch.float32)
    assert shapes["states"] == ((BH, chunks, 64, 128), torch.float32)
    assert shapes["entering"] == ((2, BH, chunks, 64, 128), torch.bfloat16)  # hi, lo
    assert shapes["rising"] == ((2, BH, chunks), torch.int32)


def test_plan_picks_the_largest_head_group_that_fills_the_card():
    path = kernel.ssd_plan(8 * 24, 2048, 64, 128, 24, 256, torch.bfloat16, SMS)
    assert path.head_group == 8
    assert np.prod(path.stages[2].grid) == 384 >= SMS
    one = kernel.ssd_plan(24, 2048, 64, 128, 24, 256, torch.bfloat16, SMS)
    assert one.head_group == 2 and np.prod(one.stages[2].grid) >= SMS
    # a card of 64 SMs: one prompt fills it with groups of 6 heads
    fewer = kernel.ssd_plan(24, 2048, 64, 128, 24, 256, torch.bfloat16, 64)
    assert fewer.head_group == 6 and np.prod(fewer.stages[2].grid) == 64
    small = kernel.ssd_plan(6, 192, 40, 24, 3, 64, torch.bfloat16, SMS)
    assert small.head_group == 1  # too few blocks either way: the most
    # temporaries of the path: chunk states 50.3 MB, entering states' hi and
    # lo 50.3 MB (lo written only in rows where a_cs rises), a_cs 1.6 MB
    nbytes = sum(np.prod(shape) * dtype.itemsize for _, shape, dtype in path.temporaries)
    assert nbytes <= 102.25e6


def test_float32_plan_is_one_kernel_a_row():
    plan = kernel.ssd_plan(48, 512, 64, 128, 24, 256, torch.float32, SMS)
    (stage,) = plan.stages
    assert stage.grid == (48, 1, 1) and stage.smem <= kernel.SMEM_LIMIT
    assert plan.temporaries == ()
