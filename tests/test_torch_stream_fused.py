"""The port's fused-stream kernel module against the JAX package.

The same numpy-seeded wires go through the port's plain version
(``repro_torch...ref.fused_stream_ref``), the JAX reference
``fused_stream_ref`` and the JAX Pallas kernel in interpret mode, for the
demo program and the fused program each package's lowering produces for
FIR32, Bitonic8, IDCT8 and ZigZag.  Tolerances against the JAX reference:
bitwise for programs without ``matmul8``; ``rtol=atol=1e-6`` with it (the
reference's own bound, ``tests/test_fusion.py``), because XLA's dot may sum
the 8 terms in another order than the port's fixed left-to-right sum.
Against the Pallas kernel in interpret mode the same bound holds for every
program with float arithmetic (``affine``, ``axpy``, ``matmul8``): XLA
compiles the interpreted kernel body as one fused loop and contracts
``a + c*x`` into an FMA, so it is not bitwise even to the JAX reference;
compare-only programs (Bitonic8, ZigZag) stay bitwise.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it to
the plain version bitwise there); here its bytecode lowering is run through a
numpy emulation of the kernel's interpreter, and its wrapper's input checks
are exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.apps.streams import NETWORKS as JNETS
from repro.kernels.stream_fused import StreamOp as JStreamOp
from repro.kernels.stream_fused import StreamProgram as JStreamProgram
from repro.kernels.stream_fused import fused_stream as jfused_stream
from repro.kernels.stream_fused.ref import fused_stream_ref as jref
from repro_torch.apps.streams import NETWORKS as TNETS
from repro_torch.apps.streams import CompareExchange
from repro_torch.kernels.stream_fused import (
    StreamOp,
    StreamProgram,
    block_unit,
    fused_stream,
    kernel,
)
from repro_torch.kernels.stream_fused.ref import fused_stream_ref

NETS = ["FIR32", "Bitonic8", "IDCT8", "ZigZag"]
SHAPES = {"N": (128,), "BN": (2, 128), "k_block": (4, 64)}


def _demo(mod_op, mod_prog):
    basis = np.linalg.qr(np.random.default_rng(0).normal(size=(8, 8)))[0]
    ops = (
        mod_op("affine", (0,), 2, (-1.5, 0.25, 3.0)),
        mod_op("matmul8", (2,), 3, (basis.astype(np.float32),)),
        mod_op("const", (1,), 4, (0.0,)),
        mod_op("axpy", (3, 4), 5, (0.7,)),
        mod_op("min2", (5, 1), 6),
        mod_op("max2", (5, 1), 7),
        mod_op("clip", (7,), 8, (-2.0, 2.0)),
    )
    return mod_prog(n_inputs=2, n_regs=9, ops=ops, outputs=(6, 8))


def _build(nets, name):
    return nets[name](n=64) if name == "FIR32" else nets[name](8)


def _lowered(pkg, nets, name, **kw):
    net, _ = _build(nets, name)
    prog = pkg.compile(net, backend="device", block=64, **kw)
    (fused,) = [a for a in prog.module.actors.values() if a.is_fused]
    return fused.impl.stream_program


def _programs(name):
    if name == "demo":
        return _demo(JStreamOp, JStreamProgram), _demo(StreamOp, StreamProgram)
    return (
        _lowered(repro, JNETS, name),
        _lowered(repro_torch, TNETS, name, device="cpu"),
    )


def _has(prog, kinds) -> bool:
    return any(op.kind in kinds for op in prog.ops)


def _inputs(prog, shape, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(prog.n_inputs)]


def _check(got, want, tolerant):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        if tolerant:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("name", ["demo", *NETS])
def test_lowering_yields_same_program(name):
    jp, tp = _programs(name)
    assert str(tp) == str(jp)
    assert (tp.n_inputs, tp.n_regs, tp.outputs) == (jp.n_inputs, jp.n_regs, jp.outputs)
    for a, b in zip(tp.ops, jp.ops, strict=True):
        assert (a.kind, a.ins, a.out) == (b.kind, b.ins, b.out)
        for pa, pb in zip(a.params, b.params, strict=True):
            if hasattr(pb, "shape"):
                assert np.array_equal(pa, pb) and pa.dtype == pb.dtype
            else:
                assert pa == pb
    assert block_unit(tp) == (64 if name == "ZigZag" else 8)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", ["demo", *NETS])
def test_ref_matches_jax_ref_and_pallas(name, shape):
    jp, tp = _programs(name)
    xs = _inputs(tp, SHAPES[shape])
    ours = [t.numpy() for t in fused_stream_ref([torch.from_numpy(x) for x in xs], tp)]
    jins = [jnp.asarray(x) for x in xs]
    _check(ours, jref(jins, jp), _has(tp, {"matmul8"}))
    _check(
        ours, jfused_stream(jins, jp, use="pallas"),
        _has(tp, {"matmul8", "axpy", "affine"}),
    )


# ---------------------------------------------------------------------------
# The kernel's bytecode, run through a numpy emulation of its interpreter
# ---------------------------------------------------------------------------


def _emulate(code, xs):
    """What ``stream_fused_kernel`` computes, one tile covering all tokens
    (tiles are independent: each is a whole number of block units).
    Elementwise ops read every position before writing it, as each thread
    does for its own positions; cross-token ops read everything before
    writing, as the barriers around them enforce."""
    sm = np.zeros((code.n_slots, xs[0].size), np.float32)
    for s, x in zip(code.in_slots, xs):
        sm[s] = x.reshape(-1)
    for kind, a, b, o, off, aux in code.ops.tolist():
        x, y, p = sm[a], sm[b], code.params[off:]
        sm[o] = _emulate_op(kind, x, y, p, code.perm_idx[off:off + aux], aux)
    return [sm[s].reshape(xs[0].shape).copy() for s in code.out_slots]


@np.errstate(invalid="ignore")
def _emulate_op(kind, x, y, p, idx, aux):
    if kind == 0:  # affine
        v = x.copy()
        if aux & 1:
            v = v + p[0]
        if aux & 2:
            v = v * p[1]
        if aux & 4:
            v = v + p[2]
    elif kind == 1:  # clip
        v = np.where(np.isnan(x), x, np.minimum(np.maximum(x, p[0]), p[1]))
    elif kind == 2:  # matmul8, fixed left-to-right order
        blk = x.reshape(-1, 8)
        v = blk[:, 0:1] * p[0:8]
        for i in range(1, 8):
            v = v + blk[:, i:i + 1] * p[8 * i:8 * i + 8]
        v = v.reshape(-1)
    elif kind == 3:  # axpy: y + c*x
        v = y + p[0] * x
    elif kind == 4:
        v = np.full_like(x, p[0])
    elif kind == 5:
        v = np.minimum(x, y)
    elif kind == 6:
        v = np.maximum(x, y)
    elif kind == 7:
        v = x.reshape(-1, aux)[:, idx].reshape(-1)
    return v.astype(np.float32)


@pytest.mark.parametrize("name", ["demo", *NETS])
def test_bytecode_emulation_matches_ref_bitwise(name):
    _, tp = _programs(name)
    code = kernel.lower(tp)
    xs = _inputs(tp, (4, 64))
    xs[0][0, :4] = [np.nan, 0.0, -0.0, np.inf]
    want = [t.numpy() for t in fused_stream_ref([torch.from_numpy(x) for x in xs], tp)]
    got = _emulate(code, xs)
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(g.view(np.int32)[ok], w.view(np.int32)[ok])


@pytest.mark.parametrize("name", ["demo", *NETS])
def test_bytecode_slots_by_liveness(name):
    _, tp = _programs(name)
    code = kernel.lower(tp)
    # cross-token ops never write one of their own input slots
    for kind, a, _b, o, _off, _aux in code.ops.tolist():
        if kind in (2, 7):
            assert o != a
    assert code.tile % block_unit(tp) == 0
    assert code.n_slots * code.tile * 4 <= kernel.MAX_SMEM
    bound = {"demo": 4, "FIR32": 4, "Bitonic8": 16, "IDCT8": 2, "ZigZag": 2}[name]
    assert code.n_slots <= bound < tp.n_regs


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    _, tp = _programs("IDCT8")
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.fused_stream_cuda([torch.zeros(64, 2)[:, 0]], tp)
    with pytest.raises(ValueError, match="float32"):
        kernel.fused_stream_cuda([x.double()], tp)
    with pytest.raises(ValueError, match="multiple of the program's block unit"):
        kernel.fused_stream_cuda([torch.zeros(60)], tp)
    with pytest.raises(ValueError, match="inputs for a program"):
        kernel.fused_stream_cuda([x, x], tp)
    before = kernel.LAUNCHES
    # a well-formed CPU wire is still not a CUDA wire: the wrapper raises,
    # it never falls back to the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel.fused_stream_cuda([x], tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_stream([x], tp, use="cuda")
    assert kernel.LAUNCHES == before
    # auto on CPU tensors takes the plain version
    (out,) = fused_stream([x], tp)
    assert out.shape == (64,)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


TIE_A = np.array([0.0, -0.0, 0.0, -0.0, 1.5, np.nan, -2.0], np.float32)
TIE_B = np.array([-0.0, 0.0, 0.0, -0.0, np.nan, 1.5, -2.0], np.float32)


@pytest.mark.parametrize("path", ["min2_max2", "bitonic_vector_fire"])
def test_signed_zero_ties_match_jnp(path):
    """IEEE minimum/maximum on +-0 ties, bit for bit with jnp.minimum /
    jnp.maximum on the CPU (the CUDA kernel computes the same on the card);
    NaN still propagates."""
    a, b = torch.from_numpy(TIE_A.copy()), torch.from_numpy(TIE_B.copy())
    if path == "min2_max2":
        prog = StreamProgram(
            2, 4, (StreamOp("min2", (0, 1), 2), StreamOp("max2", (0, 1), 3)), (2, 3)
        )
        lo, hi = fused_stream_ref([a, b], prog)
    else:
        ce = CompareExchange(ascending=True)
        _, outs = ce.vector_fire(None, {"IN0": (a, None), "IN1": (b, None)})
        lo, hi = outs["OUT0"][0], outs["OUT1"][0]
    want_lo, want_hi = jnp.minimum(TIE_A, TIE_B), jnp.maximum(TIE_A, TIE_B)
    nan = np.isnan(np.asarray(want_lo))
    assert np.array_equal(np.isnan(lo.numpy()), nan)
    assert np.array_equal(np.isnan(hi.numpy()), nan)
    assert np.array_equal(_bits(lo)[~nan], _bits(want_lo)[~nan])
    assert np.array_equal(_bits(hi)[~nan], _bits(want_hi)[~nan])
