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

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
them to the plain version bitwise there).  Here the generator is checked
before the card sees it: its plan (op order, matmul8's lane order, perm's
staging tables) run by a plain executor is held bitwise to the plain
version, with NaN, +-0 and +-inf seeded, and to the JAX reference; the
emitted source has one statement per op and every parameter as its float32
bit pattern; the launch shape; and the wrapper's input checks.
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
# The generator: its plan run by a plain executor, and the source it emits
# ---------------------------------------------------------------------------


def _f32(bits) -> np.float32:
    return np.uint32(bits).view(np.float32)


@np.errstate(invalid="ignore", over="ignore")
def _ieee_min(a, b, lo: bool):
    """torch.minimum / maximum on the card: NaN from either side wins (a's
    first), -0 < +0 on a tie of signed zeros."""
    pick = np.minimum(a, b) if lo else np.maximum(a, b)
    tie = np.where(np.signbit(a) == lo, a, b)
    out = np.where(a == b, tie, pick)
    return np.where(np.isnan(b), b, np.where(np.isnan(a), a, out)).astype(np.float32)


@np.errstate(invalid="ignore", over="ignore")
def _execute(pl, xs):
    """What the generated kernel computes, step by step in the plan's order:
    each local a float32 wire, padded with zeros to whole staging scopes as
    the kernel's last block computes on zeros; matmul8 in the lanes' order
    (each lane's 4 outputs from its own 4 tokens and its partner's, the
    coefficients picked by its parity, 8 terms left to right); perm as the
    gather the plan's table gives over each staging scope."""
    shape, n = xs[0].shape, xs[0].size
    span = max(pl.span, 8)
    pad = -n % span
    env = {f"x{i}": np.concatenate([x.reshape(-1), np.zeros(pad, np.float32)])
           for i, x in enumerate(xs)}
    for s in pl.steps:
        a = [env[i] for i in s.ins]
        if s.kind == "affine":
            v = a[0]
            for part, b in zip(s.parts, s.bits):
                v = v + _f32(b) if part == "add" else v * _f32(b)
        elif s.kind == "clip":
            lo, hi = _f32(s.bits[0]), _f32(s.bits[1])
            v = np.where(np.isnan(a[0]), a[0], np.minimum(np.maximum(a[0], lo), hi))
        elif s.kind == "axpy":
            v = a[1] + _f32(s.bits[0]) * a[0]
        elif s.kind == "const":
            v = np.full_like(a[0], _f32(s.bits[0]))
        elif s.kind in ("min2", "max2"):
            v = _ieee_min(a[0], a[1], s.kind == "min2")
        elif s.kind == "matmul8":
            B = np.asarray(s.bits, np.uint32).view(np.float32).reshape(8, 8)
            lanes = a[0].reshape(-1, 2, 4)
            v = np.empty_like(lanes)
            for odd in (0, 1):
                own, partner = lanes[:, odd], lanes[:, 1 - odd]
                blk = np.concatenate([partner, own] if odd else [own, partner], axis=1)
                coef = B[:, 4 * odd:4 * odd + 4]
                y = blk[:, 0:1] * coef[0]
                for i in range(1, 8):
                    y = y + blk[:, i:i + 1] * coef[i]
                v[:, odd] = y
            v = v.reshape(-1)
        else:  # perm
            v = a[0].reshape(-1, pl.span)[:, list(s.table)].reshape(-1)
        env[s.out] = v.astype(np.float32)
    return [env[o][:n].reshape(shape) for o in pl.outputs]


def _same_bits(got, want):
    """Bitwise at every non-NaN position, NaN at the same ones (a NaN made
    by arithmetic has the platform's own bits, as on the card)."""
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == np.float32
        assert np.array_equal(np.isnan(g), np.isnan(w))
        ok = ~np.isnan(w)
        np.testing.assert_array_equal(g.view(np.uint32)[ok], w.view(np.uint32)[ok])


def _seeded(prog, shape, seed=1):
    xs = _inputs(prog, shape, seed)
    for x in xs:
        x.reshape(-1)[:6] = [np.nan, 0.0, -0.0, np.inf, -np.inf, -0.0]
        x.reshape(-1)[-3:] = [0.0, -0.0, np.nan]
    return xs


@pytest.mark.parametrize("name", ["demo", *NETS])
def test_plan_executor_matches_ref_bitwise(name):
    """(3, 64) wires: 192 tokens, one whole warp scope and half of the next."""
    jp, tp = _programs(name)
    xs = _seeded(tp, (3, 64))
    got = _execute(kernel.plan(tp), xs)
    want = [t.numpy() for t in fused_stream_ref([torch.from_numpy(x) for x in xs], tp)]
    _same_bits(got, want)
    if not _has(tp, {"min2", "max2"}):  # jnp's NaN payload and ties are its own
        _check(got, jref([jnp.asarray(x) for x in xs], jp), _has(tp, {"matmul8"}))


def _literal_program():
    """Constants a decimal literal would not keep: -0.0, NaN, a float32
    subnormal, a float32 rounding of a double; affine parts that are
    identities (skipped) and one that is not; and a perm whose P (24) does not
    divide a warp's 128 tokens, so its staging scope is the block's."""
    idx = np.random.default_rng(3).permutation(24)
    ops = (
        StreamOp("const", (0,), 1, (-0.0,)),
        StreamOp("const", (0,), 2, (float("nan"),)),
        StreamOp("affine", (0,), 3, (0.0, 1e-40, 0.0)),
        StreamOp("axpy", (3, 1), 4, (0.1,)),
        StreamOp("max2", (4, 1), 5),
        StreamOp("min2", (2, 5), 6),
        StreamOp("affine", (0,), 7, (-0.0, 1.0, 0.0)),
        StreamOp("perm", (5,), 8, (idx,)),
        StreamOp("matmul8", (8,), 9, (np.eye(8, dtype=np.float32)[::-1].copy(),)),
    )
    return StreamProgram(n_inputs=1, n_regs=10, ops=ops, outputs=(1, 6, 7, 9))


def test_emitted_literals_are_exact_bit_patterns_and_block_scope_perm():
    prog = _literal_program()
    pl = kernel.plan(prog)
    assert pl.block_scope and pl.span == 384 and pl.threads == 96 and pl.unit == 24
    src = kernel.emit(pl)
    for bits in (0x80000000, 0x7FC00000, int(np.float32(1e-40).view(np.uint32)),
                 int(np.float32(0.1).view(np.uint32))):
        assert f"f32(0x{bits:08x}u)" in src
    assert "const W v6 = x0;" in src  # an affine of identity parts only
    assert "perm<true>(" in src and "psrc0[96]" in src
    xs = _seeded(prog, (2, 24 * 20))  # 960 tokens: two and a half block scopes
    got = _execute(pl, xs)
    want = [t.numpy() for t in fused_stream_ref([torch.from_numpy(x) for x in xs], prog)]
    _same_bits(got, want)
    assert (got[0].view(np.uint32) == 0x80000000).all()  # const -0.0, kept
    assert (got[0].view(np.uint32) == want[0].view(np.uint32)).all()


@pytest.mark.parametrize("name", ["demo", *NETS])
def test_emitted_source_has_one_statement_per_op(name):
    _, tp = _programs(name)
    pl = kernel.plan(tp)
    src = kernel.emit(pl)
    body = [ln.strip() for ln in src.splitlines() if ln.strip().startswith("const W v")]
    assert len(body) == len(tp.ops) == len(pl.steps)
    for k, (line, step, op) in enumerate(zip(body, pl.steps, tp.ops, strict=True)):
        assert line.startswith(f"const W v{k} = ") and line.endswith(f"// {op.kind}")
        for b in step.bits:  # every parameter as its bit pattern, in the op's statement
            assert f"f32(0x{b:08x}u)" in line
        for name_in in step.ins if step.kind != "const" else ():  # const: shape only
            assert name_in in line
    assert len(pl.outputs) == len(tp.outputs)
    assert src.count("out[") == len(tp.outputs)
    assert ("perm<false>" in src) == (name == "ZigZag")  # P = 64 stages a warp's tokens
    assert kernel.emit(kernel.plan(_programs(name)[1])) == src  # a pure function


def test_launch_shape_fills_the_card_and_keeps_loads_in_flight():
    _, tp = _programs("FIR32")
    pl = kernel.plan(tp)
    assert pl.k_big == 4
    k, threads, blocks = kernel.launch_shape(pl, 16384, 132)
    assert (k, threads, blocks) == (1, 32, 128)  # every token a thread, a block an SM
    k, threads, blocks = kernel.launch_shape(pl, 1 << 22, 132)
    assert (k, threads) == (4, 256) and blocks * threads * 4 * k == 1 << 22
    assert kernel.launch_shape(pl, 1 << 22, 132, aligned=False)[0] == 1
    assert kernel.launch_shape(pl, 16384, 64)[2] >= 64
    _, bt = _programs("Bitonic8")
    assert kernel.plan(bt).k_big == 1  # 8 input wires: 32 floats a thread already
    lit = kernel.plan(_literal_program())
    assert kernel.launch_shape(lit, 960, 132)[1:] == (96, 3)


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
