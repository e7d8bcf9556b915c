"""Plain PyTorch version of the fused SDF stream region.

Evaluates a ``StreamProgram`` (see ``ops.py``) over a register file of
``(N,)`` token tensors.  It is the twin of ``repro/kernels/stream_fused/
ref.py`` and the oracle the CUDA kernel (``kernel.py``) is held to, bit for
bit, on the card.  Each op mirrors the expression the corresponding
*unfused* actor's ``vector_fire`` computes:

  affine   (x + pre) * mul + post      identity components skipped exactly
  clip     torch.clamp(x, lo, hi)      NaN propagates
  matmul8  8-blocks times an 8x8 basis, summed in one fixed order (below)
  axpy     a + c * x                   one MAC tap, never fused into an FMA
  const    torch.full_like             rate seed (e.g. FIR acc = 0)
  min2/max2  torch.minimum / torch.maximum, NaN propagates
  perm     x.reshape(-1, P)[:, idx]    block reorder, a gather

``matmul8`` is written as ``y_j = x_0*B[0,j] + x_1*B[1,j] + ... + x_7*B[7,j]``,
left to right in IEEE float32, with no matrix product: the CUDA kernel, this
version and the unfused ``Idct.vector_fire`` (``apps/streams.py``) all use
that order, so fused == unfused holds bitwise within the port.  (The JAX
reference's ``x @ B`` may sum in another order, so the two packages agree on
``matmul8`` only within float32 rounding.)

``fused_stream_np`` is the *host* twin, copied as it is from the reference:
the same op list evaluated with numpy in float64 behind the fused host
regions (``runtime/host_fused.py``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_CONSTS: Dict[Tuple, torch.Tensor] = {}


def device_const(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A program constant (matmul8 basis, perm index) as a tensor on
    ``device``, uploaded once per (value, device) rather than per call."""
    arr = np.ascontiguousarray(arr)
    key = (arr.tobytes(), arr.dtype.str, arr.shape, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(device)
        _CONSTS[key] = t
    return t


def matmul8(x: torch.Tensor, basis) -> torch.Tensor:
    """The 8-point block transform in the one fixed summation order shared
    by the CUDA kernel, this module and ``Idct.vector_fire``."""
    b = device_const(np.asarray(basis, np.float32), x.device)
    blocks = x.reshape(-1, 8)
    y = blocks[:, 0:1] * b[0]
    for i in range(1, 8):
        y = y + blocks[:, i:i + 1] * b[i]
    return y.reshape(x.shape)


def apply_op(kind: str, params, ins: Sequence[torch.Tensor]) -> torch.Tensor:
    if kind == "affine":
        pre, mul, post = params
        x = ins[0]
        if pre != 0.0:
            x = x + pre
        if mul != 1.0:
            x = x * mul
        if post != 0.0:
            x = x + post
        return x
    if kind == "clip":
        lo, hi = params
        return torch.clamp(ins[0], lo, hi)
    if kind == "matmul8":
        (basis,) = params
        return matmul8(ins[0], basis)
    if kind == "axpy":
        (c,) = params
        x, a = ins
        return a + c * x
    if kind == "const":
        (v,) = params
        return torch.full_like(ins[0], v)
    if kind == "min2":
        return torch.minimum(ins[0], ins[1])
    if kind == "max2":
        return torch.maximum(ins[0], ins[1])
    if kind == "perm":
        (idx,) = params
        x = ins[0]
        # P-blocks never straddle a row when N % P == 0, so the op is
        # polymorphic over a leading batch axis
        i = device_const(np.asarray(idx, np.int64), x.device)
        return x.reshape(-1, len(idx))[:, i].reshape(x.shape)
    raise ValueError(f"unknown stream op {kind!r}")


def fused_stream_ref(
    inputs: Sequence[torch.Tensor], program
) -> List[torch.Tensor]:
    """Evaluate ``program`` over per-port input tensors; returns output
    tensors in the program's declared output order.

    Inputs may be ``(N,)`` wires or ``(B, N)`` batched wires (one row per
    megastep chunk — the ``(k, block)`` stacks the flat megastep feeds
    through): every op is elementwise over the token axis except the block
    transforms, which never straddle a row when ``N % block_unit == 0``, so
    each row of the batched result is bit-identical to the row run alone.
    """
    regs: List[torch.Tensor] = [None] * program.n_regs
    for i, x in enumerate(inputs):
        regs[i] = x
    for op in program.ops:
        regs[op.out] = apply_op(op.kind, op.params, [regs[i] for i in op.ins])
    return [regs[i] for i in program.outputs]


# ---------------------------------------------------------------------------
# Host (numpy / float64) evaluator — the fused-host-region backend
# ---------------------------------------------------------------------------


def apply_op_np(kind: str, params, ins: Sequence[np.ndarray]) -> np.ndarray:
    """One stream op over numpy wires, mirroring — bit-for-bit — the
    arithmetic the member's *scalar* fire function performs on the same
    tokens.  Wires keep the stream's own dtype: Python-float tokens
    evaluate in float64 (Python floats are IEEE doubles), device-fed
    ``np.float32`` tokens in float32 — exactly the NEP-50 promotion the
    scalar path's ``np.float32 scalar ⊕ python float`` expressions follow.

    Unlike ``apply_op``, the affine identity components are NOT skipped: the
    interpreted path always evaluates the full ``(v + pre) * mul + post``
    expression, and skipping ``+ 0.0`` would preserve a ``-0.0`` the scalar
    path normalizes.
    """
    if kind == "affine":
        pre, mul, post = params
        return (ins[0] + pre) * mul + post
    if kind == "clip":
        lo, hi = params
        return np.clip(ins[0], lo, hi)
    if kind == "matmul8":
        (basis,) = params
        x = ins[0]
        # the interpreted actor casts each 8-block to float32, matmuls, and
        # re-boxes as Python floats — the identical float32 round trip
        y = x.astype(np.float32).reshape(-1, 8) @ np.asarray(basis, np.float32)
        return y.astype(np.float64).reshape(x.shape)
    if kind == "axpy":
        (c,) = params
        x, a = ins
        return a + c * x
    if kind == "const":
        (v,) = params
        return np.full_like(ins[0], v)
    if kind == "min2":
        return np.minimum(ins[0], ins[1])
    if kind == "max2":
        return np.maximum(ins[0], ins[1])
    if kind == "perm":
        (idx,) = params
        x = ins[0]
        return x.reshape(-1, len(idx))[:, np.asarray(idx)].reshape(x.shape)
    raise ValueError(f"unknown stream op {kind!r}")


def fused_stream_np(
    inputs: Sequence[np.ndarray], program
) -> List[np.ndarray]:
    """Evaluate ``program`` over numpy wires on the host — the block
    executor behind fused static-rate *software* regions (see
    ``repro.runtime.host_fused``).  Wires keep each input stream's inferred
    dtype (Python floats -> float64, device-retired tokens -> float32), so
    promotion mirrors the scalar interpreter's.  No masks: host regions are
    static-rate by construction, so every staged token is valid."""
    regs: List[np.ndarray] = [None] * program.n_regs
    for i, x in enumerate(inputs):
        arr = np.asarray(x)
        if arr.dtype.kind not in "fiu":  # mixed/object tokens: box as double
            arr = arr.astype(np.float64)
        regs[i] = arr
    for op in program.ops:
        regs[op.out] = apply_op_np(
            op.kind, op.params, [regs[i] for i in op.ins]
        )
    return [regs[i] for i in program.outputs]
