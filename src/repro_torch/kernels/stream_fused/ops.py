"""Public surface of the fused-stream kernel: the op-program representation,
the backend dispatcher, and the (opt-in) algebraic folder.

A ``StreamProgram`` is the fusion pass's codegen target: a register file of
``(N,)`` token wires, a static op list, and the registers holding each fused
output port.  ``fused_stream`` runs one on CUDA tensors through the
hand-written CUDA kernel (``kernel.py``, ``csrc/stream_fused.cu``) and on CPU
tensors through the plain PyTorch version (``ref.py``) — both compute the
identical op sequence in the identical float32 order.

``StreamOp``, ``StreamProgram``, ``block_unit`` and ``fold`` are copies of
``repro/kernels/stream_fused/ops.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels.stream_fused.ref import fused_stream_ref

OP_KINDS = (
    "affine", "clip", "matmul8", "axpy", "const", "min2", "max2", "perm"
)


@dataclass(frozen=True)
class StreamOp:
    kind: str                 # one of OP_KINDS
    ins: Tuple[int, ...]      # value registers read
    out: int                  # value register written
    params: Tuple = ()        # static floats / arrays (matmul8 basis, perm idx)

    def __str__(self) -> str:
        ps = ", ".join(
            f"A{list(p.shape)}" if hasattr(p, "shape") else f"{p:g}"
            for p in self.params
        )
        return f"r{self.out} = {self.kind}({ps})({', '.join(f'r{i}' for i in self.ins)})"


@dataclass(frozen=True)
class StreamProgram:
    n_inputs: int
    n_regs: int
    ops: Tuple[StreamOp, ...]
    outputs: Tuple[int, ...]  # registers of the fused output ports, in order

    def __str__(self) -> str:
        body = "; ".join(str(op) for op in self.ops) or "passthrough"
        outs = ", ".join(f"r{i}" for i in self.outputs)
        return f"stream({self.n_inputs} in, {self.n_regs} regs): {body} -> {outs}"


def block_unit(program: StreamProgram) -> int:
    """Token granule a tile (or a megastep chunk) must be a multiple of so
    no block transform — ``matmul8``'s 8-blocks, ``perm``'s P-blocks — ever
    straddles an edge.  The Pallas kernel sizes its grid tiles with this,
    and the device runtime uses it to gate the *flat* megastep: a
    ``(k, block)`` chunk stack may flatten into one ``k*block``-token launch
    only when ``block % block_unit == 0``, which keeps every chunk's block
    transforms whole and therefore bit-identical to k separate launches."""
    import math

    units = [8]
    for op in program.ops:
        if op.kind == "perm":
            units.append(len(op.params[0]))
    return math.lcm(*units)


def fused_stream(
    inputs: Sequence[torch.Tensor],  # per-port (N,) or (B, N) float32 wires
    program: StreamProgram,
    *,
    use: str = "auto",  # "auto" | "cuda" | "ref"
) -> List[torch.Tensor]:
    """Run one fused region over a token block.

    ``auto`` launches the CUDA kernel for CUDA tensors and runs the plain
    version for CPU tensors; ``cuda`` always takes the kernel (which raises
    on CPU tensors); ``ref`` always takes the plain version.

    Inputs with a leading batch axis — ``(B, N)``: one row per server
    session, or one row per megastep chunk — run as ONE kernel launch, with
    each row bit-identical to the row run alone.
    """
    if use not in ("auto", "cuda", "ref"):
        raise ValueError(f"fused_stream: unknown use={use!r}")
    if use == "ref" or (
        use == "auto" and all(x.device.type == "cpu" for x in inputs)
    ):
        return fused_stream_ref(inputs, program)
    from repro_torch.kernels.stream_fused.kernel import fused_stream_cuda

    return fused_stream_cuda(inputs, program)


# ---------------------------------------------------------------------------
# Algebraic folding (opt_level=2) — NOT bit-preserving, therefore opt-in.
# ---------------------------------------------------------------------------


def _use_counts(program: StreamProgram) -> List[int]:
    uses = [0] * program.n_regs
    for op in program.ops:
        for i in op.ins:
            uses[i] += 1
    for i in program.outputs:
        uses[i] += 1
    return uses


def fold(program: StreamProgram) -> StreamProgram:
    """Collapse affine∘affine chains and same-x axpy ladders.

    ``affine(p2,m2,q2)∘affine(p1,m1,q1)`` becomes one affine; a ladder of
    ``a += c_i * x`` over the same ``x`` becomes ``a += (Σ c_i) * x``.  The
    result is algebraically equal but rounds differently in float32 — the
    pipeline only applies it at ``opt_level=2``, and the golden tests compare
    it with ``allclose`` rather than bitwise.
    """
    ops = list(program.ops)
    changed = True
    while changed:
        changed = False
        uses = _use_counts(
            StreamProgram(program.n_inputs, program.n_regs, tuple(ops),
                          program.outputs)
        )
        produced = {op.out: k for k, op in enumerate(ops)}
        for k, op in enumerate(ops):
            if op.kind == "affine" and op.ins[0] in produced:
                j = produced[op.ins[0]]
                prev = ops[j]
                if (
                    prev.kind == "affine"
                    and uses[prev.out] == 1
                    and prev.out not in program.outputs
                ):
                    p1, m1, q1 = prev.params
                    p2, m2, q2 = op.params
                    # ((x+p1)*m1+q1 + p2)*m2 + q2
                    ops[k] = StreamOp(
                        "affine", prev.ins, op.out,
                        (p1, m1 * m2, (q1 + p2) * m2 + q2),
                    )
                    del ops[j]
                    changed = True
                    break
            if op.kind == "axpy" and op.ins[1] in produced:
                j = produced[op.ins[1]]
                prev = ops[j]
                if (
                    prev.kind == "axpy"
                    and prev.ins[0] == op.ins[0]  # same x wire
                    and uses[prev.out] == 1
                    and prev.out not in program.outputs
                ):
                    (c1,) = prev.params
                    (c2,) = op.params
                    ops[k] = StreamOp(
                        "axpy", (op.ins[0], prev.ins[1]), op.out, (c1 + c2,)
                    )
                    del ops[j]
                    changed = True
                    break
            if op.kind == "axpy" and op.ins[1] in produced:
                j = produced[op.ins[1]]
                prev = ops[j]
                if (
                    prev.kind == "const"
                    and prev.params == (0.0,)
                    and uses[prev.out] == 1
                    and prev.out not in program.outputs
                ):
                    (c,) = op.params
                    # a = 0 + c*x  ->  affine mul
                    ops[k] = StreamOp(
                        "affine", (op.ins[0],), op.out, (0.0, c, 0.0)
                    )
                    del ops[j]
                    changed = True
                    break
    return StreamProgram(
        program.n_inputs, program.n_regs, tuple(ops), program.outputs
    )
