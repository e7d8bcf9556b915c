"""The fused SDF stream-region kernel on the card: build, bind, lower, launch.

Replaces ``repro/kernels/stream_fused/kernel.py::fused_stream_fwd`` (the
Pallas TPU kernel).  The CUDA source is ``repro_torch/csrc/stream_fused.cu``;
its header note says what bounds it and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` with
  ``--fmad=false`` into a shared library with a plain C interface under
  ``repro_torch/build/``, loaded with ``ctypes`` (``kernels/build.py``).
* **Lower.**  Each ``StreamProgram`` object becomes a bytecode once per
  device: an int32 op table, a float32 parameter array and an int32 perm
  index array, uploaded once.  Registers are packed into shared-memory slots
  by liveness; a cross-token op (``matmul8``, ``perm``) never writes one of
  its own input slots.
* **Launch.**  ``fused_stream_cuda`` checks its inputs, allocates the
  outputs, launches on ``torch.cuda.current_stream()`` and raises on any
  launch error.  ``LAUNCHES`` counts the launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import COMMON_FLAGS, CSRC, build_library
from repro_torch.kernels.stream_fused.ops import StreamProgram, block_unit

LAUNCHES = 0
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the last build

SOURCE = CSRC / "stream_fused.cu"
NVCC_FLAGS = (*COMMON_FLAGS, "--fmad=false")

MAX_WIRES = 32  # csrc/stream_fused.cu MAX_WIRES
MAX_SMEM = 232_448  # bytes of shared memory one H100 block may use
TILE_TOKENS = 128  # tokens per block, rounded up to the block unit
OP_KINDS = {
    "affine": 0, "clip": 1, "matmul8": 2, "axpy": 3,
    "const": 4, "min2": 5, "max2": 6, "perm": 7,
}

_lock = threading.Lock()
_lib = None


def build() -> ctypes.CDLL:
    """Compile (once per process and source) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS, log = build_library(SOURCE, NVCC_FLAGS)
        BUILD_LOG = log or BUILD_LOG
        fn = lib.stream_fused_launch
        fn.restype = ctypes.c_int
        p = ctypes.c_void_p
        fn.argtypes = [
            p, ctypes.c_int, p, ctypes.c_int, p, p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, p, ctypes.c_int, p, p,
            p,
        ]
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# Lowering: StreamProgram -> bytecode
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bytecode:
    ops: np.ndarray          # (n_ops, 6) int32: kind, a, b, out, param off, aux
    params: np.ndarray       # float32
    perm_idx: np.ndarray     # int32
    in_slots: Tuple[int, ...]
    out_slots: Tuple[int, ...]
    n_slots: int
    tile: int


def lower(program: StreamProgram) -> Bytecode:
    """Lower ``program`` to the kernel's bytecode, packing registers into
    shared-memory slots by liveness."""
    n_ops = len(program.ops)
    outputs = set(program.outputs)
    last_use: Dict[int, int] = {}
    for k, op in enumerate(program.ops):
        for r in op.ins:
            last_use[r] = k
    free: List[int] = []
    n_slots = 0

    def alloc() -> int:
        nonlocal n_slots
        if free:
            return free.pop()
        n_slots += 1
        return n_slots - 1

    def dead_after(r: int, k: int) -> bool:
        return r not in outputs and last_use.get(r, -1) <= k

    slot: Dict[int, int] = {}
    for i in range(program.n_inputs):
        slot[i] = alloc()
    for i in range(program.n_inputs):  # loaded but never read
        if dead_after(i, -1):
            free.append(slot[i])

    rows, params, perm_idx = [], [], []
    for k, op in enumerate(program.ops):
        ins = [slot[r] for r in op.ins]
        dying = sorted({slot[r] for r in op.ins if dead_after(r, k)})
        cross = op.kind in ("matmul8", "perm")
        if not cross:
            # elementwise: each thread reads its inputs at a position before
            # writing that position, so the output may take a dying slot
            free.extend(dying)
        out = alloc()
        if cross:
            free.extend(dying)
        slot[op.out] = out
        off, aux = len(params), 0
        if op.kind == "affine":
            pre, mul, post = op.params
            aux = (pre != 0.0) | (mul != 1.0) << 1 | (post != 0.0) << 2
            params += [pre, mul, post]
        elif op.kind in ("clip", "axpy", "const"):
            params += list(op.params)
        elif op.kind == "matmul8":
            params += np.asarray(op.params[0], np.float32).reshape(64).tolist()
        elif op.kind == "perm":
            idx = np.asarray(op.params[0], np.int64)
            off, aux = len(perm_idx), len(idx)
            perm_idx += idx.tolist()
        elif op.kind not in OP_KINDS:
            raise ValueError(f"unknown stream op {op.kind!r}")
        a = ins[0] if ins else 0
        b = ins[1] if len(ins) > 1 else 0
        rows.append((OP_KINDS[op.kind], a, b, out, off, aux))
        if dead_after(op.out, k):  # result never read
            free.append(out)
    unit = block_unit(program)
    tile = unit * math.ceil(TILE_TOKENS / unit)
    return Bytecode(
        ops=np.asarray(rows, np.int32).reshape(n_ops, 6),
        params=np.asarray(params or [0.0], np.float32),
        perm_idx=np.asarray(perm_idx or [0], np.int32),
        in_slots=tuple(slot[i] for i in range(program.n_inputs)),
        out_slots=tuple(slot[r] for r in program.outputs),
        n_slots=max(n_slots, 1),
        tile=tile,
    )


@dataclass
class _Compiled:
    program: StreamProgram  # held so its id() is never reused while cached
    unit: int
    code: Bytecode
    ops: torch.Tensor
    params: torch.Tensor
    perm_idx: torch.Tensor
    in_slots: ctypes.Array
    out_slots: ctypes.Array
    threads: int


_compiled: Dict[Tuple[int, torch.device], _Compiled] = {}


def _compile(program: StreamProgram, device: torch.device) -> _Compiled:
    # keyed by object identity: str(program) formats every op and would
    # cost more per launch than the launch itself
    key = (id(program), device)
    c = _compiled.get(key)
    if c is None or c.program is not program:
        code = lower(program)
        smem = code.n_slots * code.tile * 4
        if smem > MAX_SMEM:
            raise ValueError(
                f"stream kernel: program needs {smem} bytes of shared memory "
                f"({code.n_slots} slots x {code.tile} tokens), above the "
                f"{MAX_SMEM} one block may use"
            )
        c = _Compiled(
            program=program,
            unit=block_unit(program),
            code=code,
            ops=torch.from_numpy(code.ops.copy()).to(device),
            params=torch.from_numpy(code.params.copy()).to(device),
            perm_idx=torch.from_numpy(code.perm_idx.copy()).to(device),
            in_slots=(ctypes.c_int * len(code.in_slots))(*code.in_slots),
            out_slots=(ctypes.c_int * len(code.out_slots))(*code.out_slots),
            threads=min(code.tile, 256),
        )
        _compiled[key] = c
    return c


def check_inputs(
    inputs: Sequence[torch.Tensor], program: StreamProgram, unit: int
) -> int:
    """Validate the wires the kernel takes; returns tokens per wire (all
    rows).  Raises ``ValueError`` on what the kernel does not take."""
    if len(inputs) != program.n_inputs:
        raise ValueError(
            f"stream kernel: {len(inputs)} inputs for a program of "
            f"{program.n_inputs}"
        )
    if not 1 <= program.n_inputs <= MAX_WIRES or not 1 <= len(program.outputs) <= MAX_WIRES:
        raise ValueError(f"stream kernel: at most {MAX_WIRES} input and output wires")
    shape = inputs[0].shape
    for x in inputs:
        if x.dtype != torch.float32:
            raise ValueError(f"stream kernel: wires must be float32, got {x.dtype}")
        if x.shape != shape:
            raise ValueError(f"stream kernel: wire shapes differ ({x.shape} vs {shape})")
        if not x.is_contiguous():
            raise ValueError("stream kernel: wires must be contiguous")
        if x.device != inputs[0].device:
            raise ValueError("stream kernel: wires lie on different devices")
    if len(shape) not in (1, 2):
        raise ValueError(f"stream kernel: wires are (N,) or (B, N), got {tuple(shape)}")
    if shape[-1] % unit:
        raise ValueError(
            f"stream kernel: N={shape[-1]} tokens is not a multiple of the "
            f"program's block unit {unit}"
        )
    return math.prod(shape)


def fused_stream_cuda(
    inputs: Sequence[torch.Tensor], program: StreamProgram
) -> List[torch.Tensor]:
    """Run ``program`` over CUDA wires in ONE kernel launch; returns the
    output wires, shaped like the inputs."""
    global LAUNCHES
    dev = inputs[0].device if inputs else None
    if dev is None or dev.type != "cuda":
        check_inputs(inputs, program, block_unit(program))
        raise ValueError(
            f"stream kernel: wires must be CUDA tensors, got {dev} (the plain "
            f"version is ref.fused_stream_ref)"
        )
    c = _compile(program, dev)
    n = check_inputs(inputs, program, c.unit)
    out = torch.empty(
        (len(program.outputs),) + tuple(inputs[0].shape),
        dtype=torch.float32, device=dev,
    )
    outs = list(out.unbind(0))
    if n == 0:
        return outs
    lib = build()
    in_ptrs = (ctypes.c_void_p * len(inputs))(*[x.data_ptr() for x in inputs])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stream_fused_launch(
            ctypes.addressof(in_ptrs), len(inputs),
            ctypes.addressof(out_ptrs), len(outs),
            ctypes.addressof(c.in_slots), ctypes.addressof(c.out_slots),
            n, c.code.tile, c.threads, c.code.n_slots,
            c.ops.data_ptr(), c.code.ops.shape[0],
            c.params.data_ptr(), c.perm_idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"stream kernel launch failed: CUDA error {err}")
    with _lock:
        LAUNCHES += 1
    return outs
