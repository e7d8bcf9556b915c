"""The SSD-scan kernels on the card: build, bind, plan, check, launch.

Replaces the Pallas TPU kernel ``ssd_scan_fwd`` of ``repro/kernels/ssd_scan/
kernel.py``, and adds a backward the reference has not (JAX differentiates
its plain ``ssd_chunked``).  The CUDA source is ``repro_torch/csrc/
ssd_scan.cu``; its header note says what bounds the kernels and how the
designs answer that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``LIBRARY``, a ``kernels/build.py::Library``).
  ``ssd_init`` looks up the tensor-map encoder and lifts the blocks'
  shared-memory limit once per device.
* **Layout.**  Every kernel reads x and writes y (and the backward's dy and
  dx) in the model's layout ``(B, S, nheads, P)``, as they lie; dt and ``da
  = dt * A`` are ``(B nheads, S)`` float32, B and C ``(B, S, N)``, the final
  state ``(B nheads, P, N)`` float32.
* **Plan.**  ``ssd_plan`` is a pure function of the shapes and the card's
  SM count: the bfloat16 call's three kernels (chunk states, state passing,
  chunk outputs), each with the grid, threads and shared memory it is
  launched with, the head group of a chunk-output block, whether TMA can
  address the tensors, and the temporaries.  The float32 call is one
  kernel, one block per (b, h).  The source refuses a plan whose threads or
  shared memory are not its kernels' own.
* **Launch.**  ``ssd_scan_cuda`` checks its inputs (shapes, x, B and C all
  bfloat16 or all float32, dt and da float32, ``P <= 64``, ``N <= 128``, the
  chunk at most 256 and dividing ``S``, contiguous, and last CUDA),
  allocates y, the final state and the temporaries, launches the plan on
  the current stream and raises on a non-zero CUDA error.  ``LAUNCHES`` counts the calls that
  launch (three kernels a bfloat16 call, one a float32 call) and nothing
  else.
* **Backward.**  ``ssd_scan_bwd_cuda`` takes the bfloat16 call's inputs, y's
  cotangent and the final state's (or none), checks them as the forward
  does, and launches the five kernels of ``ssd_bwd_plan`` (chunk states and
  cotangents, the reverse state pass, the keys, the queries, the cumsum's
  reverse), none of them the forward's.  ``BWD_LAUNCHES`` counts the calls
  that launch.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels.build import CSRC, Library

LAUNCHES = 0
BWD_LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256  # csrc/ssd_scan.cu PP, NP, QMAX
QTILES = 128     # query rows of a chunk-output block: two warpgroups of 64
MAX_GROUP = 8    # csrc/ssd_scan.cu MAX_GROUP
SMEM_LIMIT = 232448
# csrc/ssd_scan.cu S1_SMEM, S3_SMEM and the float32 kernel's SMEM_BYTES (the
# launch refuses other values)
_ROWB, _TILE = 128, 64 * 128
STAGE1_SMEM = 1024 + MAX_CHUNK * _ROWB + 2 * MAX_CHUNK * _ROWB + 2 * MAX_CHUNK * 4 + 24
STAGE3_SMEM = (1024 + 4 * _TILE + 2 * MAX_CHUNK * _ROWB + 2 * (MAX_CHUNK * _ROWB + 2 * _TILE)
               + 3 * MAX_GROUP * MAX_CHUNK * 4 + 64)
F32_SMEM = 4 * (64 * 129 + 64 * 129 + 64 * 64 + 64 * 65 + 64 * 129 + 2 * 256 + 8)
# csrc/ssd_scan.cu BK_SMEM and BQ_SMEM, the backward's key and query kernels
_BW_SLOT = _TILE + MAX_CHUNK * _ROWB + 4 * _TILE
BWD_PASS_SPLIT = 4  # csrc/ssd_scan.cu BP_SPLIT: blocks of a row in the reverse state pass
KEYS_SMEM = 1024 + 2 * _TILE + 2 * MAX_CHUNK * _ROWB + 2 * _BW_SLOT + MAX_CHUNK * 4 + 64 * 4 + 24
QUERIES_SMEM = KEYS_SMEM + 2 * 64 * 4 + 4 * 4


@dataclass(frozen=True)
class Stage:
    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    smem: int


@dataclass(frozen=True)
class SsdPlan:
    chunk: int
    chunks: int
    head_group: int  # heads of a chunk-output block (bfloat16)
    tma: bool        # the tensors are addressable by TMA (bfloat16)
    stages: Tuple[Stage, ...]
    temporaries: Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]


def head_group(Bb: int, chunks: int, pairs: int, nheads: int, sms: int) -> int:
    """Heads a chunk-output block: the largest divisor of ``nheads`` up to
    ``MAX_GROUP`` that still gives a block to each of the ``sms`` SMs (fewer
    heads a block: more blocks, each recomputing C·Bᵀ), else 1."""
    base = Bb * chunks * pairs
    fits = [g for g in range(1, min(nheads, MAX_GROUP) + 1)
            if nheads % g == 0 and base * (nheads // g) >= sms]
    return max(fits) if fits else 1


def ssd_plan(BH: int, S: int, P: int, N: int, nheads: int, chunk: int, dtype: torch.dtype,
             sms: int, *, tma: bool = True) -> SsdPlan:
    """The kernels one call launches for these shapes on a card of ``sms``
    SMs.  ``tma``: x, B, C are 16-byte aligned (the plan also needs P and N
    multiples of 8; else the bfloat16 kernels stage their tiles with
    threads)."""
    Q = min(chunk, S)
    chunks = S // Q
    if dtype == torch.float32:
        return SsdPlan(Q, chunks, 0, False,
                       (Stage("ssd_scan_f32_kernel", (BH, 1, 1), 256, F32_SMEM),), ())
    Bb = BH // nheads
    pairs = math.ceil(Q / QTILES)
    g = head_group(Bb, chunks, pairs, nheads, sms)
    pad = (MAX_P, MAX_N)
    stages = (
        Stage("ssd_chunk_state_kernel", (BH * chunks, 1, 1), 128, STAGE1_SMEM),
        Stage("ssd_state_pass_kernel", (math.ceil(BH * pad[0] * pad[1] // 4 / 256), 1, 1), 256, 0),
        Stage("ssd_chunk_out_kernel", (Bb * chunks, math.ceil(nheads / g), pairs), 384,
              STAGE3_SMEM),
    )
    temporaries = (
        ("acs", (BH, S), torch.float32),
        ("states", (BH, chunks, *pad), torch.float32),
        ("entering", (2, BH, chunks, *pad), torch.bfloat16),  # hi, lo
        ("rising", (2, BH, chunks), torch.int32),  # stage 1's flags, stage 2's pairs
    )
    return SsdPlan(Q, chunks, g, tma and P % 8 == 0 and N % 8 == 0, stages, temporaries)


def ssd_bwd_plan(BH: int, S: int, P: int, N: int, nheads: int, chunk: int, *,
                 tma: bool = True) -> SsdPlan:
    """The five kernels of one bfloat16 backward call (csrc/ssd_scan.cu,
    backward), a pure function of the shapes.  A key or query block takes
    every head of its batch row, so dB and dC are summed over the heads in
    its registers and no block adds to another's (the head group is
    ``nheads``; the card's SM count does not enter)."""
    Q = min(chunk, S)
    chunks = S // Q
    Bb = BH // nheads
    qt = math.ceil(Q / 64)
    stages = (
        Stage("ssd_bwd_chunk_state_kernel", (BH * chunks, 2, 1), 128, STAGE1_SMEM),
        Stage("ssd_bwd_state_pass_kernel", (BH, BWD_PASS_SPLIT, 1), 256, 0),
        Stage("ssd_bwd_keys_kernel", (Bb * chunks, qt, 1), 256, KEYS_SMEM),
        Stage("ssd_bwd_queries_kernel", (Bb * chunks, qt, 1), 256, QUERIES_SMEM),
        Stage("ssd_bwd_dda_kernel", (BH * chunks, 1, 1), 256, 0),
    )
    pad = (BH, chunks, MAX_P, MAX_N)
    temporaries = (
        ("acs", (BH, S), torch.float32),
        ("rising", (2, BH, chunks), torch.int32),  # stage 1's flags, stage 2's pairs
        ("states", pad, torch.float32),  # S_c
        ("cot", pad, torch.float32),     # E_c
        ("rows4", (4, *pad), torch.bfloat16),  # H hi, H lo, D hi, D lo
        ("Z", (BH, S), torch.float32),
        ("colT", (BH, S), torch.float32),
        ("dq", (BH, S), torch.float32),
        ("dlast", (BH, chunks, BWD_PASS_SPLIT), torch.float32),
    )
    return SsdPlan(Q, chunks, nheads, tma and P % 8 == 0 and N % 8 == 0, stages, temporaries)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_f32_launch.restype = i
    # x dt da B C y state | BH S P N nheads chunk | plan stream
    lib.ssd_scan_f32_launch.argtypes = [p] * 7 + [i] * 6 + [p, p]
    lib.ssd_scan_bf16_launch.restype = i
    # x dt da B C y state acs states entering rising | BH S P N nheads chunk
    # group tma | plan stream
    lib.ssd_scan_bf16_launch.argtypes = [p] * 11 + [i] * 8 + [p, p]
    lib.ssd_scan_bwd_launch.restype = i
    # pointers | BH S P N nheads chunk tma | plan stream
    lib.ssd_scan_bwd_launch.argtypes = [p] + [i] * 7 + [p, p]


LIBRARY = Library(CSRC / "ssd_scan.cu", _bind, init="ssd_init", what="ssd_scan kernel")


def check_inputs(x, dt, da, B_, C_, chunk: int) -> int:
    """Validate the inputs both directions take, but for the device (each
    entry checks that last, so that every refusal shows on CPU tensors);
    returns the chunk length the kernels run.  x is (B, S, nheads, P), the
    model's layout.  Raises ``ValueError``."""
    if x.dim() != 4 or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError("ssd_scan kernel: x is (B, S, nheads, P), B and C are (B, S, N)")
    Bb, S, nheads, P = x.shape
    BH, N = Bb * nheads, B_.shape[-1]
    if tuple(B_.shape) != (Bb, S, N) or tuple(C_.shape) != (Bb, S, N):
        raise ValueError(
            f"ssd_scan kernel: x {tuple(x.shape)}, B {tuple(B_.shape)}, C "
            f"{tuple(C_.shape)} do not agree"
        )
    for name, t in (("dt", dt), ("da", da)):
        if t.dtype != torch.float32 or tuple(t.shape) != (BH, S):
            raise ValueError(f"ssd_scan kernel: {name} must be float32 ({BH}, {S})")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise ValueError(
            f"ssd_scan kernel: x, B, C are all bfloat16 or all float32, got "
            f"{x.dtype}, {B_.dtype}, {C_.dtype}"
        )
    if not (0 < P <= MAX_P and 0 < N <= MAX_N and S > 0):
        raise ValueError(f"ssd_scan kernel: P={P} (<= {MAX_P}), N={N} (<= {MAX_N}), S={S}")
    Q = min(chunk, S)
    if Q > MAX_CHUNK or Q <= 0 or S % Q:
        raise ValueError(
            f"ssd_scan kernel: chunk {Q} must be in 1..{MAX_CHUNK} and divide S={S}"
        )
    for t in (x, dt, da, B_, C_):
        if not t.is_contiguous():
            raise ValueError("ssd_scan kernel: inputs must be contiguous")
        if t.device != x.device:
            raise ValueError("ssd_scan kernel: inputs lie on different devices")
    if x.numel() >= 2**31 or B_.numel() >= 2**31:
        raise ValueError("ssd_scan kernel: inputs too large for int offsets")
    return Q


def _cuda_only(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"ssd_scan kernel: tensors must be CUDA tensors, got {x.device} (the plain "
            f"version is ref.ssd_scan_ref)"
        )


def ssd_scan_cuda(x, dt, da, B_, C_, *, chunk: int):
    """(y (B, S, nheads, P) in x.dtype, final state (B nheads, P, N)
    float32): one kernel for float32, the three of the plan for bfloat16.
    The bfloat16 kernels take L below the diagonal as two factors, each at
    most 1 where da <= 0 (csrc/ssd_scan.cu); with da > 0 a factor overflows
    only where the plain version's own weight does, a_cs rising by more than
    88 within a chunk."""
    global LAUNCHES
    Q = check_inputs(x, dt, da, B_, C_, chunk)
    _cuda_only(x)
    lib = LIBRARY.on(x.device)
    Bb, S, nheads, P = x.shape
    BH, N = Bb * nheads, B_.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, B_, C_))
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = ssd_plan(BH, S, P, N, nheads, Q, x.dtype, sms, tma=aligned)
    dims = [n for st in plan.stages for n in (*st.grid, st.threads, st.smem)]
    dims = (ctypes.c_int * len(dims))(*dims)
    y = torch.empty_like(x)
    state = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if x.dtype == torch.float32:
            err = lib.ssd_scan_f32_launch(
                x.data_ptr(), dt.data_ptr(), da.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                y.data_ptr(), state.data_ptr(), BH, S, P, N, nheads, Q, dims, stream,
            )
        else:
            tmp = [torch.empty(shape, dtype=dtype, device=x.device)
                   for _, shape, dtype in plan.temporaries]
            err = lib.ssd_scan_bf16_launch(
                x.data_ptr(), dt.data_ptr(), da.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                y.data_ptr(), state.data_ptr(), *(t.data_ptr() for t in tmp), BH, S, P, N,
                nheads, Q, plan.head_group, int(plan.tma), dims, stream,
            )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    with LIBRARY.lock:
        LAUNCHES += 1
    return y, state


def ssd_scan_bwd_cuda(x, dt, da, A, B_, C_, dy, dstate, *, chunk: int):
    """The cotangents of the bfloat16 scan's inputs from y's (``dy``) and the
    final state's (``dstate`` (BH, P, N) float32, or ``None`` for zero).  x,
    dy and the returned dx lie in the model's layout (B, S, nheads, P); dt
    and ``da = dt * A`` as the forward took them, (BH, S) float32; A
    (nheads,) float32, x's heads.  Returns ``(dx, ddt (BH, S) float32, dA (nheads,)
    float32, dB, dC (B, S, N))``: five kernels (``ssd_bwd_plan``); dA sums
    their per-chunk parts in a fixed order."""
    global BWD_LAUNCHES
    Q = check_inputs(x, dt, da, B_, C_, chunk)
    Bb, S, nheads, P = x.shape
    BH, N = Bb * nheads, B_.shape[-1]
    if (A.dim() != 1 or A.shape[0] != nheads or A.dtype != torch.float32
            or not A.is_contiguous() or A.device != x.device):
        raise ValueError(f"ssd_scan backward kernel: A must be a contiguous float32 "
                         f"({nheads},), x's heads")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"ssd_scan backward kernel: bfloat16 only, got {x.dtype}")
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() or dy.device != x.device:
        raise ValueError(f"ssd_scan backward kernel: dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if dstate is not None and (dstate.dtype != torch.float32 or dstate.shape != (BH, P, N)
                               or not dstate.is_contiguous() or dstate.device != x.device):
        raise ValueError(f"ssd_scan backward kernel: dstate must be a contiguous float32 "
                         f"({BH}, {P}, {N}) or None")
    _cuda_only(x)
    lib = LIBRARY.on(x.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, B_, C_))
    plan = ssd_bwd_plan(BH, S, P, N, nheads, Q, tma=aligned)
    dims = [n for st in plan.stages for n in (*st.grid, st.threads, st.smem)]
    dims = (ctypes.c_int * len(dims))(*dims)
    dx = torch.empty_like(x)
    ddt = torch.empty((BH, S), dtype=torch.float32, device=x.device)
    parts = torch.empty((BH, plan.chunks), dtype=torch.float32, device=x.device)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    tmp = [torch.empty(shape, dtype=dtype, device=x.device)
           for _, shape, dtype in plan.temporaries]
    ptrs = [x, dy, dt, da, A, B_, C_, dstate, dx, ddt, parts, dB, dC, *tmp]
    ptrs = (ctypes.c_void_p * len(ptrs))(*(None if t is None else t.data_ptr() for t in ptrs))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_bwd_launch(ptrs, BH, S, P, N, nheads, Q, int(plan.tma), dims, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error {err}")
    with LIBRARY.lock:
        BWD_LAUNCHES += 1
    dA = parts.view(Bb, nheads, plan.chunks).sum(dim=(0, 2))
    return dx, ddt, dA, dB, dC
