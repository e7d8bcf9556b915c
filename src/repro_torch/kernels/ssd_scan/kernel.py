"""The SSD-scan kernel on the card: build, bind, check, launch.

Replaces the Pallas TPU kernel ``ssd_scan_fwd`` of ``repro/kernels/ssd_scan/
kernel.py``.  The CUDA source is ``repro_torch/csrc/ssd_scan.cu``; its header
note says what bounds the kernel and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``kernels/build.py``).  ``ssd_init`` lifts the
  block's shared-memory limit once per device.
* **Launch.**  ``ssd_scan_cuda`` checks its inputs (CUDA, contiguous, x, B
  and C all bfloat16 or all float32, dt and da float32, ``P <= 64``, ``N <=
  128``, the chunk at most 256 and dividing ``S``), allocates y and the final
  state, launches on the current stream and raises on a non-zero CUDA error.
  ``LAUNCHES`` counts the launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Set

import torch

from repro_torch.kernels.build import COMMON_FLAGS, CSRC, build_library

LAUNCHES = 0
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the last build

SOURCE = CSRC / "ssd_scan.cu"
NVCC_FLAGS = COMMON_FLAGS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256  # csrc/ssd_scan.cu PT, NT, QMAX

_lock = threading.Lock()
_lib = None
_ready: Set[int] = set()  # devices whose smem limit ssd_init has lifted


def build() -> ctypes.CDLL:
    """Compile (once per process and source) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS, log = build_library(SOURCE, NVCC_FLAGS)
        BUILD_LOG = log or BUILD_LOG
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ssd_init.restype = i
        lib.ssd_init.argtypes = []
        lib.ssd_scan_launch.restype = i
        # x dt da B C y state | BH S P N nheads chunk bf16 stream
        lib.ssd_scan_launch.argtypes = [p] * 7 + [i] * 7 + [p]
        _lib = lib
        return lib


def _library(dev: torch.device) -> ctypes.CDLL:
    lib = build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _ready:
        with _lock, torch.cuda.device(idx):
            if idx not in _ready:
                err = lib.ssd_init()
                if err != 0:
                    raise RuntimeError(f"ssd_scan kernel: ssd_init failed: CUDA error {err}")
                _ready.add(idx)
    return lib


def check_inputs(x, dt, da, B_, C_, nheads: int, chunk: int) -> int:
    """Validate what the kernel takes; returns the chunk length it runs.
    Raises ``ValueError``."""
    if x.device.type != "cuda":
        raise ValueError(
            f"ssd_scan kernel: tensors must be CUDA tensors, got {x.device} (the plain "
            f"version is ref.ssd_scan_ref)"
        )
    if x.dim() != 3 or B_.dim() != 3 or C_.dim() != 3:
        raise ValueError("ssd_scan kernel: x is (BH, S, P), B and C are (B, S, N)")
    BH, S, P = x.shape
    Bb, S_b, N = B_.shape
    if tuple(C_.shape) != (Bb, S_b, N) or S_b != S or Bb * nheads != BH:
        raise ValueError(
            f"ssd_scan kernel: x {tuple(x.shape)}, B {tuple(B_.shape)}, C "
            f"{tuple(C_.shape)} with {nheads} heads do not agree"
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


def ssd_scan_cuda(x, dt, da, B_, C_, *, nheads: int, chunk: int):
    """(y (BH, S, P) in x.dtype, final state (BH, P, N) float32) in ONE
    kernel launch."""
    global LAUNCHES
    Q = check_inputs(x, dt, da, B_, C_, nheads, chunk)
    lib = _library(x.device)
    BH, S, P = x.shape
    N = B_.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((BH, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), state.data_ptr(), BH, S, P, N, nheads, Q, DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    with _lock:
        LAUNCHES += 1
    return y, state
