"""The grouped-matmul kernel on the card: build, bind, check, launch.

Replaces the Pallas TPU kernel ``grouped_matmul_fwd`` of ``repro/kernels/
moe_gmm/kernel.py``.  The CUDA source is ``repro_torch/csrc/moe_gmm.cu``; its
header note says what bounds the kernel and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``kernels/build.py``).  ``moe_gmm_init`` looks up
  the tensor-map encoder and lifts the shared-memory limit of the bfloat16
  kernels once per device.
* **Tile plan.**  ``tile_plan(C)`` picks from ``C`` only how many 64-row
  warpgroups a bfloat16 block has (and so how many blocks there are), never
  the instructions, so that a row's sum runs in one order whatever ``C`` is
  (the source's header note).
* **Launch.**  ``grouped_matmul_cuda`` checks its inputs (CUDA tensors on one
  device, contiguous, one type, bfloat16 or float32, ``x (E, C, d)`` and ``w
  (E, d, f)``; bfloat16 needs ``d % 8 == 0``, ``f % 8 == 0`` and 16-byte
  aligned bases, which the kernel's tensor maps require), allocates the
  output, launches on the current stream and raises on a non-zero CUDA
  error.  ``LAUNCHES`` counts the launches and nothing else; ``DX_LAUNCHES``
  those of them made for a backward's ``dx``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Set, Tuple

import torch

from repro_torch.kernels.build import COMMON_FLAGS, CSRC, build_library

LAUNCHES = 0
DX_LAUNCHES = 0  # the launches of LAUNCHES made for a backward's dx
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the last build

SOURCE = CSRC / "moe_gmm.cu"
NVCC_FLAGS = COMMON_FLAGS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BF16_ALIGN = 8  # d and f: TMA's row strides are multiples of 16 bytes

_lock = threading.Lock()
_lib = None
_ready: Set[int] = set()  # devices whose smem limits moe_gmm_init has lifted


def build() -> ctypes.CDLL:
    """Compile (once per process and source) and load the kernel library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    with _lock:
        if _lib is not None:
            return _lib
        lib, BUILD_SECONDS, log = build_library(SOURCE, NVCC_FLAGS)
        BUILD_LOG = log or BUILD_LOG
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.moe_gmm_init.restype = i
        lib.moe_gmm_init.argtypes = []
        lib.moe_gmm_launch.restype = i
        # x w y E C d f bf16 wgs stream
        lib.moe_gmm_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
        _lib = lib
        return lib


def _library(dev: torch.device) -> ctypes.CDLL:
    lib = build()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _ready:
        with _lock, torch.cuda.device(idx):
            if idx not in _ready:
                err = lib.moe_gmm_init()
                if err != 0:
                    raise RuntimeError(f"moe_gmm kernel: moe_gmm_init failed: CUDA error {err}")
                _ready.add(idx)
    return lib


def tile_plan(C: int) -> int:
    """The bfloat16 kernel's consumer warpgroups of 64 rows a block for ``C``
    rows an expert: one up to 64 rows (a decode: its smaller stage leaves
    room for a deeper ring of w), two above.  It is all that ``C`` picks:
    every instruction, and so the order of a row's sum, is fixed by the
    kernel whatever ``C`` is."""
    return 1 if C <= 64 else 2


def check_inputs(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate what the kernel takes; returns ``(E, C, d, f)``.  The device
    is checked last, so a CPU tensor that passes every other check is refused
    for its device alone.  Raises ``ValueError``."""
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(
            f"moe_gmm kernel: x is (E, C, d) and w (E, d, f), got {tuple(x.shape)}, "
            f"{tuple(w.shape)}"
        )
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(
            f"moe_gmm kernel: x and w are both bfloat16 or both float32, got {x.dtype}, "
            f"{w.dtype}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm kernel: inputs must be contiguous")
    E, C, d = x.shape
    f = w.shape[2]
    if E >= 2**16 or C >= 2**22 or max(d, f) >= 2**31:  # grid limits, int sizes
        raise ValueError(f"moe_gmm kernel: {tuple(x.shape)} x {tuple(w.shape)} is too large")
    if x.dtype == torch.bfloat16:
        if d == 0 or d % BF16_ALIGN or f % BF16_ALIGN:
            raise ValueError(
                f"moe_gmm kernel: bfloat16 needs d % {BF16_ALIGN} == 0 (d > 0) and "
                f"f % {BF16_ALIGN} == 0, got d={d}, f={f}"
            )
        if x.data_ptr() % 16 or w.data_ptr() % 16:
            raise ValueError("moe_gmm kernel: bfloat16 inputs must start on a 16-byte boundary")
    if x.device.type != "cuda" or w.device.type != "cuda":
        raise ValueError(
            f"moe_gmm kernel: x and w must be CUDA tensors, got {x.device}, {w.device} (the "
            f"plain version is ref.grouped_matmul_ref)"
        )
    if x.device != w.device:
        raise ValueError("moe_gmm kernel: x and w lie on different devices")
    return E, C, d, f


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor, *, dx: bool = False) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]`` for ``x (E, C, d)``, ``w (E, d, f)`` in ONE
    kernel launch; float32 accumulation, one rounding to ``x.dtype``.
    ``dx`` marks a launch for a backward's ``dy . w^T``: it counts in
    ``DX_LAUNCHES`` as well as in ``LAUNCHES``."""
    global LAUNCHES, DX_LAUNCHES
    E, C, d, f = check_inputs(x, w)
    lib = _library(x.device)
    y = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    if E and C and f:
        with torch.cuda.device(x.device):
            err = lib.moe_gmm_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), E, C, d, f, DTYPES[x.dtype],
                tile_plan(C), torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"moe_gmm launch failed: CUDA error {err}")
        with _lock:
            LAUNCHES += 1
            DX_LAUNCHES += dx
    return y
