"""The RMSNorm kernel on the card: build, bind, check, launch.

Replaces the Pallas TPU kernel ``rmsnorm_fwd`` of ``repro/kernels/rmsnorm/
kernel.py``.  The CUDA source is ``repro_torch/csrc/rmsnorm.cu``; its header
note says what bounds the kernel and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``kernels/build.py``).
* **Launch.**  ``rmsnorm_cuda`` checks its inputs (CUDA, contiguous, x
  bfloat16 or float32 of shape ``(R, d)``, scale float32 ``(d,)`` on the same
  device), allocates the output, launches on the current stream and raises on
  a non-zero CUDA error.  ``LAUNCHES`` counts the launches and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels.build import COMMON_FLAGS, CSRC, build_library

LAUNCHES = 0
BUILD_SECONDS: Optional[float] = None
BUILD_LOG = ""  # nvcc's -Xptxas -v report of the last build

SOURCE = CSRC / "rmsnorm.cu"
NVCC_FLAGS = COMMON_FLAGS
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.restype = i
        # x scale y R d bf16 eps stream
        lib.rmsnorm_launch.argtypes = [p, p, p, i, i, i, ctypes.c_float, p]
        _lib = lib
        return lib


def check_inputs(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Validate what the kernel takes; raises ``ValueError``."""
    if x.device.type != "cuda":
        raise ValueError(
            f"rmsnorm kernel: x must be a CUDA tensor, got {x.device} (the plain "
            f"version is ref.rmsnorm_ref)"
        )
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"rmsnorm kernel: x is (R, d), got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"rmsnorm kernel: x is bfloat16 or float32, got {x.dtype}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (x.shape[1],):
        raise ValueError(
            f"rmsnorm kernel: scale must be float32 ({x.shape[1]},), got {scale.dtype} "
            f"{tuple(scale.shape)}"
        )
    if scale.device != x.device:
        raise ValueError("rmsnorm kernel: x and scale lie on different devices")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel: inputs must be contiguous")
    if x.shape[0] >= 2**31 or x.numel() >= 2**31:
        raise ValueError(f"rmsnorm kernel: {tuple(x.shape)} is too large for int offsets")


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the rows of ``x (R, d)`` in ONE kernel launch."""
    global LAUNCHES
    check_inputs(x, scale)
    lib = build()
    R, d = x.shape
    y = torch.empty_like(x)
    if R:
        with torch.cuda.device(x.device):
            err = lib.rmsnorm_launch(
                x.data_ptr(), scale.data_ptr(), y.data_ptr(), R, d, DTYPES[x.dtype],
                float(eps), torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
        with _lock:
            LAUNCHES += 1
    return y
