"""The int8 quantization kernel on the card: build, bind, check, launch.

Replaces the Pallas TPU kernel ``quantize_int8_fwd`` of ``repro/kernels/
quant/kernel.py``.  The CUDA source is ``repro_torch/csrc/quant.cu``; its
header note says what bounds the kernel and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``LIBRARY``, a ``kernels/build.py::Library``).
* **Launch.**  ``quantize_int8_cuda`` checks its input (x ``(R, d)`` with
  ``d >= 1``, bfloat16 or float32, contiguous, on CUDA; any size, offsets
  are 64-bit), allocates q and the scales, launches once on the current
  stream and raises on a non-zero CUDA error.  ``LAUNCHES`` counts the
  launches and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CSRC, Library

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.quant_launch.restype = ctypes.c_int
    # x q s R d bf16 stream
    lib.quant_launch.argtypes = [p, p, p, ll, ll, ctypes.c_int, p]


LIBRARY = Library(CSRC / "quant.cu", _bind)


def check_inputs(x: torch.Tensor) -> None:
    """Validate what the kernel takes; raises ``ValueError``.  Shape, type
    and layout come before the device, so each refusal shows on any tensor."""
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quant kernel: x is (R, d) with d >= 1, got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"quant kernel: x is bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quant kernel: x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(
            f"quant kernel: x must be a CUDA tensor, got {x.device} (the plain version "
            f"is ref.quantize_int8_ref)"
        )


def quantize_int8_cuda(x: torch.Tensor):
    """``x (R, d) -> (q int8 (R, d), scale float32 (R, 1))`` in ONE launch."""
    global LAUNCHES
    check_inputs(x)
    lib = LIBRARY.on(x.device)
    R, d = x.shape
    q = torch.empty((R, d), dtype=torch.int8, device=x.device)
    s = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    if R:
        with torch.cuda.device(x.device):
            err = lib.quant_launch(
                x.data_ptr(), q.data_ptr(), s.data_ptr(), R, d, DTYPES[x.dtype],
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"quant launch failed: CUDA error {err}")
        with LIBRARY.lock:
            LAUNCHES += 1
    return q, s
