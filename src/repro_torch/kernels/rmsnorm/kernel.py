"""The RMSNorm kernel on the card: build, bind, check, launch.

Replaces the Pallas TPU kernel ``rmsnorm_fwd`` of ``repro/kernels/rmsnorm/
kernel.py``.  The CUDA source is ``repro_torch/csrc/rmsnorm.cu``; its header
note says what bounds the kernel and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``LIBRARY``, a ``kernels/build.py::Library``).
* **Plan.**  ``norm_plan(R, d, dtype)`` is a pure function of the shape:
  the warps a row, the rows a block, the 16-byte vectors a lane holds (the
  kernel's template argument) and the passes over a row.
* **Launch.**  ``rmsnorm_cuda`` checks its inputs (CUDA, contiguous, x
  bfloat16 or float32 of shape ``(R, d)``, scale float32 ``(d,)`` on the same
  device), allocates the output, launches on the current stream and raises on
  a non-zero CUDA error.  ``LAUNCHES`` counts the launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.build import CSRC, Library

LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VPLS = (1, 2, 3, 4, 6, 8, 12, 16)  # csrc/rmsnorm.cu: the vectors a lane may hold
WARPS_PER_ROW = (1, 2, 4, 8)
BLOCK_WARPS = 8  # csrc/rmsnorm.cu MAX_WARPS
HELD = {True: 4, False: 8}  # at large R, the vectors (16-byte, scalar) a lane holds
#                           before a row takes more warps
FEW_ROWS = 264   # fewer rows than two per SM of the H100's 132: spread each row


@dataclass(frozen=True)
class NormPlan:
    warps_per_row: int
    rows_per_block: int
    vecs_per_lane: int
    vec: int     # elements of a vector: 16 bytes, or 1 (the scalar instantiation)
    passes: int  # over a row: 1 unless it is wider than 8 warps' registers

    def blocks(self, R: int) -> int:
        """Blocks that cover R rows; the launch caps them at four times the
        card's resident blocks, each walking its share."""
        return math.ceil(R / self.rows_per_block)


def norm_plan(R: int, d: int, dtype: torch.dtype, aligned: bool = True) -> NormPlan:
    """How the kernel holds rows of ``d`` elements.  ``aligned``: x, y and
    scale start on 16-byte boundaries.

    Few rows (decode): a row takes the most warps that still give every lane
    one vector, so 8 rows run on 8 SMs with one load a lane.  Many rows: one
    warp a row, more when a lane would hold more than ``HELD`` vectors (its
    columns of ``scale`` stay in registers too), eight warps a block."""
    width = 16 // (torch.finfo(dtype).bits // 8)
    vec = width if aligned and d % width == 0 else 1
    nvec = math.ceil(d / vec)
    if R < FEW_ROWS:
        want = math.ceil(nvec / 32)
        wpr = next((w for w in WARPS_PER_ROW if w >= want), WARPS_PER_ROW[-1])
        rows = 1
    else:
        held = HELD[vec > 1]
        wpr = next((w for w in WARPS_PER_ROW if math.ceil(nvec / (32 * w)) <= held),
                   WARPS_PER_ROW[-1])
        rows = BLOCK_WARPS // wpr
    per_lane = math.ceil(nvec / (32 * wpr))
    vpl = next((v for v in VPLS if v >= per_lane), VPLS[-1])
    return NormPlan(wpr, rows, vpl, vec, math.ceil(nvec / (32 * wpr * vpl)))


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rmsnorm_launch.restype = i
    # x scale y R d bf16 eps | wpr rows vpl vec passes | stream
    lib.rmsnorm_launch.argtypes = [p, p, p, i, i, i, ctypes.c_float] + [i] * 5 + [p]


LIBRARY = Library(CSRC / "rmsnorm.cu", _bind)


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
    lib = LIBRARY.on(x.device)
    R, d = x.shape
    y = torch.empty_like(x)
    if R:
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, y))
        plan = norm_plan(R, d, x.dtype, aligned)
        with torch.cuda.device(x.device):
            err = lib.rmsnorm_launch(
                x.data_ptr(), scale.data_ptr(), y.data_ptr(), R, d, DTYPES[x.dtype],
                float(eps), plan.warps_per_row, plan.rows_per_block, plan.vecs_per_lane,
                int(plan.vec > 1), plan.passes, torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
        with LIBRARY.lock:
            LAUNCHES += 1
    return y
