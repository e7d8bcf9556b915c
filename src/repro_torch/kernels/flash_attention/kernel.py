"""The flash-attention kernels on the card: build, bind, check, launch.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention/
kernel.py``: ``flash_attention_fwd`` and the two ``pallas_call``s of
``flash_attention_bwd`` (dQ, and dK/dV).  The CUDA source is
``repro_torch/csrc/flash_attention.cu``; its header note says what bounds the
kernels and how the design answers that.

* **Build.**  At first use ``nvcc`` compiles the source for ``sm_90a`` into a
  shared library with a plain C interface under ``repro_torch/build/``,
  loaded with ``ctypes`` (``LIBRARY``, a ``kernels/build.py::Library``).  ``flash_init`` lifts the
  shared-memory limit of every instantiation once per device and looks up
  the tensor-map encoder ``cuTensorMapEncodeTiled`` at run time (no
  ``-lcuda``).
* **Launch.**  Each wrapper checks its inputs (CUDA, contiguous and 16-byte
  aligned, one of bfloat16/float32, ``hd`` in 16/32/64/128, sequence lengths
  a multiple of ``TILE``), allocates the outputs, launches on the current
  stream and raises on a non-zero CUDA error.  bfloat16 inputs run the
  tensor-core kernels (TMA, an mbarrier ring and ``wgmma``, with tensor maps
  encoded per launch), float32 inputs the CUDA-core ones.  ``FWD_LAUNCHES``,
  ``DQ_LAUNCHES`` and ``DKV_LAUNCHES`` count the launches and nothing else.

The plain versions live in ``ref.py``; ``ops.py`` picks between the two by
the device of the tensors.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import CSRC, Library

FWD_LAUNCHES = 0
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

HEAD_DIMS = (16, 32, 64, 128)
TILE = 64  # csrc/flash_attention.cu TILE: rows per streamed tile
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i, i, i, i, i, i, f, i, p]  # BH BKV Sq Sk hd bf16 scale causal stream
    for name, n_ptr in (
        ("flash_fwd_launch", 5),
        ("flash_bwd_dq_launch", 7),
        ("flash_bwd_dkv_launch", 8),
    ):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = [p] * n_ptr + tail


LIBRARY = Library(CSRC / "flash_attention.cu", _bind, init="flash_init", what="flash kernels")


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest: torch.Tensor
                 ) -> Tuple[int, int, int, int, int]:
    """Validate what the kernels take; returns ``(BH, BKV, Sq, Sk, hd)``.
    ``rest`` are tensors shaped like ``q`` (o, dO).  Raises ``ValueError``."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"flash kernels: q, k, v are (BH, S, hd), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    BH, Sq, hd = q.shape
    BKV, Sk, hd_k = k.shape
    if tuple(v.shape) != tuple(k.shape) or hd_k != hd:
        raise ValueError(f"flash kernels: k {tuple(k.shape)} / v {tuple(v.shape)} vs q {tuple(q.shape)}")
    if BKV == 0 or BH % BKV:
        raise ValueError(f"flash kernels: {BH} query heads do not group over {BKV} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernels: head dim {hd} not in {HEAD_DIMS}")
    if Sq % TILE or Sk % TILE or Sq == 0 or Sk == 0:
        raise ValueError(f"flash kernels: sequence lengths {Sq}, {Sk} must be multiples of {TILE}")
    for t in (q, k, v, *rest):
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash kernels: inputs are all bfloat16 or all float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError("flash kernels: inputs must start on a 16-byte boundary")
        if t.device != q.device:
            raise ValueError("flash kernels: inputs lie on different devices")
    for t in rest:
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"flash kernels: {tuple(t.shape)} is not shaped like q {tuple(q.shape)}")
    return BH, BKV, Sq, Sk, hd


def _check_rows(name: str, t: torch.Tensor, BH: int, Sq: int, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (BH, Sq) or not t.is_contiguous():
        raise ValueError(f"flash kernels: {name} must be contiguous float32 ({BH}, {Sq})")
    if t.data_ptr() % 16:  # the bf16 backward kernels copy rows with cp.async.bulk
        raise ValueError(f"flash kernels: {name} must start on a 16-byte boundary")
    if t.device != device:
        raise ValueError(f"flash kernels: {name} lies on another device")


def _cuda_only(q: torch.Tensor, plain: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(
            f"flash kernels: tensors must be CUDA tensors, got {q.device} (the plain "
            f"version is ref.{plain})"
        )


def _scale(scale: Optional[float], hd: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(hd)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd_cuda(q, k, v, *, causal: bool = True, scale: Optional[float] = None):
    """(o, lse) of causal/full GQA attention in ONE kernel launch."""
    global FWD_LAUNCHES
    BH, BKV, Sq, Sk, hd = check_inputs(q, k, v)
    _cuda_only(q, "flash_fwd_ref")
    lib = LIBRARY.on(q.device)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            BH, BKV, Sq, Sk, hd, DTYPES[q.dtype], _scale(scale, hd), int(causal),
            _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    with LIBRARY.lock:
        FWD_LAUNCHES += 1
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                      scale: Optional[float] = None) -> torch.Tensor:
    """dQ in ONE kernel launch (``delta = rowsum(dO * O)``, float32)."""
    global DQ_LAUNCHES
    BH, BKV, Sq, Sk, hd = check_inputs(q, k, v, do)
    _check_rows("lse", lse, BH, Sq, q.device)
    _check_rows("delta", delta, BH, Sq, q.device)
    _cuda_only(q, "flash_bwd_dq_ref")
    lib = LIBRARY.on(q.device)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(),
            BH, BKV, Sq, Sk, hd, DTYPES[q.dtype], _scale(scale, hd), int(causal),
            _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: CUDA error {err}")
    with LIBRARY.lock:
        DQ_LAUNCHES += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                       scale: Optional[float] = None):
    """(dK, dV) per kv head, summed over its query-head group, in ONE launch."""
    global DKV_LAUNCHES
    BH, BKV, Sq, Sk, hd = check_inputs(q, k, v, do)
    _check_rows("lse", lse, BH, Sq, q.device)
    _check_rows("delta", delta, BH, Sq, q.device)
    _cuda_only(q, "flash_bwd_dkv_ref")
    lib = LIBRARY.on(q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, BKV, Sq, Sk, hd, DTYPES[q.dtype], _scale(scale, hd), int(causal),
            _stream(q.device),
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: CUDA error {err}")
    with LIBRARY.lock:
        DKV_LAUNCHES += 1
    return dk, dv
