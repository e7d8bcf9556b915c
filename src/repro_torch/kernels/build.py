"""Build one CUDA source under ``repro_torch/csrc/`` into a shared library with
a plain C interface, and load it with ``ctypes``.

``nvcc`` runs at first use, on the machine with the card, into
``repro_torch/build/``; the library is named by a hash of the source and the
flags, so a stale build is never reused and two processes never write the same
file (each builds into a temporary name and renames it into place).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
SM90A = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = (*SM90A, "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA toolkit")


def build_library(source: Path, flags: Sequence[str]) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``source`` (unless an up-to-date build exists) and load it.

    Returns ``(library, seconds, log)``: the seconds spent building and
    loading, and nvcc's ``-Xptxas -v`` report ("" when nothing was built).
    """
    src = Path(source).read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{Path(source).stem}_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        log = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    return lib, time.perf_counter() - t0, log
