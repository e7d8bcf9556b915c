"""Build one CUDA source under ``repro_torch/csrc/`` into a shared library with
a plain C interface, and load it with ``ctypes``.

``nvcc`` runs at first use, on the machine with the card, into
``repro_torch/build/``; the library is named by a hash of the source, every
local header it includes and the flags (``source_tag``), so a stale build is
never reused and two processes never write the same file (each builds the
library and its report into temporary names and renames them into place, the
report first).  nvcc's ``-Xptxas -v`` report is
kept beside the library and returned with it, built or not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Sequence, Tuple

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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_sources(source: Path) -> List[Path]:
    """``source`` and every file it includes with ``#include "..."``,
    transitively, each once (resolved beside the file that includes it)."""
    seen: List[Path] = []
    todo = [Path(source).resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return seen


def source_tag(source: Path, flags: Sequence[str]) -> str:
    """A hash of the source, its local headers (``local_sources``) and the
    flags: a change to any of them names another library."""
    h = hashlib.sha256()
    for path in local_sources(source):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(source: Path, flags: Sequence[str]) -> Tuple[ctypes.CDLL, float, str]:
    """Compile ``source`` (unless an up-to-date build exists) and load it.

    Returns ``(library, seconds, log)``: the seconds spent building and
    loading, and nvcc's ``-Xptxas -v`` report of the build (kept beside the
    library, so a library built earlier returns its report too).
    """
    so = BUILD_DIR / f"{Path(source).stem}_{source_tag(source, flags)}.so"
    report = so.with_suffix(".log")
    t0 = time.perf_counter()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *flags, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        tmp_report = report.with_suffix(f".{os.getpid()}.logtmp")
        tmp_report.write_text(proc.stderr)
        os.replace(tmp_report, report)  # the report is in place before the library
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    log = report.read_text() if report.exists() else ""
    return lib, time.perf_counter() - t0, log
