"""Build one CUDA source under ``repro_torch/csrc/`` into a shared library with
a plain C interface, and load it with ``ctypes``.

``nvcc`` runs at first use, on the machine with the card, into
``repro_torch/build/``; the library is named by a hash of the source, every
local header it includes and the flags (``source_tag``), so a stale build is
never reused and two processes never write the same file (each builds the
library and its report into temporary names and renames them into place, the
report first).  nvcc's ``-Xptxas -v`` report is
kept beside the library and returned with it, built or not.

A kernel module holds its library as a ``Library``: built and loaded once
per process, its entry points declared by the module's ``bind``, and its
``init`` entry, where it has one, run once per device before the first
launch there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Set, Tuple

import torch

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


class Library:
    """The library of one CUDA source, as its kernel module holds it.

    ``build()`` compiles and loads it once per process (``build_library``
    with ``flags``) and declares its entry points with ``bind(lib)``.
    ``on(device)`` also runs its ``init`` entry, a C function of no argument
    that returns a CUDA error, once per device, and raises ``RuntimeError``
    (``"<what>: <init> failed: CUDA error <n>"``) on a non-zero one.
    ``seconds`` and ``log`` are the build's seconds and ptxas report;
    ``lock`` also guards the module's launch counters."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 init: Optional[str] = None, what: str = "",
                 flags: Sequence[str] = COMMON_FLAGS):
        self.source = Path(source)
        self.what = what or self.source.stem
        self.flags = tuple(flags)
        self.lock = threading.Lock()
        self.seconds: Optional[float] = None
        self.log = ""
        self._bind, self._init = bind, init
        self._lib: Optional[ctypes.CDLL] = None
        self._ready: Set[int] = set()  # devices whose init has run

    def build(self) -> ctypes.CDLL:
        """Compile (unless an up-to-date build exists), load and bind, once."""
        with self.lock:
            if self._lib is None:
                lib, self.seconds, self.log = build_library(self.source, self.flags)
                self._bind(lib)
                if self._init is not None:
                    fn = getattr(lib, self._init)
                    fn.restype, fn.argtypes = ctypes.c_int, []
                self._lib = lib
            return self._lib

    def on(self, device: torch.device) -> ctypes.CDLL:
        """The library, its ``init`` run on ``device``."""
        lib = self.build()
        if self._init is None:
            return lib
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in self._ready:
            with self.lock, torch.cuda.device(idx):
                if idx not in self._ready:
                    err = getattr(lib, self._init)()
                    if err != 0:
                        raise RuntimeError(f"{self.what}: {self._init} failed: CUDA error {err}")
                    self._ready.add(idx)
        return lib
