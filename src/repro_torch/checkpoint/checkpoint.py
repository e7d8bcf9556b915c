"""Checkpointing: atomic, resumable, async (port of ``repro/checkpoint/
checkpoint.py`` for trees of tensors).

Layout, as the reference's:  <dir>/step_<n>/  manifest.json  +  one .npy per
leaf (flattened key path).  Writes go to a temp dir and are renamed
atomically; a ``latest`` marker file is updated last, so a crash mid-write
never corrupts the restore point.  ``runtime.chaos`` sites (``ckpt:leaf``,
``ckpt:commit``) let tests kill a save at any point.

bfloat16 leaves are stored losslessly: numpy has no bfloat16, so the file
holds the raw 16-bit patterns as ``uint16`` and the manifest records the
logical dtype ``bfloat16``; restore reinterprets the bits.  (The reference
widens such leaves to float32 instead.)  A leaf may also be a numpy array:
object-dtype leaves (pickled Python values — the serve recovery path's
token streams and actor states, which need exact scalar-type round-trips
for bit-identity) pass through np.save's pickle path and are never coerced,
and ``load_flat`` returns every leaf as stored.

Arrays are saved from host copies; ``restore`` places each leaf on the device
and in the dtype of the matching leaf of ``like``, and keeps its
``requires_grad``.  ``AsyncCheckpointer`` runs saves on a background thread.

Checkpoints are mesh-agnostic, as the reference's: a DTensor leaf is saved
gathered (every rank calls ``save``, which gathers; the rank 0 of the
default group writes, and the ranks meet at a barrier after it), and
``restore(..., shardings=)`` distributes each gathered leaf onto its ``(mesh,
placements)`` (``distributed/sharding.py::NamedSharding``), so a restart may
restore onto another mesh shape (the reference's ``remesh_restore``, run by
``distributed/fault.py::TrainSupervisor(shardings=)``).  Without
``shardings`` a DTensor leaf of ``like`` takes its own mesh and placements.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.pytree import tree_flatten, tree_map, tree_paths, tree_unflatten
from repro_torch.runtime import chaos as chaos_mod

PyTree = Any


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype)."""
    if isinstance(leaf, np.ndarray):
        return leaf, "object" if leaf.dtype == object else str(leaf.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _gathered(tree: PyTree) -> Tuple[PyTree, bool]:
    """(tree with every DTensor leaf gathered, whether it had one)."""
    sharded = any(isinstance(t, DTensor) for _, t in tree_paths(tree))
    if not sharded:
        return tree, False
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree), True


def _writes() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def save(
    ckpt_dir, step: int, tree: PyTree, *, extra: Optional[Dict] = None,
    keep: int = 3,
) -> Path:
    tree, sharded = _gathered(tree)
    if not sharded:
        return _save(ckpt_dir, step, tree, extra=extra, keep=keep)
    final = _save(ckpt_dir, step, tree, extra=extra, keep=keep) if _writes() else None
    dist.barrier()
    return final or Path(ckpt_dir) / f"step_{step}"


def _save(
    ckpt_dir, step: int, tree: PyTree, *, extra: Optional[Dict] = None,
    keep: int = 3,
) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    try:
        manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {}}
        for key, leaf in tree_paths(tree):
            chaos_mod.poke("ckpt:leaf")
            arr, logical_dtype = _to_numpy(leaf)
            fname = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": logical_dtype,
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        chaos_mod.poke("ckpt:commit")
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
    except BaseException:
        # torn write: no temp litter, and ``latest`` still names the previous
        # complete step
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    (ckpt_dir / "latest").write_text(str(step))  # updated last: commit point
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(
        int(p.name.split("_")[1])
        for p in ckpt_dir.glob("step_*")
        if p.name.split("_")[1].isdigit()
    )
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    marker = Path(ckpt_dir) / "latest"
    if not marker.exists():
        return None
    step = int(marker.read_text().strip())
    if not (Path(ckpt_dir) / f"step_{step}" / "manifest.json").exists():
        return None
    return step


def load_flat(ckpt_dir, step: int) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Raw flattened view of one step: ``{key path: stored array}`` plus the
    manifest ``extra`` dict.  No ``like`` tree needed — the serve recovery
    path reconstructs structure from its own metadata.  Arrays come back
    exactly as stored (a ``bfloat16`` leaf as its ``uint16`` bit
    patterns)."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {
        key: np.load(
            d / info["file"], allow_pickle=info["dtype"] == "object"
        )
        for key, info in manifest["leaves"].items()
    }
    return flat, manifest["extra"]


def restore(
    ckpt_dir, step: int, like: PyTree, *, shardings: Optional[PyTree] = None,
) -> Tuple[PyTree, Dict]:
    """Restore into the structure of ``like``: each leaf in the dtype of
    ``like``'s leaf, distributed onto its ``shardings`` entry when given (a
    tree of ``(mesh, placements)`` pairs), else onto a DTensor leaf's own
    mesh and placements, else on the device of ``like``'s leaf."""
    from repro_torch.distributed.sharding import is_sharding

    flat_sh = (tree_flatten(shardings, is_leaf=is_sharding)[0] if shardings is not None
               else [None] * len(tree_paths(like)))
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for (key, want), sh in zip(tree_paths(like), flat_sh):
        info = manifest["leaves"].get(key)
        assert info is not None, f"checkpoint missing leaf {key}"
        got = _from_numpy(np.load(d / info["file"]), info["dtype"])
        assert tuple(got.shape) == tuple(want.shape), (key, got.shape, want.shape)
        if sh is None and isinstance(want, DTensor):
            sh = (want.device_mesh, want.placements)
        if sh is not None:
            mesh, placements = sh
            dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
                if mesh.device_type == "cuda" else torch.device(mesh.device_type)
            got = distribute_tensor(got.to(device=dev, dtype=want.dtype), mesh, placements)
        else:
            got = got.to(device=want.device, dtype=want.dtype)
        out.append(got.requires_grad_(want.requires_grad))
    return tree_unflatten(tree_flatten(like)[1], out), manifest["extra"]


class AsyncCheckpointer:
    """Background checkpoint writer: save() returns once the tree is copied to
    the host; wait() drains pending saves.  A background save's failure is
    re-raised on the next ``save()`` or ``wait()``."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._sharded = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                _save(self.ckpt_dir, step, tree, extra=extra, keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — re-raised on save/wait
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None) -> None:
        """Copy the tree to the host (a DTensor leaf gathered here, on the
        caller's thread, by every rank) and queue the write (rank 0's only,
        for a sharded tree)."""
        self._raise_pending()
        tree, sharded = _gathered(tree)
        self._sharded |= sharded
        host = tree_map(lambda a: a.detach().to("cpu", copy=True), tree)
        if not sharded or _writes():
            self._q.put((step, host, extra))

    def wait(self) -> None:
        """Drain pending saves; after a sharded save the ranks meet at a
        barrier, so that every rank sees the writes of rank 0."""
        self._q.join()
        self._raise_pending()
        if self._sharded:
            dist.barrier()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join(timeout=5)
