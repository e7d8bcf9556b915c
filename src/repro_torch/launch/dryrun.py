"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on meta DTensors
(port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step over 256 or 512 fake XLA
devices and reads the compiled program's memory analysis and HLO.  The port
traces the step eagerly instead: ``main`` starts a ``fake`` process group of
256 or 512 ranks (no process, no communication: this one is rank 0), the
production mesh is a ``DeviceMesh`` over it, every argument is a DTensor
whose local shard is a meta tensor (shapes and dtypes, no storage), and the
step runs under ``shard_ctx`` and :class:`~repro_torch.launch.hlo_analysis.
StepCounter`, which counts rank 0's local ops and collectives and the live
bytes of their results.  A sharding mismatch, an op with no meta kernel or
a placement DTensor cannot run is an error of the cell.  The trace runs the
``use_kernels="off"`` path (the reference's dry-run runs ``use_pallas="off"``
too): a meta tensor is no CUDA tensor, so the kernels' plain versions would
run anyway.

Result keys kept from the reference, with their meaning here:

* ``status`` (``ok`` | ``skip`` | ``error``), ``reason`` (a skip's, from
  ``cfg.cell_supported``), ``error`` and ``traceback`` (an error's);
* ``memory_analysis``: ``argument_size_in_bytes`` and
  ``output_size_in_bytes``, rank 0's local shard bytes of the step's
  arguments and results (exact sums); ``alias_size_in_bytes``, the bytes of
  results that are arguments' storage (the decode's cache, updated in
  place; the port donates nothing else: a training step holds old and new
  parameters and moments together); ``temp_size_in_bytes``, the peak of
  live local bytes during the step less the arguments (results included);
* ``analyzed``: :func:`~repro_torch.launch.hlo_analysis.stats_dict` of the
  counted step (``flops_by_op`` beside it: its FLOPs per aten op);
* ``model_flops_global`` (6ND for training, 2ND otherwise),
  ``params_total``, ``params_active``;
* ``t_trace_s``: the trace's seconds (the reference's ``t_lower_s``).

Reference keys with no counterpart: ``xla_cost_flops`` and
``xla_cost_bytes`` (XLA's own once-counted cost analysis),
``t_compile_s`` (nothing is compiled), ``hlo_lines`` and
``collectives_naive`` (no HLO text), and ``generated_code_size_in_bytes``.

:func:`analyze_cell` takes a config, a cell and a mesh or ``None`` (the
unsharded step, no process group needed) and returns the same dict.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all            # every cell
  ... [--multi-pod | --both-meshes] [--out artifacts/dryrun]
      [--set batch_chunks=8] [--rule seq=None]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import SHAPE_CELLS, get_config, list_archs
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.distributed.sharding import (
    local_shape, make_rules, shard_ctx, to_placements,
)
from repro_torch.launch.hlo_analysis import StepCounter, stats_dict, tensor_bytes
from repro_torch.launch.steps import cell_specs, specs_to_pspecs
from repro_torch.pytree import tree_flatten, tree_unflatten

POD_SIZE = 256  # ranks a pod: a collective across two counts as DCN


def mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextmanager
def fake_world(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool) -> DeviceMesh:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``, over the default process
    group, which must have that many ranks (:func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"production_mesh({mesh_tag(multi_pod)}): needs a process group of {n} ranks "
            f"(run under fake_world({n}))"
        )
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def place_meta(specs: Any, logical: Any, mesh: DeviceMesh, rules) -> Any:
    """Each meta leaf as a DTensor on ``mesh`` at the placements its
    logical axes give, its local shard a meta tensor of the shard's shape
    (a scalar stays a plain tensor, whole on every rank, as the step
    counter of ``init_opt_state`` and the decode position are)."""
    leaves, treedef = tree_flatten(specs)
    pspecs = tree_flatten(specs_to_pspecs(specs, logical, mesh, rules),
                          is_leaf=lambda x: isinstance(x, tuple))[0]

    def one(t, spec):
        if t.dim() == 0:  # a scalar stays plain, as init_opt_state's step counter
            return t
        pl = to_placements(spec, mesh)
        local = torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype, device="meta")
        d = DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                               stride=t.stride())
        return d.requires_grad_(t.requires_grad)

    return tree_unflatten(treedef, [one(t, s) for t, s in zip(leaves, pspecs)])


def _storages(tree: Any) -> Dict[int, Any]:
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = (t.to_local() if isinstance(t, DTensor) else t).untyped_storage()
            out[id(st)] = st
    return out


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """6ND for a train cell, 2ND for prefill and decode (N active params)."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = {"train": 3.0, "prefill": 1.0, "decode": 1.0}[cell.kind]
    return 2.0 * cfg.param_counts()["active"] * tokens * mult


def analyze_cell(cfg: ModelConfig, cell: ShapeCell, mesh: Optional[DeviceMesh] = None,
                 rule_overrides=None) -> Dict[str, Any]:
    """Trace ``cfg``'s step for ``cell`` on meta tensors, unsharded
    (``mesh=None``) or placed on ``mesh`` under ``make_rules(cfg, mesh,
    rule_overrides)``, and return the result dict of the module docstring
    (``status: ok``; an error raises)."""
    cfg = dataclasses.replace(cfg, use_kernels="off")
    step, args, logical = cell_specs(cfg, cell)
    rules = None
    if mesh is not None:
        rules = make_rules(cfg, mesh, rule_overrides)
        args = tuple(place_meta(a, lg, mesh, rules) for a, lg in zip(args, logical))
    counter = StepCounter(POD_SIZE)
    counter.hold(args)
    arg_bytes = tensor_bytes(args)
    t0 = time.perf_counter()
    with counter, (shard_ctx(mesh, rules) if mesh is not None else nullcontext()):
        out = step(*args)
    t_trace = time.perf_counter() - t0
    arg_st = _storages(args)
    aliased = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)
               and id((t.to_local() if isinstance(t, DTensor) else t).untyped_storage()) in arg_st]
    pc = cfg.param_counts()
    return {
        "status": "ok",
        "t_trace_s": round(t_trace, 2),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": tensor_bytes(out),
            "temp_size_in_bytes": counter.peak_bytes - arg_bytes,
            "alias_size_in_bytes": tensor_bytes(aliased),
        },
        "analyzed": stats_dict(counter.stats),
        "flops_by_op": counter.flops_by_op,
        "model_flops_global": model_flops(cfg, cell),
        "params_total": pc["total"],
        "params_active": pc["active"],
    }


def run_cell(arch: str, shape: str, multi_pod: bool, rule_overrides=None,
             cfg_overrides=None) -> Dict[str, Any]:
    """One production cell over the default process group (256 or 512
    ranks, :func:`fake_world`)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPE_CELLS[shape]
    ok, why = cfg.cell_supported(cell)
    result = {"arch": arch, "shape": shape, "mesh": mesh_tag(multi_pod),
              "multi_pod": multi_pod}
    if not ok:
        result.update(status="skip", reason=why)
        return result
    result.update(analyze_cell(cfg, cell, production_mesh(multi_pod), rule_overrides))
    return result


def _parse_value(v: str):
    if v.lstrip("-").isdigit():
        return int(v)
    try:
        return float(v)
    except ValueError:
        return v


def parse_overrides(sets, rules):
    """``--set k=v`` and ``--rule k=v`` lists -> (cfg_overrides, rule_overrides)."""
    cfg_over = {}
    for s in sets:
        k, v = s.split("=", 1)
        cfg_over[k] = _parse_value(v)
    rule_over = {}
    for s in rules:
        k, v = s.split("=", 1)
        rule_over[k] = None if v in ("None", "none") else (
            tuple(v.split(",")) if "," in v else v)
    return cfg_over or None, rule_over or None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help="config override k=v")
    ap.add_argument("--rule", action="append", default=[], dest="rules",
                    help="sharding-rule override k=v (None, an axis, or a,b)")
    args = ap.parse_args(argv)
    cfg_over, rule_over = parse_overrides(args.sets, args.rules)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPE_CELLS) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = 0
    for mp in meshes:
        with fake_world(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}__{mesh_tag(mp)}"
                    path = outdir / f"{tag}.json"
                    if path.exists():
                        print(f"[cached] {tag}")
                        continue
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        res = run_cell(arch, shape, mp, rule_over, cfg_over)
                    except Exception as e:  # noqa: BLE001 - recorded in the cell's file
                        res = {
                            "arch": arch, "shape": shape, "mesh": mesh_tag(mp),
                            "status": "error",
                            "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc()[-4000:],
                        }
                        failures += 1
                    path.write_text(json.dumps(res, indent=1))
                    status = res["status"]
                    extra = ""
                    if status == "ok":
                        mem = res["memory_analysis"]
                        a = res["analyzed"]
                        extra = (
                            f" flops/dev={a['flops']:.3e}"
                            f" coll/dev={a['collective_bytes']:.3e}B"
                            f" (ici={a['ici_bytes']:.3e} dcn={a['dcn_bytes']:.3e})"
                            f" args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB"
                            f" temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB"
                            f" trace={res['t_trace_s']}s"
                        )
                    print(f"[{status}] {tag}{extra}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
