"""Multi-rank cases of the port's sharding tests, run over gloo on the CPU.

``spawn(tmp_path, case, world, args)`` starts ``world`` processes of this
module (a ``FileStore`` under ``tmp_path``, every process group with a 60 s
collective time limit, the whole spawn joined within ``JOIN_SECONDS``) and
returns each rank's results (``{name: array}``).  The rank side imports only
``torch`` and ``repro_torch``; the tests compare its results with the JAX
package in their own process.  A rank that raises fails the spawn with
every rank's log.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "src"
JOIN_SECONDS = 300
COLLECTIVE_SECONDS = 60


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


def spawn(tmp_path: Path, case: str, world: int, args: dict):
    """Run ``case`` on ``world`` gloo ranks; returns a list of per-rank
    result dicts."""
    tmp_path = Path(tmp_path)
    work = tmp_path / case
    work.mkdir(parents=True, exist_ok=True)
    (work / "args.json").write_text(json.dumps(args))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), str(Path(__file__).resolve().parent)]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch_ranks", case, str(r), str(world), str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_SECONDS)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world, "\n".join(
        log[-4000:] for log in logs)
    return [dict(np.load(work / f"out{r}.npz")) for r in range(world)]


def save_tree(path: Path, flat: dict) -> str:
    """Write ``{key path: array}`` for a rank to read with :func:`load_tree`."""
    np.savez(path, **{k.replace("/", "|"): v for k, v in flat.items()})
    return str(path)


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------


def load_tree(path: str) -> dict:
    """The nested dict of numpy arrays saved by :func:`save_tree`."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            *head, last = key.split("|")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = data[key]
    return out


def _cfg(run: dict):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(run["arch"]).reduced(), dtype="float32",
                               param_dtype="float32", **run.get("extra", {}))


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def _loss_grads(params, cfg, batch):
    import torch

    from repro_torch.model import lm
    from repro_torch.pytree import tree_paths

    keys, leaves = zip(*tree_paths(params))
    loss, _ = lm.lm_loss(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves))
    return loss, dict(zip(keys, grads))


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy()


def case_train(rank, world, args, res):
    """Each run: the port's loss and gradients unsharded and under
    ``shard_ctx(mesh, make_rules(...))``, and one AdamW step of each."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.model import lm
    from repro_torch.model.convert import params_from_numpy
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.pytree import tree_paths

    mesh = _mesh(args["mesh"])
    opt = OptConfig()
    for run in args["runs"]:
        name, cfg = run["name"], _cfg(run)
        params = params_from_numpy(load_tree(run["params"]), cfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in load_tree(run["batch"]).items()}
        loss, grads = _loss_grads(params, cfg, batch)
        rules = sh.make_rules(cfg, mesh)
        sparams = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
        with sh.shard_ctx(mesh, rules):
            sbatch = {k: sh.distribute_tensor(v, mesh, sh.ctx_placements(("batch", "seq"), v.shape))
                      for k, v in batch.items()}
            sloss, sgrads = _loss_grads(sparams, cfg, sbatch)
        res[f"{name}/loss/port"] = _full(loss)
        res[f"{name}/loss/sharded"] = _full(sloss)
        for k in grads:
            res[f"{name}/grad/{k}/port"] = _full(grads[k])
            res[f"{name}/grad/{k}/sharded"] = _full(sgrads[k])
        if not run.get("step"):
            continue
        step = make_train_step(cfg, opt)
        new, _, m = step(params, init_opt_state(params, opt), batch)
        with sh.shard_ctx(mesh, rules):
            snew, sopt, sm = step(sparams, init_opt_state(sparams, opt), batch)
        assert all(isinstance(v, sh.DTensor) for _, v in tree_paths(sopt["m"]))
        for (k, p), (_, q) in zip(tree_paths(new), tree_paths(snew)):
            assert q.placements == dict(tree_paths(sparams))[k].placements, k
            res[f"{name}/step/{k}/port"] = _full(p)
            res[f"{name}/step/{k}/sharded"] = _full(q)
        res[f"{name}/grad_norm/port"] = _full(m["grad_norm"])
        res[f"{name}/grad_norm/sharded"] = _full(sm["grad_norm"])


def case_moe_groups(rank, world, args, res):
    """``moe_ffn`` at B*S > 4096 with the sequence on the model axis."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.model.moe import _seq_shards, moe_defs, moe_ffn
    from repro_torch.pytree import tree_map, tree_paths

    mesh = _mesh(args["mesh"])
    cfg = _cfg(args)
    p = tree_map(lambda a: torch.from_numpy(a).requires_grad_(), load_tree(args["params"]))
    x = torch.from_numpy(np.load(args["x"]))
    rules = sh.make_rules(cfg, mesh)
    sp = sh.place(p, sh.defs_shardings(moe_defs(cfg), mesh, rules))
    with sh.shard_ctx(mesh, rules):
        res["P"] = np.array(_seq_shards(x.shape[1]))
        sx = sh.distribute_tensor(x, mesh, sh.ctx_placements(("batch", "seq", None), x.shape))
        y, aux = moe_ffn(sp, sx, cfg)
        loss = torch.sum(y * y) + aux["moe_balance"]
        keys, leaves = zip(*tree_paths(sp))
        grads = torch.autograd.grad(loss, list(leaves))
    res["y"] = _full(y)
    res["balance"] = _full(aux["moe_balance"])
    res["zloss"] = _full(aux["moe_zloss"])
    for k, g in zip(keys, grads):
        res[f"grad/{k}"] = _full(g)


def case_generate(rank, world, args, res):
    """Greedy tokens of ``make_generate(cfg, mesh, rules)`` and without a
    mesh."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.serve import make_generate
    from repro_torch.model import lm

    meshes = {tuple(m): _mesh(m) for m in {tuple(r["mesh"]) for r in args["runs"]}}
    for run in args["runs"]:
        mesh = meshes[tuple(run["mesh"])]
        cfg = _cfg(run)
        params = lm.init_model(cfg, 0, device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(1).integers(
            3, cfg.vocab_size, (4, 16)).astype(np.int64))
        ref, n = make_generate(cfg, None, None, max_new=8, eos_id=-1)(params, prompts)
        got, m = make_generate(cfg, mesh, sh.make_rules(cfg, mesh), max_new=8, eos_id=-1)(
            params, prompts)
        res[f"{run['name']}/port"] = ref.numpy()
        res[f"{run['name']}/sharded"] = got.numpy()
        res[f"{run['name']}/steps"] = np.array([n, m])


def case_decode(rank, world, args, res):
    """Teacher-forced decode steps after a prefill, unsharded and under
    ``shard_ctx(mesh, make_rules(...))``: every step's logits (gathered),
    the final cache, and how many ways the attention cache's sequence is
    split.  Odd positions are scalars, even ones per-slot (B,) vectors."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.serve import prefill_cache
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.model import lm
    from repro_torch.model.convert import params_from_numpy
    from repro_torch.pytree import tree_paths

    S0, S = args["S0"], args["S"]
    meshes = {tuple(m): _mesh(m) for m in {tuple(r["mesh"]) for r in args["runs"]}}
    for run in args["runs"]:
        name, mesh, cfg = run["name"], meshes[tuple(run["mesh"])], _cfg(run)
        params = params_from_numpy(load_tree(run["params"]), cfg, device="cpu")
        tokens = torch.from_numpy(np.load(run["tokens"]))
        B = tokens.shape[0]
        rules = sh.make_rules(cfg, mesh)
        sparams = sh.place(params, sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
        step = make_decode_step(cfg)
        _, cache = prefill_cache(params, cfg, tokens[:, :S0], S)
        with sh.shard_ctx(mesh, rules):
            prompt = sh.distribute_tensor(tokens[:, :S0], mesh,
                                          sh.ctx_placements(("batch", "seq"), (B, S0)))
            _, scache = prefill_cache(sparams, cfg, prompt, S)
        logs, slogs = [], []
        for i in range(S0, S):
            pos = i if i % 2 else torch.full((B,), i, dtype=torch.int32)
            log, cache = step(params, cache, tokens[:, i], pos)
            with sh.shard_ctx(mesh, rules):
                slog, scache = step(sparams, scache, sh.replicate(tokens[:, i]), pos)
            logs.append(_full(log))
            slogs.append(_full(slog))
        res[f"{name}/port"], res[f"{name}/sharded"] = np.stack(logs), np.stack(slogs)
        for (k, c), (_, sc) in zip(tree_paths(cache), tree_paths(scache)):
            res[f"{name}/cache/{k}/port"], res[f"{name}/cache/{k}/sharded"] = _full(c), _full(sc)
            if k.endswith("/k"):  # (layers, B, S, kv, hd): the sequence is dim 2
                res[f"{name}/kv_seq_ways"] = np.array(int(np.prod(
                    [mesh.size(j) for j, p in enumerate(sc.placements)
                     if isinstance(p, sh.Shard) and p.dim == 2])))


def case_int8(rank, world, args, res):
    """``all_reduce_int8(x, "data")`` on this rank's shard."""
    import torch

    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.compression import all_reduce_int8

    mesh = _mesh(args["mesh"])
    data = np.load(args["x"])
    with sh.shard_ctx(mesh, {}):
        res["out"] = all_reduce_int8(torch.from_numpy(data[rank]), "data",
                                     use_kernels="cuda").numpy()
    res["coord"] = np.array([mesh.get_local_rank(i) for i in range(mesh.ndim)])


def case_restore(rank, world, args, res):
    """Save the smollm parameters placed on one mesh, restore them onto
    another (``restore(shardings=)`` and ``TrainSupervisor(shardings=)``)."""
    import torch

    from repro_torch.checkpoint import restore, save
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.fault import TrainSupervisor
    from repro_torch.model import lm
    from repro_torch.pytree import tree_paths

    src = _mesh(args["from"])
    dst = _mesh(args["to"])
    cfg = _cfg(args)
    params = lm.init_model(cfg, 0, device="cpu")
    defs = lm.model_defs(cfg)
    placed = sh.place(params, sh.defs_shardings(defs, src, sh.make_rules(cfg, src)))
    save(args["dir"], 3, placed)
    target = sh.defs_shardings(defs, dst, sh.make_rules(cfg, dst))
    got, _ = restore(args["dir"], 3, params, shardings=target)
    sup = TrainSupervisor(lambda s, i: (s, {}), lambda: params, args["dir"], shardings=target)
    again, step = sup._restore_or_init()
    sup.ckpt.close()
    want = sh.place(params, target)
    same = []
    for (k, w), (_, g), (_, a) in zip(tree_paths(want), tree_paths(got), tree_paths(again)):
        assert g.placements == w.placements and a.placements == w.placements, k
        same.append(torch.equal(g.to_local(), w.to_local()) and torch.equal(a.to_local(),
                                                                            w.to_local()))
    res["bitwise"] = np.array(same)
    res["step"] = np.array(step)
    res["leaves"] = np.array(len(same))


def case_pipeline(rank, world, args, res):
    """``gpipe_apply`` of the tanh stages over a (4,) ``stage`` mesh (again
    forward and backward with the host-staging rule recorded as it
    decides), and the reduced smollm's blocks in 4 stages against the
    sequential forward, values and gradients."""
    import torch

    from repro_torch.distributed import pipeline
    from repro_torch.distributed.pipeline import gpipe_apply, stack_stage_params
    from repro_torch.model import lm
    from repro_torch.model.blocks import block_fwd

    mesh = _mesh((world,), ("stage",))
    data = np.load(args["tanh"])
    per_stage = [{"w": torch.from_numpy(data["w"][i]), "b": torch.from_numpy(data["b"][i])}
                 for i in range(world)]
    params = stack_stage_params(per_stage)
    x = torch.from_numpy(data["x"])
    res["tanh"] = gpipe_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), params, x,
                              mesh=mesh, axis="stage").numpy()

    # the same pipeline forward and backward, with the staging rule
    # recorded at every hop and masked sum
    decided = []
    on_host = pipeline._on_host

    def recorded(t, group):
        decided.append(on_host(t, group))
        return decided[-1]

    try:
        pipeline._on_host = recorded
        xg = x.clone().requires_grad_(True)
        y = gpipe_apply(lambda p, v: torch.tanh(v @ p["w"] + p["b"]), params, xg,
                        mesh=mesh, axis="stage")
        torch.autograd.grad(torch.sum(y * y), xg)
    finally:
        pipeline._on_host = on_host
    res["staged/y"], res["staged/decided"] = y.detach().numpy(), np.array(decided)

    cfg = _cfg({"arch": "smollm-135m", "extra": {"num_layers": 8}})
    model = lm.init_model(cfg, 0, device="cpu")
    B, S, n_micro = 8, 64, 4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    x = torch.nn.functional.embedding(tokens, model["embed"]["tok"].detach()).float()
    positions = torch.arange(S, dtype=torch.int32)
    kind = cfg.block_kind(0)
    layer_p = model["layers"]["pos0"]  # leaves (num_layers, ...)
    per = cfg.num_layers // world
    stage_params = {k: {kk: vv.reshape(world, per, *vv.shape[1:]) for kk, vv in v.items()}
                    for k, v in layer_p.items()}

    def stage_fn(pstage, xin):
        for j in range(per):
            pj = {k: {kk: vv[j] for kk, vv in v.items()} for k, v in pstage.items()}
            xin, _, _ = block_fwd(pj, xin, kind, cfg, positions)
        return xin

    y = gpipe_apply(stage_fn, stage_params, x.reshape(n_micro, B // n_micro, S, cfg.d_model),
                    mesh=mesh, axis="stage").reshape(B, S, cfg.d_model)
    ref = x
    for i in range(cfg.num_layers):
        pi = {k: {kk: vv[i] for kk, vv in v.items()} for k, v in layer_p.items()}
        ref, _, _ = block_fwd(pi, ref, kind, cfg, positions)
    w = layer_p["mixer"]["wq"]
    res["lm"], res["lm_ref"] = y.detach().numpy(), ref.detach().numpy()
    res["lm_grad"] = torch.autograd.grad(torch.sum(y * y), w)[0].numpy()
    res["lm_grad_ref"] = torch.autograd.grad(torch.sum(ref * ref), w)[0].numpy()


def case_dryrun(rank, world, args, res):
    """Each run and mesh: the reduced training step of a shape cell on real
    tensors placed as the dry-run places its meta ones, under
    ``StepCounter``: this rank's FLOPs and collectives per kind."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.hlo_analysis import COLLECTIVES, StepCounter
    from repro_torch.launch.steps import cell_specs, specs_to_pspecs
    from repro_torch.model import lm
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.pytree import tree_flatten, tree_unflatten

    cell = ShapeCell(*args["cell"])
    for shape in args["meshes"]:
        mesh = _mesh(shape)
        for arch in args["archs"]:
            cfg = dataclasses.replace(get_config(arch).reduced(), use_kernels="off")
            rules = sh.make_rules(cfg, mesh)
            step, specs, logical = cell_specs(cfg, cell)
            params = sh.place(lm.init_model(cfg, 0, device="cpu"),
                              sh.defs_shardings(lm.model_defs(cfg), mesh, rules))
            opt = init_opt_state(params, OptConfig())
            rng = np.random.default_rng(0)
            leaves, treedef = tree_flatten(specs[2])
            pspecs = tree_flatten(specs_to_pspecs(specs[2], logical[2], mesh, rules),
                                  is_leaf=lambda x: isinstance(x, tuple))[0]
            batch = tree_unflatten(treedef, [sh.distribute_tensor(
                torch.from_numpy(rng.integers(0, cfg.vocab_size, t.shape).astype(np.int32)),
                mesh, sh.to_placements(p, mesh)) for t, p in zip(leaves, pspecs)])
            counter = StepCounter()
            with counter, sh.shard_ctx(mesh, rules):
                step(params, opt, batch)
            tag = f"{arch}/{shape[0]}x{shape[1]}"
            st = counter.stats
            res[f"{tag}/flops"] = np.array(st.flops)
            for kind in COLLECTIVES:
                res[f"{tag}/{kind}/count"] = np.array(st.coll[kind]["count"])
                res[f"{tag}/{kind}/bytes"] = np.array(st.coll[kind]["bytes"])


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main(argv):
    import torch.distributed as dist

    case, rank, world, work = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    args = json.loads((work / "args.json").read_text())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_SECONDS))
    try:
        res: dict = {}
        CASES[case](rank, world, args, res)
        np.savez(work / f"out{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
