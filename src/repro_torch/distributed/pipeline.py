"""Pipeline parallelism: a GPipe-style microbatch pipeline over a mesh axis
(port of ``repro/distributed/pipeline.py``).

The stage axis is a dim of a ``DeviceMesh`` (e.g. ``"stage"``); stage
parameters are stacked on a leading dim, one slice per rank of that axis.
Each tick every stage computes its microbatch and the activations move one
hop to the next stage (``dist.batch_isend_irecv`` over the axis' process
group, the reference's ``lax.ppermute``: stage 0 receives zeros).  A
schedule of ``n_micro + n_stages - 1`` ticks drains the pipe; stage 0 reads
microbatch ``clip(t)``, and the last stage's outputs are summed over the
axis with every other stage's masked to zeros (the reference's masked
``psum``), so every rank of the axis returns them.  The exchange and the sum
are differentiable: the backward sends each cotangent one hop back, and
the outputs' cotangent (one value every rank holds) reaches the last stage
once.

Where the axis' group is gloo and a tensor lies on a CUDA card, the hops
and the masked sum go through host memory (``_on_host``): the tensor is
copied to the host, sent or reduced there and copied back to its device.
gloo carries no CUDA point-to-point and NCCL refuses two ranks on one card,
so this is how several stages share one card
(``examples/pipeline_lm_torch.py`` runs four on one H100): host-staged
hops on one card, not a multi-card pipeline.  The stage compute never
leaves the card; with NCCL, or with tensors on the CPU, nothing is staged.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.pytree import tree_map

PyTree = Any


def stack_stage_params(per_stage: list) -> PyTree:
    """Stack a list of per-stage param pytrees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage)


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether a collective on ``x`` over ``group`` is staged through host
    memory: a CUDA tensor over a gloo group."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _shift(x: torch.Tensor, group, stage: int, n_stages: int, forward: bool) -> torch.Tensor:
    """Send ``x`` one stage on (``forward``) or back and return what arrives
    from the other side (zeros at the end that has no neighbour there)."""
    dev = x.device
    if _on_host(x, group):
        x = x.cpu()
    ranks = dist.get_process_group_ranks(group)
    dst, src = (stage + 1, stage - 1) if forward else (stage - 1, stage + 1)
    got = torch.zeros_like(x)
    ops = []
    if 0 <= dst < n_stages:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[dst], group))
    if 0 <= src < n_stages:
        ops.append(dist.P2POp(dist.irecv, got, ranks[src], group))
    for req in dist.batch_isend_irecv(ops) if ops else []:
        req.wait()
    return got.to(dev)


class _Hop(torch.autograd.Function):
    """The ppermute ``[(i, i + 1)]``; its transpose sends the cotangent back."""

    @staticmethod
    def forward(ctx, x, group, stage: int, n_stages: int):
        ctx.args = (group, stage, n_stages)
        return _shift(x, group, stage, n_stages, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.args, forward=False), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's value on every rank of the axis: a sum over the axis
    with the other stages' values masked to zeros.  The result is one value
    held by every rank, so its cotangent goes back to the last stage once
    (not summed over the ranks' copies)."""

    @staticmethod
    def forward(ctx, x, group, last: bool):
        ctx.last = last
        dev = torch.device("cpu") if _on_host(x, group) else x.device
        out = x.to(dev, copy=True) if last else torch.zeros_like(x, device=dev)
        dist.all_reduce(out, group=group)
        return out.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def gpipe_apply(
    stage_fn: Callable[[PyTree, torch.Tensor], torch.Tensor],
    stage_params: PyTree,  # leaves: (n_stages, ...), Shard(0) on `axis` or whole
    x_micro: torch.Tensor,  # (n_micro, mb, ...) inputs to stage 0
    *,
    mesh: DeviceMesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run the pipeline; returns (n_micro, mb, ...) outputs of the last stage.

    ``stage_params`` leaves are DTensors split on their leading dim over
    ``axis`` (each rank reads its local slice) or whole stacked tensors
    (each rank takes its stage's slice); ``x_micro`` is the same on every
    rank of the axis (a DTensor is taken as its full value)."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(dim)
    stage = mesh.get_local_rank(dim)
    n_micro = x_micro.shape[0]
    assert n_micro >= 1
    ticks = n_micro + n_stages - 1
    sharded_in = isinstance(x_micro, DTensor)
    xm = x_micro.full_tensor() if sharded_in else x_micro

    def local(a):
        if isinstance(a, DTensor):
            return a.to_local()[0]  # this stage's slice
        return a[stage]

    p_local = tree_map(local, stage_params)
    buf = torch.zeros(xm.shape[1:], dtype=xm.dtype, device=xm.device)
    first = torch.tensor(stage == 0, device=xm.device)
    ys = []
    for t in range(ticks):
        src = xm[min(max(t, 0), n_micro - 1)]
        # a select, as the reference's: the received buffer stays on the
        # autograd path of every stage, so that every rank takes part in
        # every backward hop
        inp = torch.where(first, src, buf)
        y = stage_fn(p_local, inp)
        buf = _Hop.apply(y, group, stage, n_stages)
        ys.append(y)
    # last stage's outputs live at ticks [n_stages-1, ticks)
    outs = torch.stack(ys[n_stages - 1:])
    # replicate the last stage's result across the stage axis
    outs = _FromLast.apply(outs, group, stage == n_stages - 1)
    if sharded_in:
        return DTensor.from_local(outs, x_micro.device_mesh, x_micro.placements, run_check=False)
    return outs


def pipeline_bubble_fraction(n_micro: int, n_stages: int) -> float:
    """GPipe bubble overhead: (S-1) / (M + S - 1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
