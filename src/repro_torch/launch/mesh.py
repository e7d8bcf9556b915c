"""Mesh construction (port of ``repro/launch/mesh.py``).

``make_test_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with the axes
``("data", "model")`` over the ranks of the default process group, with the
reference's factorisation of the device count; it raises where no process
group exists (it never creates one).  The mesh lies on the group's device:
``cuda`` under NCCL, ``cpu`` under gloo.

``make_production_mesh`` returns an :class:`AbstractMesh` of the reference's
production shape: 256 or 512 ranks cannot be made here, just as the reference
builds its production mesh over fake devices.  The spec functions of
``distributed/sharding.py`` take an ``AbstractMesh`` and a ``DeviceMesh``
alike.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


class AbstractMesh:
    """A mesh's axis names and sizes, with no ranks behind it: ``.shape`` is
    an ordered ``{name: size}`` mapping, ``.axis_names`` the names in order."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"AbstractMesh: shape {tuple(shape)} against names "
                             f"{tuple(axis_names)}")
        self.shape = OrderedDict(zip(axis_names, (int(s) for s in shape)))
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self) -> str:
        return f"AbstractMesh({dict(self.shape)})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_test_mesh() -> DeviceMesh:
    """``(d, n // d)`` mesh ``("data", "model")`` over the ``n`` ranks of the
    default process group, ``d`` the largest divisor of ``n`` not above
    ``sqrt(n)``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_test_mesh: no torch.distributed process group; call "
            "torch.distributed.init_process_group first (one rank is enough)"
        )
    n = dist.get_world_size()
    d = int(np.sqrt(n))
    while n % d:
        d -= 1
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (d, n // d), mesh_dim_names=("data", "model"))
