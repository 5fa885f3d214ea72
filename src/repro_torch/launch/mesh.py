"""Device meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

A ``Mesh`` names the axes of the data-parallel grid, e.g.
``("pod", "data", "model")`` of shape (2, 2, 2), over a
``torch.distributed.device_mesh.DeviceMesh``. Global ranks lie on the mesh in
row-major order, so a rank's local rank along an axis equals JAX's
``axis_index`` of the same device in the reference's ``make_mesh(shape,
names)``, and
``group(axis)`` lists its members in that order. A mesh whose axes are all
of size 1 needs no process group.

The mesh builds its ``DeviceMesh`` (``device_mesh``) whenever a process
group is up, a one-rank group included: that is what DTensor placements
(``sharding/specs.py``) and the sharded runtime run on. With no group and
size 1, ``device_mesh`` is None and every caller takes its single-device
path. Any axis names work (``"pipe"`` for ``train/pipeline.py``).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``. When
the default process group is not up yet, ``Mesh`` starts it from the
environment that ``torchrun`` sets; tests start it themselves (a
``file://`` store) before building a ``Mesh``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def backend_for(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


class Mesh:
    """Named axis sizes, this rank's coordinates and one process group per
    axis."""

    def __init__(self, shape: tuple[int, ...], names: tuple[str, ...],
                 device: torch.device | str = "cuda"):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} does not match axes {names}")
        self.shape = dict(zip(names, shape))
        self.names = tuple(names)
        self.device = torch.device(device)
        self.size = math.prod(shape)
        self._dm = None
        if self.size > 1 or dist.is_initialized():
            from torch.distributed.device_mesh import init_device_mesh

            if not dist.is_initialized():
                dist.init_process_group(backend_for(self.device))
            if dist.get_world_size() != self.size:
                raise ValueError(f"mesh {shape} needs {self.size} ranks, the "
                                 f"process group has {dist.get_world_size()}")
            self._dm = init_device_mesh(self.device.type, tuple(shape),
                                        mesh_dim_names=tuple(names))

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` (None on a group-less one-rank mesh)."""
        return self._dm

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def local_rank(self, axis: str) -> int:
        """This rank's index along ``axis`` (JAX's ``axis_index``)."""
        if self.axis_size(axis) == 1:
            return 0
        return self._dm.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self._dm.get_group(axis)

    def block_index(self, axes: tuple[str, ...]) -> int:
        """This rank's block when a dim is split over ``axes``, the first
        axis major (a ``PartitionSpec((axes...))`` dim)."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.local_rank(a)
        return idx


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh over the current process group (in a dry run, a
    fake one of 256 or 512 ranks): (16, 16) ("data", "model"), or with
    ``multi_pod`` (2, 16, 16) ("pod", "data", "model"), the "pod" axis the
    slow links between pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Mesh:
    return Mesh(tuple(shape), tuple(axes), device)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(mesh.shape)


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """``"DATAxMODEL[xPOD]"`` -> (shape, axis names), as the reference's
    train driver reads ``--mesh``: ``("pod", "data", "model")`` when there is
    a pod axis, else ``("data", "model")``."""
    dims = [int(x) for x in spec.split("x")]
    while len(dims) < 3:
        dims.append(1)
    data, model, pods = dims
    if pods > 1:
        return (pods, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")

