"""Meshes and ray shardings over ``torch.distributed`` (port of
``nerfca_tpu/parallel/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
process group's ranks, one device per rank, with the named axis
``'data'`` (or ``('data', 'depth')``). A sharding is this rank's slice of
the leading (ray) axis along one mesh axis; parameters are replicated:
every rank holds the same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None, device: str = "cuda") -> DeviceMesh:
    """A mesh over the first ``n_devices`` ranks (default: the world) of
    the initialized process group (``multihost.initialize``), 1-D
    ``('data',)`` unless ``shape``/``axis_names`` give a 2-D layout.
    ``device`` is ``"cuda"`` (each rank on card ``rank % cards``, chosen
    here before the mesh exists) or ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(nerfca_tpu_torch.parallel.multihost.initialize)")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else n_devices
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole world of {world} ranks, not {n_devices}")
    shape = tuple(shape) if shape is not None else (n_devices,)
    if len(shape) != len(axis_names) or torch.Size(shape).numel() != n_devices:
        raise ValueError(f"mesh shape {shape} for axes {tuple(axis_names)} over {n_devices} "
                         f"ranks")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device is available "
                               "(pass device='cpu' for a CPU mesh)")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    elif device != "cpu":
        raise ValueError(f"unknown mesh device {device!r}")
    return init_device_mesh(device, shape, mesh_dim_names=tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class RaySharding:
    """This rank's slice of the leading axis along mesh axis ``axis``: shard
    ``index`` of ``count``."""

    mesh: DeviceMesh
    axis: str
    index: int
    count: int

    def slice(self, n: int) -> slice:
        """Shard ``index`` of ``count`` equal ones (the sharded K3 entry's
        rule); raises ``ValueError`` when ``n`` does not split evenly."""
        if n % self.count:
            raise ValueError(f"{n} rays do not split evenly over {self.count} shards of "
                             f"'{self.axis}'")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def uneven_slice(self, n: int) -> slice:
        """Shard ``index`` of ``n`` rays in order, the first ``n % count``
        shards one ray longer (the autograd path, which takes any ``n`` as
        JAX's does under GSPMD); raises ``ValueError`` when a shard would
        hold no ray."""
        per, extra = divmod(n, self.count)
        if per == 0:
            raise ValueError(f"{n} rays leave a shard of '{self.axis}' empty ({self.count} "
                             f"shards)")
        start = self.index * per + min(self.index, extra)
        return slice(start, start + per + (self.index < extra))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along the named axis ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_sharding(mesh: DeviceMesh, axis: str = "data") -> RaySharding:
    """The sharding that splits the leading (ray) axis over ``axis``."""
    return RaySharding(mesh, axis, mesh.get_local_rank(axis), axis_size(mesh, axis))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` made equal on every rank of the mesh: the
    mesh's first rank's values, broadcast in place (tensors must be
    contiguous). Returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])  # the mesh spans the world

    def bcast(t):
        dist.broadcast(t.data, src=src)
        return t

    return _map(tree, bcast)


def shard_batch(mesh: DeviceMesh, tree, axis: str = "data"):
    """This rank's slice of the leading axis of every tensor in ``tree``."""
    sharding = batch_sharding(mesh, axis)
    return _map(tree, lambda t: t[sharding.slice(t.shape[0])])
