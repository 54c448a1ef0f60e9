"""Autograd collectives over one mesh axis: what GSPMD does for the JAX
step under ``batch_sharding`` (``nerfca_tpu/train/step.py:673-677``),
written out for ranks that each hold a slice of the rays.

The JAX step computes the GLOBAL loss of the whole batch. Here every rank
computes its slice's PARTIAL of that loss (ray means divided by the global
ray count, ``ops/losses.py::ray_mean``) and these functions join the
partials so that each rank holds the global value and backpropagates its
slice's share of the global gradient:

  - :func:`sum_partials`: the SUM of per-rank partials; its backward hands
    the cotangent on unchanged, because the global value is the sum of the
    partials. (``torch.distributed.nn.functional.all_gather`` backpropagates
    by a SUM over ranks: when every rank computes the same loss from the
    gathered vector, its gradient comes out ``world`` times too large.)
  - :func:`global_amax`: ``torch.amax`` of the global tensor from each
    rank's slice; its backward SUMs the ranks' cotangents and hands them to
    the elements equal to the global max, split among ties as ``torch.amax``
    splits them;
  - :func:`from_first_shard`: the value the axis's first rank holds (the
    one that owns global ray 0), on every rank; its backward SUMs the ranks'
    cotangents to that rank;
  - :func:`reduce_metrics` and :func:`all_reduce_grads`: one SUM (and one
    MAX) all-reduce of the detached metrics, and one SUM all-reduce of every
    gradient leaf flattened in a fixed order. Neither uses f32 atomics or
    bucketing, so every rank and every run gets the same bits.

Every rank must call these in the same order, forward and backward: the
ranks run the same graph on slices of one batch, so they do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the named mesh axis ``axis``; raises
    ``ValueError`` when the mesh has no such axis."""
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh's axes {mesh.mesh_dim_names} have no {axis!r} axis")
    return mesh.get_group(axis)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GlobalAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        top = torch.amax(x.detach())
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        mask = x.detach() == top
        count = mask.sum()
        dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
        ctx.group = group
        ctx.save_for_backward(mask, count)
        return top

    @staticmethod
    def backward(ctx, g):
        mask, count = ctx.saved_tensors
        g = g.detach().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        # torch.amax's own backward: (g / count) * mask over the tied elements
        return (g / count) * mask, None


class _FromFirstShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src: int):
        y = x.detach().clone().contiguous()
        dist.broadcast(y, src=src, group=group)
        ctx.group, ctx.owner = group, dist.get_rank() == src
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone().contiguous()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return (g if ctx.owner else torch.zeros_like(g)), None, None


def sum_partials(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The SUM over the ranks of ``axis`` of each rank's partial ``x``,
    equal on every rank; differentiable, the cotangent passed through."""
    return _SumPartials.apply(x, axis_group(mesh, axis))


def global_amax(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """``torch.amax`` over the union of every rank's ``x`` (each rank's
    slice, at least one element), equal on every rank; differentiable into
    the slice or slices that hold the maximum."""
    return _GlobalAmax.apply(x, axis_group(mesh, axis))


def from_first_shard(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The first rank of ``axis``'s ``x`` on every rank (``x`` of the same
    shape and type everywhere); differentiable into that rank's ``x``."""
    group = axis_group(mesh, axis)
    return _FromFirstShard.apply(x, group, dist.get_global_rank(group, 0))


def reduce_metrics(metrics: dict, mesh: DeviceMesh, axis: str = "data",
                   maxima: tuple = ()) -> dict:
    """``metrics`` with every tensor SUMmed over the ranks of ``axis`` (one
    all-reduce), those named in ``maxima`` MAXed; other values as they are."""
    group = axis_group(mesh, axis)
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = dict(metrics)
    for op, keys in ((dist.ReduceOp.SUM, [k for k in names if k not in maxima]),
                     (dist.ReduceOp.MAX, [k for k in names if k in maxima])):
        if keys:
            buf = torch.stack([metrics[k].detach() for k in keys])
            dist.all_reduce(buf, op=op, group=group)
            out.update(zip(keys, buf.unbind()))
    return out


def all_reduce_grads(grads: list, mesh: DeviceMesh, axis: str = "data") -> list:
    """Every gradient leaf SUMmed over the ranks of ``axis`` in one
    all-reduce of the leaves flattened in their list order; returns views
    of the summed buffer shaped as ``grads``."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]
