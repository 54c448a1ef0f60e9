"""Depth-sample (ray-segment) parallel rendering (port of
``nerfca_tpu/parallel/depth_shard.py``).

The S depth samples of each ray are split over the mesh's ``'depth'``
axis: each rank evaluates both plain fields on its slab of samples and
forms the partial Beer-Lambert attenuation sums, and one SUM all-reduce
over the axis gives each pixel. This works because the X-ray renderer is a
pure sum over samples, with no transmittance ordering. Like the JAX
function, it calls no kernel: the fields are the plain torch fields.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nerfca_tpu_torch.models.fields import (
    FieldConfig,
    apply_static_field,
    apply_temporal_field,
)
from nerfca_tpu_torch.ops.render import depth_deltas, output_activation
from nerfca_tpu_torch.parallel.mesh import batch_sharding


def depth_sharded_render(mesh: DeviceMesh, params, origins, directions, phases, depth_values,
                         static_cfg: FieldConfig, temp_cfg: FieldConfig, windows,
                         initial_intensity: float, activation: str = "softplus",
                         scale_value: float = 1e-2, axis: str = "depth"):
    """Composite render with the sample axis split over ``axis``.

    ``origins``/``directions``: ``[R, 3]`` and ``phases``: ``[R]``, the same
    on every rank; ``depth_values``: the global ``[S]``, S divisible by the
    axis size. Returns ``(pix [R], static_attn [R], temp_attn [R])`` on
    every rank, the attenuations those of each field alone."""
    # the deltas look at neighbouring samples: take them over the global
    # depths so each slab carries its own
    dists = depth_deltas(depth_values)
    part = batch_sharding(mesh, axis).slice(depth_values.shape[0])
    z, d_loc = depth_values[part], dists[part]
    pts = origins[:, None, :] + directions[:, None, :] * z[:, None]
    pph = phases[:, None].expand(pts.shape[:2]).long()
    s_raw = apply_static_field(params["static"], pts, static_cfg, window=windows["static"])
    t_raw = apply_temporal_field(params["temp"], pts, pph, temp_cfg, window=windows["temp"])
    s_sig = output_activation(s_raw[..., -1], activation) * scale_value
    t_sig = output_activation(t_raw[..., -1], activation) * scale_value
    attn = torch.stack([torch.sum(s_sig * d_loc, dim=-1), torch.sum(t_sig * d_loc, dim=-1)])
    dist.all_reduce(attn, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    s_attn, t_attn = attn[0], attn[1]
    return initial_intensity - (s_attn + t_attn), s_attn, t_attn
