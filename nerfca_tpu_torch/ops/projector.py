"""Cone-beam forward projector in plain torch (port of
``nerfca_tpu/ops/projector.py``).

Trilinear sampling of the attenuation volume along each detector ray, with
zero fill outside the volume, then a rectangle-rule sum over depth (``ct``)
or the maximum along the ray (``mip``). The
8-corner gather is written out exactly as the JAX projector does it (clip
to ``n-1-1e-6``, out-of-bounds samples zeroed): ``F.grid_sample`` uses other
corner conventions and would not reproduce the stored datasets.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfca_tpu_torch.geometry.rays import detector_rays


def trilinear_sample(volume: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolate ``volume[nx, ny, nz]`` at continuous voxel
    coordinates ``pts[..., 3]``; points outside ``[0, n-1]`` give 0."""
    nx, ny, nz = volume.shape
    hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=pts.dtype, device=pts.device)
    in_bounds = ((pts >= 0.0) & (pts <= hi)).all(dim=-1)
    p = torch.minimum(torch.clamp(pts, min=0.0), hi - 1e-6)
    i0 = torch.floor(p).to(torch.int64)
    frac = p - i0.to(p.dtype)
    flat = volume.reshape(-1)
    # the +1 corner is clamped into the volume as JAX's gather clamps it:
    # in f32, n-1-1e-6 rounds to n-1 for n >= ~64, where floor gives n-1
    ix = (i0[..., 0], torch.clamp(i0[..., 0] + 1, max=nx - 1))
    iy = (i0[..., 1], torch.clamp(i0[..., 1] + 1, max=ny - 1))
    iz = (i0[..., 2], torch.clamp(i0[..., 2] + 1, max=nz - 1))

    def gather(dx, dy, dz):
        return flat[(ix[dx] * ny + iy[dy]) * nz + iz[dz]]

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = gather(0, 0, 0) * (1 - fx) + gather(1, 0, 0) * fx
    c10 = gather(0, 1, 0) * (1 - fx) + gather(1, 1, 0) * fx
    c01 = gather(0, 0, 1) * (1 - fx) + gather(1, 0, 1) * fx
    c11 = gather(0, 1, 1) * (1 - fx) + gather(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return torch.where(in_bounds, c0 * (1 - fz) + c1 * fz, torch.zeros_like(c0))


def world_to_voxel(points, vol_shape, d_voxel, off_origin_zyx):
    """World coordinates -> continuous voxel indices for an (x, y, z)-indexed
    volume centered at the reversed ``offOrigin``."""
    kw = dict(dtype=points.dtype, device=points.device)
    n = torch.tensor(list(vol_shape), **kw)
    d = torch.tensor(list(d_voxel), **kw)
    off = torch.tensor(list(off_origin_zyx)[::-1], **kw)
    return (points - off) / d + (n - 1) / 2


def project_view(volume, geo_info: dict, theta_deg: float, phi_deg: float,
                 larm_deg: float = 0.0, n_samples: int = 1000, mode: str = "ct",
                 tile: int = 8192, device=None) -> torch.Tensor:
    """Project one view: the ``[W, H]`` absorption line-integral image
    (``mode='ct'``) or maximum-intensity image (``mode='mip'``), aligned
    pixel-for-pixel with ``detector_rays``. Runs on ``device`` (default:
    the volume's device), in ray tiles to bound memory."""
    if mode not in ("ct", "mip"):
        raise ValueError(f"unknown projection mode {mode!r}")
    volume = torch.as_tensor(volume, dtype=torch.float32, device=device)
    dev = volume.device
    origins, dirs = detector_rays(theta_deg, phi_deg, larm_deg, geo_info, device=dev)
    w, h = origins.shape[:2]
    depth_values = torch.linspace(
        float(geo_info["near_thresh"]), float(geo_info["far_thresh"]), n_samples,
        device=dev,
    )
    dists = torch.cat([depth_values[1:] - depth_values[:-1],
                       torch.full((1,), 1e-10, device=dev)])
    flat_o = origins.reshape(-1, 3)
    flat_d = dirs.reshape(-1, 3)
    d_voxel = [float(v) for v in geo_info["dVoxel"]]
    off = [float(v) for v in geo_info["offOrigin"]]
    out = []
    for start in range(0, flat_o.shape[0], tile):
        o = flat_o[start:start + tile]
        d = flat_d[start:start + tile]
        pts = o[:, None, :] + d[:, None, :] * depth_values[:, None]
        vals = trilinear_sample(volume, world_to_voxel(pts, volume.shape, d_voxel, off))
        out.append(torch.amax(vals, dim=-1) if mode == "mip" else torch.sum(vals * dists, dim=-1))
    return torch.cat(out).reshape(w, h)


def transmission_image(line_integral, max_pixel_value: float):
    """Absorption line integral -> min-max normalized log-transmission image
    plus its (min, max) for denormalization (host numpy)."""
    log_img = np.log(max_pixel_value) - np.asarray(line_integral)
    img_min, img_max = float(log_img.min()), float(log_img.max())
    denom = img_max - img_min
    if denom == 0.0:
        return np.zeros_like(log_img), img_min, img_max
    return (log_img - img_min) / denom, img_min, img_max
