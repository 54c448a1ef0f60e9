"""Detector-plane ray generation (port of ``nerfca_tpu/geometry/rays.py``).

Given a C-arm pose and cone-beam geometry, produce per-pixel ray origins and
(unnormalized) directions as torch tensors on a chosen device:
  - half-pixel-centered detector coordinates with ``offDetector`` shift,
  - direction [u/DSD, v/DSD, 1] rotated by the pose; origin = pose
    translation; directions deliberately NOT normalized (depth values are
    measured along this direction scale).
"""

from __future__ import annotations

import numpy as np
import torch

from nerfca_tpu_torch.geometry.rotations import carm_source_matrix, roadmap_source_matrix


def detector_grid(img_width: int, img_height: int, d_detector, off_detector,
                  dsd: float, device=None, dtype=torch.float32) -> torch.Tensor:
    """Unrotated unit-depth ray directions ``[W, H, 3]``; entry ``[a, b]``
    is detector coordinate ``u = (a + 0.5 - W/2) * du + off_u``,
    ``v = (b + 0.5 - H/2) * dv + off_v``."""
    a = torch.arange(img_width, dtype=dtype, device=device)[:, None]
    b = torch.arange(img_height, dtype=dtype, device=device)[None, :]
    uu = (a + 0.5 - img_width / 2) * float(d_detector[0]) + float(off_detector[0])
    vv = (b + 0.5 - img_height / 2) * float(d_detector[1]) + float(off_detector[1])
    uu, vv = torch.broadcast_tensors(uu, vv)
    return torch.stack([uu / dsd, vv / dsd, torch.ones_like(uu)], dim=-1)


def detector_rays(theta_deg: float, phi_deg: float, larm_deg: float,
                  geo_info: dict, device=None, dtype=torch.float32):
    """Per-pixel (origins, directions), each ``[W, H, 3]``, for one view.
    ``geo_info`` is the ``general.json`` dict (DSO, DSD, nDetector,
    dDetector, offDetector)."""
    pose = carm_source_matrix(theta_deg, phi_deg, larm_deg, dso=float(geo_info["DSO"]))
    img_width, img_height = (int(x) for x in geo_info["nDetector"])
    dirs = detector_grid(img_width, img_height, geo_info["dDetector"],
                         geo_info["offDetector"], float(geo_info["DSD"]),
                         device=device, dtype=dtype)
    rot = torch.as_tensor(np.asarray(pose[:3, :3]), dtype=dtype, device=device)
    ray_directions = dirs @ rot.T
    ray_origins = torch.as_tensor(
        np.asarray(pose[:3, 3]), dtype=dtype, device=device
    ).expand_as(ray_directions)
    return ray_origins, ray_directions


def pose_matrix(theta_deg: float, phi_deg: float, larm_deg: float, dso: float) -> np.ndarray:
    """Host-side 4x4 world-from-source pose (for ``srcmatrices.json``)."""
    return carm_source_matrix(theta_deg, phi_deg, larm_deg, dso=dso)


def perspective_rays(theta_deg: float, phi_deg: float, larm_deg: float, source_pt,
                     img_width: int, img_height: int, focal_length: float,
                     table_translation=(0.0, 0.0, 0.0), device=None, dtype=torch.float32):
    """Pinhole-style ray generation under the 'roadmap' pose, each output
    ``[H, W, 3]``: a pixel-corner (not half-pixel-centered) grid, directions
    ``[(i - W/2)/f, -(j - H/2)/f, -1]`` rotated by the roadmap pose with
    source and table translations (``preprocess/proj_helpers.py:48-67``,
    the reference's non-TIGRE 'roadmap' x_ray_type)."""
    pose = roadmap_source_matrix(source_pt, theta_deg, phi_deg, larm_deg, table_translation)
    i = torch.arange(img_width, dtype=dtype, device=device)[None, :]
    j = torch.arange(img_height, dtype=dtype, device=device)[:, None]
    dirs = torch.stack(torch.broadcast_tensors(
        (i - img_width / 2) / focal_length,
        -(j - img_height / 2) / focal_length,
        -torch.ones((img_height, img_width), dtype=dtype, device=device),
    ), dim=-1)
    rot = torch.as_tensor(np.asarray(pose[:3, :3]), dtype=dtype, device=device)
    ray_directions = dirs @ rot.T
    ray_origins = torch.as_tensor(
        np.asarray(pose[:3, 3]), dtype=dtype, device=device
    ).expand_as(ray_directions)
    return ray_origins, ray_directions
