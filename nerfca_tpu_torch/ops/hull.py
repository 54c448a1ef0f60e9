"""Motion-hull prior: a 3-D occupancy grid space-carved from the training
views' temporal-variance maps, gating the dynamic field's density (port of
``nerfca_tpu/ops/hull.py``).

A 3-D point can carry dynamic density only if EVERY training view projects
it into a moving pixel (space carving applied to motion instead of
silhouettes). The carved grid multiplies the temporal field's activated
density::

    sigma_dyn(x) = act(raw_dyn(x)) * hull(x)

The gate is data (no gradient flows into it). The grid is carved once on
the host (numpy + ``scipy.ndimage``) and then lives on the caller's device;
:func:`hull_gate` samples it with plain torch gathers, on the card as on the
CPU. This is a framework extension beyond the reference (flag-gated,
default off).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from nerfca_tpu_torch.geometry.rotations import carm_source_matrix


class MotionHull(NamedTuple):
    """The carved occupancy grid plus its world placement.

    ``grid`` is (x, y, z)-indexed like the projector's volumes; voxel
    ``(i, j, k)`` sits at ``(idx - (res - 1)/2) * d_voxel + off``.
    """

    grid: torch.Tensor  # [rx, ry, rz] float32 in [0, 1]
    d_voxel: torch.Tensor  # [3] float32 grid spacing (x, y, z)
    off: torch.Tensor  # [3] float32 world offset of the grid center (x, y, z)


def _project_to_pixels(pts: np.ndarray, theta: float, phi: float,
                       larm: float, info: dict) -> tuple[np.ndarray, np.ndarray]:
    """World points [N, 3] -> continuous detector pixel indices (a, b) for
    one C-arm view, the exact inverse of ``geometry.rays.detector_rays``:
    ``local = R^T (x - s)``, ``u/DSD = local_x / local_z``, then the
    half-pixel-centered detector grid inverted for indices."""
    pose = carm_source_matrix(float(theta), float(phi), float(larm), dso=float(info["DSO"]))
    rot = pose[:3, :3]
    src = pose[:3, 3]
    local = (pts - src[None, :]) @ rot  # == (R^T (x - s))^T rows
    z = np.maximum(local[:, 2], 1e-9)
    dsd = float(info["DSD"])
    u = dsd * local[:, 0] / z
    v = dsd * local[:, 1] / z
    d_det = np.asarray(info["dDetector"], np.float64)
    off_det = np.asarray(info["offDetector"], np.float64)
    w, h = (int(x) for x in info["nDetector"])
    a = (u - off_det[0]) / d_det[0] + w / 2 - 0.5
    b = (v - off_det[1]) / d_det[1] + h / 2 - 0.5
    return a, b


def _bilinear_01(img: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bilinear sample of ``img[a, b]`` at continuous indices; points off
    the image sample 0 (no motion evidence outside the detector)."""
    na, nb = img.shape
    inb = (a >= 0) & (a <= na - 1) & (b >= 0) & (b <= nb - 1)
    ac = np.clip(a, 0, na - 1 - 1e-6)
    bc = np.clip(b, 0, nb - 1 - 1e-6)
    ia = np.floor(ac).astype(np.int64)
    ib = np.floor(bc).astype(np.int64)
    fa = ac - ia
    fb = bc - ib
    v00 = img[ia, ib]
    v10 = img[ia + 1, ib]
    v01 = img[ia, ib + 1]
    v11 = img[ia + 1, ib + 1]
    val = (v00 * (1 - fa) + v10 * fa) * (1 - fb) + (v01 * (1 - fa) + v11 * fa) * fb
    return np.where(inb, val, 0.0)


def build_motion_hull(train_frames: list, info: dict, res: int = 96, thresh: float = 0.02,
                      dilate: int = 3, sigma: float = 1.0, device=None) -> MotionHull | None:
    """Carve the motion hull from the training views' variance maps.

    ``train_frames``: loader frame dicts (one per train image; views are
    deduplicated here). Returns None when a variance map is missing
    (partial cardiac cycles ship unit weights: there is nothing to carve).

    Per voxel centre: min over the views of the bilinearly sampled
    normalized temporal variance (maps store ``var + 1``), then threshold,
    binary dilation (``dilate`` iterations) and Gaussian smoothing
    (``sigma`` voxels), renormalized to a maximum of 1.
    """
    views: dict[tuple, str] = {}
    for row in train_frames:
        key = (float(row["theta"]), float(row["phi"]), float(row.get("larm", 0.0)))
        views.setdefault(key, row["weighted_file_path"])
    maps = []
    w, h = (int(x) for x in info["nDetector"])
    # the orientation transform below keeps [a, b] = (detector u, v)
    # indexing only on a square detector
    assert w == h, f"build_motion_hull requires a square detector, got nDetector={info['nDetector']}"
    for (theta, phi, larm), path in views.items():
        if not os.path.isfile(path):
            return None
        vmap = np.load(path).reshape(w, h).T.astype(np.float64) - 1.0
        maps.append((theta, phi, larm, vmap))
    if not maps:
        return None

    # general.json stores nVoxel/dVoxel in (x, y, z) order but offOrigin
    # reversed (z, y, x), the projector's convention
    n_vox = np.asarray(info["nVoxel"], np.float64)
    d_vol = np.asarray(info["dVoxel"], np.float64)
    off_xyz = np.asarray(info["offOrigin"], np.float64)[::-1]
    d_hull = n_vox * d_vol / res

    idx = np.arange(res, dtype=np.float64) - (res - 1) / 2
    gx, gy, gz = np.meshgrid(idx * d_hull[0] + off_xyz[0], idx * d_hull[1] + off_xyz[1],
                             idx * d_hull[2] + off_xyz[2], indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=-1)

    hull = None
    for theta, phi, larm, vmap in maps:
        a, b = _project_to_pixels(pts, theta, phi, larm, info)
        val = _bilinear_01(vmap, a, b)
        hull = val if hull is None else np.minimum(hull, val)
    hull = hull.reshape(res, res, res)

    from scipy import ndimage

    mask = hull > thresh
    if dilate > 0 and mask.any():
        mask = ndimage.binary_dilation(mask, iterations=dilate)
    grid = mask.astype(np.float64)
    if sigma > 0:
        grid = ndimage.gaussian_filter(grid, sigma=sigma)
        top = grid.max()
        if top > 0:
            grid = np.clip(grid / top, 0.0, 1.0)
    return MotionHull(
        grid=torch.tensor(grid, dtype=torch.float32, device=device),
        d_voxel=torch.tensor(d_hull, dtype=torch.float32, device=device),
        off=torch.tensor(off_xyz.copy(), dtype=torch.float32, device=device),
    )


def hull_gate(hull: MotionHull, x, y, z) -> torch.Tensor:
    """Trilinear gate values at world coordinates given as separate
    same-shaped tensors. Points outside the grid gate to 0."""
    rx, ry, rz = hull.grid.shape
    gx = (x - hull.off[0]) / hull.d_voxel[0] + (rx - 1) / 2
    gy = (y - hull.off[1]) / hull.d_voxel[1] + (ry - 1) / 2
    gz = (z - hull.off[2]) / hull.d_voxel[2] + (rz - 1) / 2
    inb = ((gx >= 0.0) & (gx <= rx - 1) & (gy >= 0.0) & (gy <= ry - 1)
           & (gz >= 0.0) & (gz <= rz - 1))
    # The base cell is clamped on the INTEGER side to res-2, so the +1
    # corner is always inside the grid. A float-side clamp to res-1-1e-6
    # rounds to exactly res-1 in f32, and a sample on the far face would
    # then read one row past the grid.
    gx = torch.clamp(gx, 0.0, rx - 1)
    gy = torch.clamp(gy, 0.0, ry - 1)
    gz = torch.clamp(gz, 0.0, rz - 1)
    ix = torch.clamp(torch.floor(gx).long(), max=rx - 2)
    iy = torch.clamp(torch.floor(gy).long(), max=ry - 2)
    iz = torch.clamp(torch.floor(gz).long(), max=rz - 2)
    fx = gx - ix
    fy = gy - iy
    fz = gz - iz
    flat = hull.grid.reshape(-1)

    def corner(dx, dy, dz):
        lin = ((ix + dx) * ry + (iy + dy)) * rz + (iz + dz)
        return flat[torch.clamp(lin, 0, flat.numel() - 1)]

    c00 = corner(0, 0, 0) * (1 - fx) + corner(1, 0, 0) * fx
    c10 = corner(0, 1, 0) * (1 - fx) + corner(1, 1, 0) * fx
    c01 = corner(0, 0, 1) * (1 - fx) + corner(1, 0, 1) * fx
    c11 = corner(0, 1, 1) * (1 - fx) + corner(1, 1, 1) * fx
    val = (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz
    return torch.where(inb, val, torch.zeros_like(val))


def hull_gate_rays(hull: MotionHull, origins, directions, z) -> torch.Tensor:
    """Gate values along rays: ``origins``/``directions`` [R, 3], ``z``
    either the shared [S] depth vector or per-ray [R, S]. Returns [R, S]."""
    zz = z if z.dim() == 2 else z[None, :]
    x = origins[:, 0:1] + directions[:, 0:1] * zz
    y = origins[:, 1:2] + directions[:, 1:2] * zz
    w = origins[:, 2:3] + directions[:, 2:3] * zz
    return hull_gate(hull, x, y, w)


# The config knobs that determine the carved hull (and so the model's
# effective dynamic density). Meant to be stored with a checkpoint so that
# an offline eval gates exactly as training did.
HULL_ARG_DEFAULTS = {
    "use_motion_hull": False,
    "hull_res": 96,
    "hull_thresh": 0.02,
    "hull_dilate": 3,
    "hull_sigma": 1.0,
}


def hull_args_record(args) -> dict:
    """The persisted record of the hull gating configuration."""
    return {k: getattr(args, k, d) for k, d in HULL_ARG_DEFAULTS.items()}


def apply_hull_args_record(args, record: dict) -> None:
    """Set eval args from a stored hull record. The record wins (the gate
    is part of the model); a different CLI value is reported as a warning."""
    for k, default in HULL_ARG_DEFAULTS.items():
        if k not in record:
            continue
        stored = type(default)(record[k])
        current = getattr(args, k, None)
        if current is not None and current != stored:
            warnings.warn(
                f"checkpoint was trained with {k}={stored} but eval args say {k}={current}; "
                f"using the checkpoint's value (the gate is part of the model)",
                stacklevel=2,
            )
        setattr(args, k, stored)


def hull_from_args(args, train_frames, info, device=None):
    """The one place that maps ``--use_motion_hull`` and the ``hull_*``
    knobs to a built hull, so training and evaluation gate with the same
    carved volume. None when the flag is off or no variance maps exist."""
    if not getattr(args, "use_motion_hull", False):
        return None
    return build_motion_hull(
        train_frames, info,
        res=getattr(args, "hull_res", HULL_ARG_DEFAULTS["hull_res"]),
        thresh=getattr(args, "hull_thresh", HULL_ARG_DEFAULTS["hull_thresh"]),
        dilate=getattr(args, "hull_dilate", HULL_ARG_DEFAULTS["hull_dilate"]),
        sigma=getattr(args, "hull_sigma", HULL_ARG_DEFAULTS["hull_sigma"]),
        device=device,
    )
