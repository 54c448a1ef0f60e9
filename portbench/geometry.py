"""A frozen copy of the SYNTH cone-beam acquisition: the C-arm pose, the
detector's rays, the view selection and the near/far bounds.

Lengths are in the scaled units the port trains in (mm x 1e-2). The preset
is the SYNTH one (XCAT's source and detector distances, a 128 mm volume at
the isocenter, a 200 x 200 detector at 1 mm); the train views follow the
reference's view selection and the test views are its clinical presets.
"""

from __future__ import annotations

import numpy as np
import torch

SCALE = 1e-2
MAX_PIXEL_VALUE = 8.670397  # the phantom generator's calibrated source intensity
CLINICAL_TEST_ANGLES = np.array([[-5, 40], [-5, -40], [90, 0], [-30, 0]], np.float64)
FOUR_VIEW_PRESET = np.array([[-30, 30], [-30, -30], [60, -30], [60, 30]], np.float64)
CLOSE_THRESH_DEG = 15.0


def acquisition(detector: int = 200, volume_mm: float = 128.0) -> dict:
    """The SYNTH preset: source-detector and source-isocenter distances,
    detector pixels and pitch, the volume's half extent, near and far."""
    dsd, dso = 2500 * SCALE, 450 * SCALE
    pitch = (200.0 / detector) * SCALE  # 1 mm at 200 pixels, 4 mm at 50
    half = 0.5 * volume_mm * SCALE
    dist_max = float(np.hypot(half, half))
    return {"DSD": dsd, "DSO": dso, "n_detector": detector, "pitch": pitch, "half": half,
            "near": max(0.0, dso - dist_max), "far": min(2 * dso, dso + dist_max)}


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def pose(theta_deg: float, phi_deg: float, dso: float) -> tuple:
    """C-arm rotation ``Rz(-theta) Rz(pi/2) Rx(phi) Rx(-pi/2)`` and the
    source position, the rotation applied to ``[0, 0, -DSO]``."""
    rot = (_rot_z(-np.deg2rad(theta_deg)) @ _rot_z(np.pi / 2) @ _rot_x(np.deg2rad(phi_deg))
           @ _rot_x(-np.pi / 2))
    return rot, rot @ np.array([0.0, 0.0, -dso])


def view_rays(theta_deg: float, phi_deg: float, acq: dict, device) -> tuple:
    """Origins and directions ``[W * H, 3]`` of one view, pixel ``(a, b)``
    at row ``a * H + b``: half-pixel-centred detector coordinates,
    direction ``[u / DSD, v / DSD, 1]`` rotated by the pose, not normalised."""
    n = acq["n_detector"]
    rot, src = pose(theta_deg, phi_deg, acq["DSO"])
    idx = (torch.arange(n, dtype=torch.float32, device=device) + 0.5 - n / 2) * acq["pitch"]
    uu, vv = torch.meshgrid(idx, idx, indexing="ij")
    dirs = torch.stack([uu / acq["DSD"], vv / acq["DSD"], torch.ones_like(uu)], dim=-1)
    dirs = (dirs @ torch.as_tensor(rot.T, dtype=torch.float32, device=device)).reshape(-1, 3)
    origins = torch.as_tensor(src, dtype=torch.float32, device=device).expand_as(dirs)
    return origins.contiguous(), dirs.contiguous()


def train_angles(limited_range: float, step_size: float, numb_angles) -> np.ndarray:
    """The reference's train views: a (theta, phi) grid over the limited
    range without the angles within 15 degrees (L1) of a test view, the
    4-view preset where exactly 4 survive, or the preset itself when the
    step exceeds the range."""
    if step_size > limited_range:
        if numb_angles != 4:
            raise ValueError("only the 4-view preset is frozen here")
        return FOUR_VIEW_PRESET
    t = np.arange(-limited_range, limited_range + 1, step_size)
    grid = np.array(np.meshgrid(t, t, indexing="ij")).reshape(2, -1).T
    d = np.abs(grid[:, None, :] - CLINICAL_TEST_ANGLES[None, :, :]).sum(-1)
    grid = grid[(d > CLOSE_THRESH_DEG).all(axis=1)]
    return FOUR_VIEW_PRESET if grid.shape[0] == 4 else grid
