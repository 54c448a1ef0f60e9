"""XCAT-scale surrogate generator: a stand-in ``dxcat1_bin`` payload (port
of ``nerfca_tpu/data/xcat_surrogate.py``: the same numpy/scipy calls, so
both packages write the same bins byte for byte).

The real XCAT binary is proprietary and absent, so the driver contract in
``data/xcat.py`` (param-file override -> subprocess -> 512x512x401 f32 bin
-> |with - without| artery extraction -> LCA crop + pin) had only ever run
against a toy fake in unit tests. This module generates full-scale
surrogate attenuation volumes with the properties the pipeline depends on:

  - REAL XCAT dimensions (512 x 512 x 401 voxels at 0.25 mm — a 128 mm
    cardiac-field crop, not a whole thorax: soft-tissue background with a
    lung edge, rib/sternum fragments, a heart ellipsoid, and a moving
    coronary);
  - the cardiac structures sit where the XCAT acquisition preset's
    ``offOrigin = [10, -25, 25]`` puts the imaged isocenter — grid
    ~(155, 355, 160) — inside the reference's LCA crop box
    ``[[0,280],[250,500],[0,260]]`` (``preprocess/xcat.py:119-158``), so
    the extraction and the detector FOV (~±18 mm at this geometry) both
    see the vessel;
  - a ``noarteries`` variant that is BITWISE the background (the real
    generator's paired run), so ``|full - noarteries|`` isolates exactly
    the coronary;
  - the vessel moves with ``hrt_start_phase_index`` (read from the
    ``.samp.par`` file, as the real binary would) while the background is
    phase-static, so temporal-variance maps see coronary motion only.

Attenuation values are per WORLD UNIT of the downstream projector
(1 unit = 100 mm under the 1e-2 scale factor), matched to the synthetic
phantom's scale so line integrals land in the same O(0.1-0.5) range:
soft tissue 0.18, heart 0.20, lung 0.04, bone 0.5, raw coronary 0.30.
NOTE the reference contract then PINS the extracted LCA to
``lca_val = 0.15`` — *below* the heart's 0.20 — i.e. the genuine XCAT
operating regime is a slightly negative-contrast vessel distinguishable
mainly by MOTION (cf. the round-4 contrast sweep's 1.0x-tissue arm).

The static background is generated once and cached on disk (~420 MB);
per-phase volumes then cost one vessel paste each.
"""

from __future__ import annotations

import os

import numpy as np

XCAT_DIMS = (512, 512, 401)
D_VOXEL_MM = 0.25
# FRACTIONAL grid position of the imaged isocenter (see module docstring;
# 155.5/512, 355.5/512, 160/401 at the real dims) — fractional so reduced
# test dims keep the same anatomy layout when d_voxel_mm scales inversely
ISO_FRAC = (0.3037, 0.6943, 0.3990)


def iso_grid(dims):
    return tuple(f * n for f, n in zip(ISO_FRAC, dims))

VAL_SOFT = 0.18
VAL_HEART = 0.20
VAL_LUNG = 0.04
VAL_BONE = 0.50
VAL_VESSEL_RAW = 0.30


def _grid_mm(dims, d_voxel_mm):
    """Per-axis 1-D mm coordinates relative to the imaged isocenter."""
    return [
        (np.arange(n, dtype=np.float32) - c) * d_voxel_mm
        for n, c in zip(dims, iso_grid(dims))
    ]


def surrogate_background(
    dims=XCAT_DIMS, seed: int = 0, d_voxel_mm: float = D_VOXEL_MM
) -> np.ndarray:
    """Phase-static cardiac-field background (float32, value per world
    unit). Built axis-broadcast (no full meshgrid copies: the volume is
    105M voxels)."""
    ax, ay, az = _grid_mm(dims, d_voxel_mm)
    x = ax[:, None, None]
    y = ay[None, :, None]
    z = az[None, None, :]

    vol = np.full(dims, VAL_SOFT, np.float32)

    # lung edge: low-attenuation region entering from one lateral side
    lung = ((x - 55.0) / 35.0) ** 2 + ((y + 10.0) / 60.0) ** 2 + (
        (z - 5.0) / 70.0
    ) ** 2
    vol += (VAL_LUNG - VAL_SOFT) * np.clip(2.0 - lung, 0.0, 1.0).astype(
        np.float32
    )

    # heart: large ellipsoid around the isocenter (the vessel's host)
    heart = (x / 42.0) ** 2 + ((y + 6.0) / 38.0) ** 2 + ((z + 4.0) / 46.0) ** 2
    vol += (VAL_HEART - VAL_SOFT) * np.clip(2.0 - heart, 0.0, 1.0).astype(
        np.float32
    ) * 0.5

    # two rib fragments + a sternum plate near the anterior edge
    for y0, z0 in ((-52.0, -30.0), (-50.0, 25.0)):
        rib = np.exp(
            -(((y - y0) / 4.0) ** 2 + ((z - z0) / 5.0) ** 2)
        ).astype(np.float32)
        vol += (VAL_BONE - VAL_SOFT) * rib * (np.abs(x) < 55.0)
    stern = np.exp(-(((y + 58.0) / 5.0) ** 2 + (x / 30.0) ** 4)).astype(
        np.float32
    )
    vol += 0.6 * (VAL_BONE - VAL_SOFT) * stern

    # CT-like smooth texture (static across phases)
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    coarse = rng.normal(0.0, 1.0, (64, 64, 51)).astype(np.float32)
    coarse = gaussian_filter(coarse, sigma=1.5)
    from scipy.ndimage import zoom

    tex = zoom(coarse, (dims[0] / 64, dims[1] / 64, dims[2] / 51), order=1)
    tex = tex[: dims[0], : dims[1], : dims[2]]
    vol += 0.015 * tex / max(float(np.abs(tex).max()), 1e-9)

    return vol.astype(np.float32)


def _vessel_centerline_mm(phase: float, n_pts: int = 160) -> np.ndarray:
    """LCA-like curve (mm, isocenter-relative) within the ±18 mm imaged
    FOV, deformed by the cardiac phase (same beat idiom as the synthetic
    phantom: zero displacement at phase 0, max mid-cycle)."""
    ts = np.linspace(0.0, 1.0, n_pts, dtype=np.float64)
    beat = np.sin(np.pi * phase)
    ang = -0.5 + 3.2 * ts + 0.10 * beat * np.sin(2.5 * np.pi * ts)
    squeeze = 1.0 - 0.12 * beat * np.sin(np.pi * ts)
    rx, ry = 12.5 * squeeze, 10.5 * squeeze
    x = rx * np.cos(ang)
    y = ry * np.sin(ang) - 1.5
    z = 12.0 - 26.0 * ts + 2.5 * beat * np.sin(2.0 * np.pi * ts)
    return np.stack([x, y, z], axis=-1)


def add_vessel(
    bg: np.ndarray, phase: float, radius_mm: float = 0.9,
    d_voxel_mm: float = D_VOXEL_MM,
) -> np.ndarray:
    """Paste the phase-deformed coronary (bounding-box local distance
    computation — the full grid is 105M voxels). On coarse test grids the
    radius floors at ~1.5 voxels so the tube never vanishes between voxel
    centers."""
    radius_mm = max(radius_mm, 1.5 * d_voxel_mm)
    dims = bg.shape
    ax, ay, az = _grid_mm(dims, d_voxel_mm)
    centers = _vessel_centerline_mm(phase)
    lo = centers.min(0) - 3 * radius_mm
    hi = centers.max(0) + 3 * radius_mm
    ix = np.nonzero((ax >= lo[0]) & (ax <= hi[0]))[0]
    iy = np.nonzero((ay >= lo[1]) & (ay <= hi[1]))[0]
    iz = np.nonzero((az >= lo[2]) & (az <= hi[2]))[0]
    gx, gy, gz = np.meshgrid(ax[ix], ay[iy], az[iz], indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1)
    min_d2 = np.full(pts.shape[:-1], np.inf)
    for c in centers:
        d2 = ((pts - c) ** 2).sum(-1)
        np.minimum(min_d2, d2, out=min_d2)
    mask = min_d2 < radius_mm**2
    out = bg.copy()
    sub = out[np.ix_(ix, iy, iz)]
    sub[mask] = VAL_VESSEL_RAW
    out[np.ix_(ix, iy, iz)] = sub
    return out


def write_bin(
    save_path: str,
    phase: float,
    with_arteries: bool,
    bg_cache: str,
    dims=XCAT_DIMS,
    d_voxel_mm: float = D_VOXEL_MM,
) -> None:
    """Emit ``<save_path>_atn_1.bin`` exactly as the real generator would
    (raw little-endian float32). The background is cached at ``bg_cache``
    on first use."""
    if os.path.isfile(bg_cache):
        bg = np.fromfile(bg_cache, dtype=np.float32).reshape(dims)
    else:
        bg = surrogate_background(dims, d_voxel_mm=d_voxel_mm)
        bg.tofile(bg_cache)
    vol = (
        add_vessel(bg, phase, d_voxel_mm=d_voxel_mm)
        if with_arteries
        else bg
    )
    vol.astype(np.float32).tofile(save_path + "_atn_1.bin")
