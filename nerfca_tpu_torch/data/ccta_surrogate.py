"""High-fidelity CCTA surrogate: a clinical-scale HU-space 4-D thorax (port
of ``nerfca_tpu/data/ccta_surrogate.py``: the same numpy/scipy calls, so
both packages write the same files bit for bit).

Why this exists: the MAGIX/CCTA pipeline (``data/ccta.py``, reference
``preprocess/preprocess_ccta.py:19-147``) had only ever been unit-tested on
tiny synthetic arrays — no real scan is redistributable, and SimpleITK (the
reference's nrrd reader) is absent from this image. This module generates a
surrogate with the properties that make the pipeline's steps DO something:

  - raw values in HOUNSFIELD units (air -1000, lung -820, soft tissue ~40,
    contrast-enhanced chambers/aorta 300-400, bone 500-700), so the
    HU -> attenuation conversion (``preprocess_ccta.py:7-12``) is exercised
    on clinically-scaled numbers;
  - ANISOTROPIC voxel spacing (thick CT slices along the scanner axis), so
    the resample-by-spacing step (``:58-62``) actually changes the grid;
  - a contrast-filled AORTA distinct from (and brighter than) the heart, so
    the aorta-flattening step (``:64-66``) measurably edits the volume;
  - a thin LCA (left coronary artery) with its own segmentation mask and a
    per-phase deformation, so the EDT vessel conditioning (``:80-122``)
    carves a real centerline-peaked profile and temporal-variance maps see
    coronary motion;
  - a ``total_seg`` labelmap using the reference's TotalSegmentator label
    conventions (heart 51, aorta 52, ribs 79+).

Geometry constraint baked into the anatomy: the CCTA acquisition preset
(``geometry/cone.py::ccta_geometry``: DSD 2000, DSO 600, 200 mm detector)
images only a ~±30 mm region around the isocenter — the round-3 FOV
forensics lesson. The heart is therefore centered at the isocenter and the
LCA orbit kept within ±27 mm, like a clinically-centered angiographic
acquisition.

Axis convention: arrays are generated directly in the projector's (x, y, z)
index order (axis 2 = scanner slice axis, the thick-spacing one). A real
sitk array arrives (z, y, x); transposing it is the caller's one-line
adapter and exercises nothing in the pipeline.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

from nerfca_tpu_torch.data.ccta import preprocess_ccta_volume

# HU values (typical contrast-enhanced CCTA)
HU_AIR = -1000.0
HU_LUNG = -820.0
HU_SOFT = 40.0
HU_HEART = 150.0  # mixed myocardium + enhanced blood pool
HU_AORTA = 400.0  # contrast-filled
HU_LCA = 350.0  # contrast-filled coronary
HU_SPINE = 350.0
HU_RIB = 600.0
HU_STERNUM = 250.0

# reference TotalSegmentator-style labels (``data/ccta.py::TOTAL_LABELS``)
LABEL_HEART = 51
LABEL_AORTA = 52
LABEL_RIB_BASE = 79


def _soft_inside(quadratic: np.ndarray, edge: float) -> np.ndarray:
    """Smooth indicator of ``quadratic < 1`` (cosine ramp of half-width
    ``edge``) — same idiom as ``data/phantom.py::_soft_inside``."""
    t = np.clip((1.0 - quadratic) / edge, 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def _lca_centerline(phase: float, n_pts: int = 160) -> np.ndarray:
    """Phase-deformed left-coronary-like curve (mm, isocenter-centered).

    Two joined segments mimic LM->LAD with a circumflex-like sweep: the
    curve winds around a small peri-cardiac ellipsoid while descending,
    and the beat (max displacement mid-cycle, like
    ``phantom._vessel_centerline``) both slides it tangentially and
    squeezes its orbit radially. Stays within ±27 mm of the isocenter —
    inside the CCTA preset's imaged FOV.
    """
    ts = np.linspace(0.0, 1.0, n_pts, dtype=np.float64)
    beat = np.sin(np.pi * phase)  # 0 at phase 0, max mid-cycle
    ang = -0.6 + 3.4 * ts + 0.12 * beat * np.sin(2.5 * np.pi * ts)
    squeeze = 1.0 - 0.10 * beat * np.sin(np.pi * ts)
    rx, ry = 24.0 * squeeze, 20.0 * squeeze
    x = rx * np.cos(ang)
    y = ry * np.sin(ang) - 3.0
    z = 24.0 - 55.0 * ts + 4.0 * beat * np.sin(2.0 * np.pi * ts)
    return np.stack([x, y, z], axis=-1)


def _tube_mask(coords: tuple, centers: np.ndarray, radius: float) -> np.ndarray:
    """Boolean mask of voxels within ``radius`` (mm) of a polyline, computed
    inside the polyline's bounding box only (the full grid is ~10M voxels)."""
    x, y, z = coords
    lo = centers.min(0) - 2 * radius
    hi = centers.max(0) + 2 * radius
    box = (
        (x >= lo[0]) & (x <= hi[0])
        & (y >= lo[1]) & (y <= hi[1])
        & (z >= lo[2]) & (z <= hi[2])
    )
    idx = np.nonzero(box)
    pts = np.stack([x[idx], y[idx], z[idx]], axis=-1)  # [M, 3]
    min_d2 = np.full(pts.shape[0], np.inf)
    for c in centers:
        d2 = ((pts - c) ** 2).sum(-1)
        np.minimum(min_d2, d2, out=min_d2)
    mask = np.zeros(x.shape, bool)
    mask[idx] = min_d2 < radius**2
    return mask


def surrogate_ccta_arrays(
    phase: float,
    shape: tuple = (256, 256, 160),
    spacing: tuple = (1.0, 1.0, 1.6),
    seed: int = 0,
    heart_pulse: float = 0.0,
):
    """One cardiac phase -> ``(raw_hu, lca_mask, total_seg)``.

    ``raw_hu`` float32 Hounsfield volume, ``lca_mask`` uint8 coronary
    segmentation, ``total_seg`` uint8 anatomy labelmap. The background is
    phase-static by default (``heart_pulse`` > 0 adds a myocardial
    contraction, which also moves heart edges into the variance maps);
    the LCA always beats.
    """
    nx, ny, nz = shape
    ax = (np.arange(nx) - (nx - 1) / 2) * spacing[0]
    ay = (np.arange(ny) - (ny - 1) / 2) * spacing[1]
    az = (np.arange(nz) - (nz - 1) / 2) * spacing[2]
    x, y, z = np.meshgrid(
        ax.astype(np.float32), ay.astype(np.float32), az.astype(np.float32),
        indexing="ij",
    )

    vol = np.full(shape, HU_AIR, np.float32)
    seg = np.zeros(shape, np.uint8)

    # thorax ellipsoid
    body_q = (x / 115.0) ** 2 + (y / 95.0) ** 2 + (z / 135.0) ** 2
    body_in = _soft_inside(body_q, edge=0.12)
    vol += (HU_SOFT - HU_AIR) * body_in

    # static CT-like texture inside the body (same seed every phase: real
    # 4D-CT background anatomy is consistent across the gated cycle)
    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    noise = gaussian_filter(
        rng.normal(0.0, 1.0, shape).astype(np.float32), sigma=3.0
    )
    noise *= 20.0 / max(float(noise.std()), 1e-9)
    vol += noise * (body_in > 0.5)

    # lungs
    for sx in (-1.0, 1.0):
        lung_q = (
            ((x - 58.0 * sx) / 42.0) ** 2
            + ((y + 5.0) / 48.0) ** 2
            + ((z - 5.0) / 88.0) ** 2
        )
        lung_in = _soft_inside(lung_q, edge=0.18)
        vol += (HU_LUNG - HU_SOFT) * lung_in * (body_in > 0.5)

    # spine: posterior column with vertebral modulation along z
    spine_r2 = x**2 + (y - 70.0) ** 2
    vertebrae = 1.0 + 0.35 * np.cos(2 * np.pi * z / 25.0)
    spine = np.exp(-spine_r2 / (2 * 14.0**2)) * vertebrae
    vol += (HU_SPINE - HU_SOFT) * np.clip(spine, 0, 1) * (body_in > 0.5)

    # sternum: anterior plate
    stern_r2 = (x / 14.0) ** 2 + ((y + 86.0) / 6.0) ** 2
    vol += (HU_STERNUM - HU_SOFT) * _soft_inside(stern_r2, edge=0.4) * (
        (np.abs(z) < 70) & (body_in > 0.5)
    )

    # ribs: arcs hugging the body surface, labeled individually (79+)
    phi_grid = np.arctan2(x, -(y - 5.0))
    for k, z0 in enumerate((-90.0, -55.0, -20.0, 15.0, 50.0, 85.0)):
        z_c = z0 + 12.0 * (np.abs(phi_grid) / np.pi)
        ring = (x / 104.0) ** 2 + ((y - 5.0) / 86.0) ** 2
        tube2 = (np.sqrt(np.maximum(ring, 1e-12)) - 1.0) ** 2 * 9500.0 + (
            (z - z_c) / 1.35
        ) ** 2
        rib = np.exp(-tube2 / (2 * 4.0**2))
        rib *= _soft_inside((np.abs(phi_grid) / 2.55) ** 2, edge=0.2)
        vol += (HU_RIB - HU_SOFT) * np.clip(rib, 0, 1)
        seg[rib > 0.4] = LABEL_RIB_BASE + k

    # heart: isocenter-centered (the angiographic FOV constraint), mildly
    # contrast-enhanced; optional pulsation
    c = 1.0 - heart_pulse * np.sin(np.pi * phase)
    heart_q = (
        (x / (52.0 * c)) ** 2
        + ((y + 3.0) / (46.0 * c)) ** 2
        + ((z + 2.0) / (56.0 * c)) ** 2
    )
    heart_in = _soft_inside(heart_q, edge=0.16)
    vol += (HU_HEART - HU_SOFT) * heart_in
    seg[heart_q < 1.0] = LABEL_HEART

    # ascending aorta: contrast-filled tube rising from the heart base —
    # brighter than the heart so the flattening step has work to do
    aorta_r2 = (x - 6.0) ** 2 + (y + 10.0) ** 2
    aorta = (aorta_r2 < 14.0**2) & (z > 20.0) & (z < 90.0) & (body_in > 0.5)
    vol[aorta] = HU_AORTA
    seg[aorta] = LABEL_AORTA

    # LCA: phase-deformed coronary + its segmentation
    centers = _lca_centerline(phase)
    lca = _tube_mask((x, y, z), centers, radius=2.2)
    vol[lca] = HU_LCA
    lca_mask = lca.astype(np.uint8)

    return vol.astype(np.float32), lca_mask, seg


def write_surrogate_phase(
    out_root: str,
    p: int,
    phases: int = 10,
    shape: tuple = (256, 256, 160),
    spacing: tuple = (1.0, 1.0, 1.6),
    contrast_f: float = 0.05,
    seed: int = 0,
    heart_pulse: float = 0.0,
    verbose: bool = True,
) -> None:
    """Phase ``p`` of :func:`write_surrogate_case` (phase ``p / phases``)."""
    t0 = time.time()
    raw, lca, seg = surrogate_ccta_arrays(
        p / phases, shape=shape, spacing=spacing, seed=seed, heart_pulse=heart_pulse,
    )
    full, dyn = preprocess_ccta_volume(
        raw, lca, seg, spacing, contrast_f=contrast_f, return_dyn=True
    )
    out_dir = os.path.join(out_root, str(p))
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "spacing.npy"), np.ones(3))
    np.save(os.path.join(out_dir, "volume-shape.npy"), np.array(full.shape)[::-1])
    np.save(os.path.join(out_dir, "full_volume.npy"), full.flatten())
    np.save(os.path.join(out_dir, "full_volume_tigre.npy"), full)
    np.save(os.path.join(out_dir, "dyn_volume_tigre.npy"), dyn)
    if verbose:
        print(
            f"phase {p}: raw {raw.shape} -> full {full.shape}, "
            f"vessel voxels {int((dyn > 0).sum())}, {time.time() - t0:.1f}s",
            flush=True,
        )


def write_surrogate_case(
    out_root: str,
    phases: int = 10,
    shape: tuple = (256, 256, 160),
    spacing: tuple = (1.0, 1.0, 1.6),
    contrast_f: float = 0.05,
    seed: int = 0,
    heart_pulse: float = 0.0,
    verbose: bool = True,
    workers: int = 1,
) -> None:
    """Generate all phases and run the FULL array-level CCTA pipeline
    (``data/ccta.py::preprocess_ccta_volume``: HU->mu, resample-by-spacing,
    aorta flattening, EDT vessel conditioning), writing the dataset
    builder's volume contract under ``out_root``:

      - ``<phase>/full_volume_tigre.npy``  — conditioned attenuation volume
      - ``<phase>/dyn_volume_tigre.npy``   — conditioned vessel-only volume
        (the decomposition ground truth, like XCAT's extracted artery)
      - plus the reference's ``full_volume.npy`` / ``volume-shape.npy`` /
        ``spacing.npy`` artifact names (``preprocess_ccta.py:127-147``).

    ``workers > 1`` builds the phases in that many fresh interpreters,
    phase ``p`` in worker ``p % workers`` (a fresh interpreter re-runs
    nothing of the caller's ``__main__``, which ``multiprocessing``'s spawn
    would). Each phase depends on nothing but its index, so the files are
    the same bytes as one process writes.
    """
    kw = dict(phases=phases, shape=list(shape), spacing=list(spacing), contrast_f=contrast_f,
              seed=seed, heart_pulse=heart_pulse, verbose=verbose)
    if workers <= 1:
        for p in range(phases):
            write_surrogate_phase(out_root, p, **kw)
        return
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [repo, *filter(None, [os.environ.get("PYTHONPATH")])])}
    code = ("import json, sys\n"
            "from nerfca_tpu_torch.data.ccta_surrogate import write_surrogate_phase\n"
            "a = json.loads(sys.argv[1])\n"
            "for p in a['phases']:\n"
            "    write_surrogate_phase(a['out_root'], p, **a['kw'])\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, json.dumps(
        {"out_root": out_root, "phases": list(range(i, phases, workers)), "kw": kw})], env=env)
        for i in range(min(workers, phases))]
    failed = [i for i, proc in enumerate(procs) if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"write_surrogate_case: workers {failed} of {len(procs)} failed")
