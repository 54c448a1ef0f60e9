"""Synthetic dynamic cardiac phantom.

The reference's 4-D volumes come from the proprietary XCAT binary
(``preprocess/xcat.py:90-94``) or a CCTA scan (``preprocess/preprocess_ccta.py``),
neither of which is redistributable. This module generates an analytically
defined stand-in with the same structure the method needs:

  - a STATIC background modeled on a thorax: a soft-tissue ellipsoid with
    low-attenuation lungs, a spine column, symmetric rib arcs, a sternum,
    and a heart ellipsoid (what the static field should absorb), and
  - a DYNAMIC coronary: a thin, bright, curved vessel tree whose position
    deforms with the cardiac phase (what the temporal field should capture).

Every background structure is placed SYMMETRICALLY and built from smooth
(Gaussian / soft-edge) profiles. This matters for the benchmark's operating
point: NeRF-CA reconstructs from as few as 4 views (``README.md:3``), which
is only well-posed when the background is low-frequency and structured the
way real anatomy (XCAT) is. An earlier revision used randomly placed dense
blobs; those are adversarial for extreme-sparse-view reconstruction (their
depth along the unobserved axes is unconstrained by 4 views) and capped
held-out PSNR at ~9 dB where the same pipeline reaches ~29 dB with 21 views.

Like the XCAT pipeline — which pins the artery attenuation to a fixed
``lca_val`` above softer background tissue (``preprocess/xcat.py:119-158``)
— the vessel is the brightest structure. Values here are attenuation per
WORLD UNIT (1 unit = 100 mm under the 1e-2 scale factor), chosen so
cone-beam line integrals land in the O(0.1-0.5) range that gives the
log-transmission images useful dynamic range.
"""

from __future__ import annotations

import numpy as np

NUM_PHASES = 10


def _vessel_centerline(
    ts: np.ndarray, phase: float, motion_scale: float = 1.0,
    vessel_extent: float = 1.0,
) -> np.ndarray:
    """Parametric coronary-like curve in [-1, 1]^3, deformed by phase.

    The beat displaces the curve laterally and radially with a smooth
    periodic profile (max displacement mid-cycle); ``motion_scale``
    multiplies the displacement amplitude (1.0 = the original anatomy).

    ``vessel_extent`` scales the WHOLE curve (including its motion) toward
    the isocenter. Why it exists (round-3 FOV forensics): the acquisition
    geometry's detector cone only images a ~±0.28 radius (phantom units)
    region around the isocenter — at extent 1.0 the curve spans ±0.9, so
    most of the vessel is never observed by ANY view and the (60, -30)
    grid view sees no vessel at all (its max artery line integral is
    3e-4). Extents <= ~0.22 put the full moving vessel inside every
    view's frustum, making 4-view decomposition geometrically
    well-posed.
    """
    beat = np.sin(np.pi * phase) * motion_scale  # 0 at phase 0, max mid-cycle
    x = 0.55 * np.cos(2.2 * ts + 0.3) + 0.12 * beat * np.sin(3.0 * ts)
    y = 0.55 * np.sin(2.2 * ts) * 0.8 + 0.10 * beat
    z = 0.8 * ts - 0.1 * beat * np.cos(2.0 * ts)
    return vessel_extent * np.stack([x, y, z], axis=-1)


def _vessel_mask(
    x: np.ndarray, y: np.ndarray, z: np.ndarray, phase: float, radius: float,
    motion_scale: float = 1.0, vessel_extent: float = 1.0,
) -> np.ndarray:
    """Boolean mask of voxels within ``radius`` of the phase-deformed
    centerline (shared by the composite volume and the vessel-only GT)."""
    ts = np.linspace(-1.0, 1.0, 96, dtype=np.float32)
    centers = _vessel_centerline(ts, phase, motion_scale, vessel_extent)  # [96, 3]
    pts = np.stack([x, y, z], axis=-1)  # [S,S,S,3]
    # chunk over centerline to bound memory: track min distance
    min_d2 = np.full(x.shape, np.inf, dtype=np.float32)
    for c in centers:
        d2 = ((pts - c) ** 2).sum(-1)
        np.minimum(min_d2, d2, out=min_d2)
    return min_d2 < radius**2


def _soft_inside(quadratic: np.ndarray, edge: float) -> np.ndarray:
    """Smooth indicator of ``quadratic < 1``: 1 deep inside, 0 outside,
    with a cosine ramp of half-width ``edge`` around the surface."""
    t = np.clip((1.0 - quadratic) / edge, 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def synthetic_phantom_volume(
    size: int = 64,
    phase: float = 0.0,
    lca_val: float = 1.2,
    background_val: float = 0.18,
    bone_val: float = 0.55,
    vessel_radius: float = 0.045,
    seed: int = 0,
    smooth_sigma: float = 1.0,
    motion_scale: float = 1.0,
    rib_scale: float = 1.0,
    vessel_extent: float = 1.0,
) -> np.ndarray:
    """One ``[size, size, size]`` float32 attenuation volume at cardiac
    ``phase`` in [0, 1).

    The background (thorax anatomy) is phase-independent; only the vessel
    moves, so per-pixel temporal variance isolates the coronary exactly as
    the reference's variance-weight maps assume
    (``preprocess/general_helpers.py:17-44``).

    ``seed`` is accepted for API compatibility; the anatomy is fully
    deterministic (structured, not sampled).
    """
    del seed  # anatomy is deterministic by design
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")

    vol = np.zeros((size, size, size), dtype=np.float32)

    # soft-tissue thorax ellipsoid with a smooth boundary
    body = (x / 0.85) ** 2 + (y / 0.75) ** 2 + (z / 0.9) ** 2
    body_in = _soft_inside(body, edge=0.25)
    vol += background_val * body_in

    # lungs: two symmetric low-attenuation ellipsoids carved out of the body
    for sx in (-1.0, 1.0):
        lung = (
            ((x - 0.38 * sx) / 0.30) ** 2
            + ((y - 0.08) / 0.34) ** 2
            + (z / 0.62) ** 2
        )
        vol -= 0.75 * background_val * _soft_inside(lung, edge=0.35) * body_in

    # spine: posterior column along z with a Gaussian cross-section
    spine_r2 = x**2 + (y + 0.52) ** 2
    z_extent = _soft_inside((z / 0.85) ** 2, edge=0.3)
    vol += bone_val * np.exp(-spine_r2 / (2 * 0.11**2)) * z_extent

    # sternum: smaller anterior column (scaled with the ribs: thin
    # anterior bone is the other high-frequency background structure)
    sternum_r2 = x**2 + (y - 0.62) ** 2
    vol += rib_scale * 0.6 * bone_val * np.exp(
        -sternum_r2 / (2 * 0.07**2)
    ) * _soft_inside((z / 0.55) ** 2, edge=0.3)

    # ribs: symmetric Gaussian tube arcs hugging the body surface at four
    # heights, sloping slightly downward toward the front like real ribs
    phi_grid = np.arctan2(x, -(y + 0.05))  # 0 at the back, +/-pi at front
    for z0 in (-0.55, -0.2, 0.15, 0.5):
        z_c = z0 + 0.10 * (np.abs(phi_grid) / np.pi)
        ring = (x / 0.74) ** 2 + ((y + 0.05) / 0.66) ** 2
        tube2 = (np.sqrt(np.maximum(ring, 1e-12)) - 1.0) ** 2 * 0.45 + (
            (z - z_c) / 1.6
        ) ** 2
        rib = np.exp(-tube2 / (2 * 0.035**2))
        # leave a cartilage gap at the very front (|phi| near pi)
        rib *= _soft_inside((np.abs(phi_grid) / 2.55) ** 2, edge=0.2)
        # rib_scale < 1 softens the thin high-frequency rib arcs — they
        # are the structure that caps extreme-sparse-view background
        # reconstruction (cf. the round-1 random-blob lesson above)
        vol += rib_scale * 0.8 * bone_val * rib

    # heart: smooth ellipsoid, slightly left-of-center, hosting the vessel
    heart = (
        ((x - 0.12) / 0.38) ** 2
        + ((y - 0.12) / 0.33) ** 2
        + ((z + 0.08) / 0.38) ** 2
    )
    vol += 0.7 * background_val * _soft_inside(heart, edge=0.35)

    # dynamic vessel: distance to polyline centerline below radius
    vessel = _vessel_mask(x, y, z, phase, vessel_radius, motion_scale,
                          vessel_extent)
    vol = np.where(vessel, np.float32(lca_val), vol)

    if smooth_sigma > 0:
        # soften remaining hard edges (the vessel paste-in): real anatomy
        # (XCAT/CCTA volumes) has smooth attenuation transitions, and a
        # coordinate MLP cannot represent hard discontinuities — unsmoothed
        # edges put an irreducible floor under reconstruction error
        from scipy.ndimage import gaussian_filter

        vol = gaussian_filter(vol, sigma=smooth_sigma).astype(np.float32)

    return vol


def synthetic_vessel_volume(
    size: int = 64,
    phase: float = 0.0,
    lca_val: float = 1.2,
    vessel_radius: float = 0.045,
    smooth_sigma: float = 1.0,
    motion_scale: float = 1.0,
    vessel_extent: float = 1.0,
) -> np.ndarray:
    """Vessel-ONLY attenuation volume at ``phase`` — the dynamic component's
    ground truth, analogous to the XCAT pipeline's artery volume
    ``|full - noarteries|`` (``preprocess/xcat.py:115-117``). Exactly the
    voxels the composite volume pins to ``lca_val``, zero elsewhere, with
    the same smoothing."""
    lin = np.linspace(-1.0, 1.0, size, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    vessel = _vessel_mask(x, y, z, phase, vessel_radius, motion_scale,
                          vessel_extent)
    vol = np.where(vessel, np.float32(lca_val), np.float32(0.0)).astype(
        np.float32
    )
    if smooth_sigma > 0:
        from scipy.ndimage import gaussian_filter

        vol = gaussian_filter(vol, sigma=smooth_sigma).astype(np.float32)
    return vol


def synthetic_phantom_series(size: int = 64, num_phases: int = NUM_PHASES,
                             **kwargs) -> list[np.ndarray]:
    """All cardiac phases, ``phase = i / num_phases`` (the reference's
    0..9 -> 0.0..0.9 convention, ``preprocess/datatoray.py:51-56``)."""
    return [synthetic_phantom_volume(size=size, phase=i / num_phases, **kwargs)
            for i in range(num_phases)]
