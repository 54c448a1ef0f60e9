"""CCTA (MAGIX) volume pipeline: clinical 4D-CT + segmentations -> training
volumes (port of ``nerfca_tpu/data/ccta.py``: the same numpy/scipy calls on
the host, so both packages write the same volumes bit for bit).

Reference parity: ``preprocess/preprocess_ccta.py`` — per cardiac phase:

  1. read the raw CT volume, the LCA segmentation, and the total-anatomy
     segmentation (nrrd via SimpleITK, imported lazily: ``read_nrrd``
     raises ``ImportError`` without it; any loader producing arrays works);
  2. Hounsfield -> linear attenuation (``preprocess_ccta.py:7-12``);
  3. resample to isotropic 1 mm by zooming with the voxel spacing
     (``:58-62``);
  4. flatten the aorta to the mean heart intensity so the contrast-filled
     aorta doesn't mask the coronaries (``:64-66``), optional rib scaling;
  5. vessel conditioning: dilate/erode the LCA mask, Euclidean distance
     transform, Gaussian smoothing, and a piecewise-linear transfer
     function scaled by ``contrast_f = 0.05`` — giving the vessel a smooth
     attenuation profile mimicking the XCAT values (``:80-122``);
  6. composite the conditioned vessel back over the background and write
     ``full_volume.npy`` / ``volume-shape.npy`` / ``spacing.npy``
     (``:127-147``) plus ``full_volume_tigre.npy`` for the dataset builder.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from scipy.ndimage import (
    binary_dilation,
    binary_erosion,
    distance_transform_edt,
    gaussian_filter,
    zoom,
)

TOTAL_LABELS = {"heart": 51, "aorta": 52, "ribs": np.arange(79, 118)}


def hounsfield_to_attenuation(
    vol, mu_water: float = 0.1494 * 2.5e-2, mu_air: float = 0.0430 * 2.5e-2
):
    """HU -> linear attenuation (``preprocess_ccta.py:7-12``)."""
    vol = np.asarray(vol, np.float64) / 1000.0
    vol = vol * (mu_water - mu_air)
    return vol + mu_water


def read_nrrd(path: str):
    """Read an nrrd image -> (array, spacing). Requires SimpleITK, which is
    optional in this image; raises a clear error when absent."""
    try:
        import SimpleITK as sitk  # type: ignore
    except ImportError as e:
        raise ImportError(
            "SimpleITK is required to read nrrd volumes; install it or pass "
            "arrays directly to preprocess_ccta_volume"
        ) from e
    img = sitk.ReadImage(path)
    return sitk.GetArrayFromImage(img), np.array(img.GetSpacing())[::-1]


def condition_vessel(
    raw: np.ndarray,
    lca_mask: np.ndarray,
    spacing: Sequence[float] = (1, 1, 1),
    dilation_iters: int = 3,
    erosion_iters: int = 1,
    gauss_sigma: float = 1.0,
    gauss_radius: int = 2,
    contrast_f: float = 0.05,
):
    """Distance-transform vessel conditioning (``preprocess_ccta.py:80-122``).

    Returns ``(vessel_volume, conditioned_mask)``: the vessel gets a smooth
    centerline-peaked attenuation profile via EDT + Gaussian + the
    reference's piecewise transfer function scaled to ``contrast_f``.
    """
    mask = binary_erosion(
        binary_dilation(lca_mask > 0, iterations=dilation_iters).astype(int),
        iterations=erosion_iters,
    ).astype(int)
    dist = distance_transform_edt(mask, sampling=np.asarray(spacing))
    dist = gaussian_filter(dist, sigma=gauss_sigma, radius=gauss_radius)

    xp = np.array([0, 1, 2, 4, 5], np.float64)
    fp = np.array([0, 0.2, 0.5, 0.75, 1], np.float64) * contrast_f
    transfer = np.interp(dist, xp, fp)

    vessel = np.zeros_like(raw)
    vessel[lca_mask > 0] = np.abs(raw[lca_mask > 0])
    vessel[mask > 0] = transfer[mask > 0]
    return vessel, mask


def preprocess_ccta_volume(
    raw: np.ndarray,
    lca_mask: np.ndarray,
    total_seg: np.ndarray,
    spacing: Sequence[float],
    rib_factor: float = 1.0,
    contrast_f: float = 0.05,
    return_dyn: bool = False,
):
    """One phase: arrays in, conditioned attenuation volume out.

    ``return_dyn=True`` additionally returns the conditioned VESSEL-ONLY
    volume (the dynamic component's ground truth, analogous to the XCAT
    pipeline's extracted artery volume ``preprocess/xcat.py:115-117``) —
    resampled and conditioned identically to its appearance in the
    composite volume."""
    raw = hounsfield_to_attenuation(raw)

    # isotropic resample by spacing (preprocess_ccta.py:58-62)
    sp = np.asarray(spacing, np.float64)
    if not np.allclose(sp, 1.0):
        raw = zoom(raw, sp)
        lca_mask = zoom(lca_mask, sp, order=0)
        total_seg = zoom(total_seg, sp, order=0)

    # flatten the aorta to mean heart intensity (:64-66)
    heart = total_seg == TOTAL_LABELS["heart"]
    aorta = total_seg == TOTAL_LABELS["aorta"]
    if heart.any() and aorta.any():
        raw[aorta] = raw[heart].mean()

    if rib_factor != 1.0:
        for rib_val in TOTAL_LABELS["ribs"]:
            raw[total_seg == rib_val] *= rib_factor

    vessel, cond_mask = condition_vessel(raw, lca_mask, contrast_f=contrast_f)

    full = np.where(cond_mask > 0, vessel, np.where(lca_mask > 0, vessel, raw))
    if return_dyn:
        dyn = np.where(
            cond_mask > 0, vessel, np.where(lca_mask > 0, vessel, 0.0)
        )
        return full.astype(np.float32), dyn.astype(np.float32)
    return full.astype(np.float32)


def preprocess_ccta(
    rawdata_path: str,
    segmentation_path: str,
    store_path: str,
    raw_data_name: str,
    volume_ids: Optional[Sequence[int]] = None,
    contrast_f: float = 0.05,
) -> None:
    """Full directory pipeline over all cardiac phases
    (``preprocess_ccta.py:19-147``), preserving the reference's file-name
    contract (``<name> <pct> %[.seg| total.seg].nrrd``) and output artifact
    names."""
    volume_ids = list(volume_ids) if volume_ids is not None else list(range(10))
    for vid in volume_ids:
        out_dir = os.path.join(store_path, str(vid))
        os.makedirs(out_dir, exist_ok=True)

        raw, spacing = read_nrrd(
            os.path.join(rawdata_path, f"{raw_data_name} {vid * 10} %.nrrd")
        )
        lca, _ = read_nrrd(
            os.path.join(segmentation_path, f"{raw_data_name} {vid * 10} % lca.seg.nrrd")
        )
        total, _ = read_nrrd(
            os.path.join(
                segmentation_path, f"{raw_data_name} {vid * 10} % total.seg.nrrd"
            )
        )

        full = preprocess_ccta_volume(raw, lca, total, spacing, contrast_f=contrast_f)

        np.save(os.path.join(out_dir, "spacing.npy"), np.ones(3))
        np.save(
            os.path.join(out_dir, "volume-shape.npy"),
            np.array(full.shape)[::-1],
        )
        np.save(os.path.join(out_dir, "full_volume.npy"), full.flatten())
        np.save(os.path.join(out_dir, "full_volume_tigre.npy"), full)
