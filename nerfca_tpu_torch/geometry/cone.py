"""Cone-beam acquisition geometry and the SYNTH, XCAT and CCTA presets.

Port of ``nerfca_tpu/geometry/cone.py`` (numpy, unchanged math). The
geometry is an immutable host-side dataclass; device code receives plain
arrays/scalars derived from it.

Reference parity:
  - ``ConeGeometry``: ``preprocess/tigre_helpers.py:11-42`` — mm -> scaled
    units via ``scale_factor=1e-2``; ``nVoxel`` stored reversed (the TIGRE
    (z, y, x) convention).
  - near/far bound: ``preprocess/tigre_helpers.py:44-56``.
  - the XCAT preset: ``preprocess/tigre_helpers.py:140-173``; the SYNTH
    preset follows it; the MAGIX/CCTA preset: ``:175-206``.
  - ``MAX_PIXEL_VALUE`` / ``SCALE_FACTOR``: ``preprocess/datatoray.py:19-20``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# Calibrated source intensity of the phantom CT generator; images live in
# log space as log(MAX_PIXEL_VALUE) - line_integral.
MAX_PIXEL_VALUE = 8.670397
# mm -> internal units.
SCALE_FACTOR = 1e-2


@dataclasses.dataclass(frozen=True)
class ConeGeometry:
    """Cone-beam CT geometry, all lengths in scaled units (mm * scale_factor).

    ``nVoxel``/``sVoxel`` follow the reference's reversed (z, y, x) storage
    order; ``dVoxel`` and ``offOrigin`` stay in the (x, y, z) order they were
    specified in, mirroring the reference exactly.
    """

    DSD: float  # distance source -> detector
    DSO: float  # distance source -> origin (isocenter)
    nDetector: np.ndarray  # (2,) detector pixels (u, v)
    dDetector: np.ndarray  # (2,) pixel pitch
    sDetector: np.ndarray  # (2,) physical detector size
    nVoxel: np.ndarray  # (3,) voxels, reversed (z, y, x)
    dVoxel: np.ndarray  # (3,) voxel pitch (x, y, z)
    sVoxel: np.ndarray  # (3,) physical volume extent (reversed order * pitch)
    offOrigin: np.ndarray  # (3,) volume offset from isocenter
    offDetector: np.ndarray  # (3,) detector offset
    accuracy: float = 0.5
    mode: str = "cone"
    filter: Optional[str] = None

    @classmethod
    def from_dict(cls, data: dict, scale_factor: float = SCALE_FACTOR) -> "ConeGeometry":
        n_detector = np.asarray(data["nDetector"])
        d_detector = np.asarray(data["dDetector"], dtype=np.float64) * scale_factor
        n_voxel = np.asarray(data["nVoxel"])[::-1]
        d_voxel = np.asarray(data["dVoxel"], dtype=np.float64) * scale_factor
        off_det = data["offDetector"]
        return cls(
            DSD=float(data["DSD"]) * scale_factor,
            DSO=float(data["DSO"]) * scale_factor,
            nDetector=n_detector,
            dDetector=d_detector,
            sDetector=n_detector * d_detector,
            nVoxel=n_voxel,
            dVoxel=d_voxel,
            sVoxel=n_voxel * d_voxel,
            offOrigin=np.asarray(data["offOrigin"], dtype=np.float64) * scale_factor,
            offDetector=np.asarray([off_det[0], off_det[1], 0], dtype=np.float64)
            * scale_factor,
            accuracy=float(data.get("accuracy", 0.5)),
            mode=data.get("mode", "cone"),
            filter=data.get("filter"),
        )

    def to_info_dict(self) -> dict:
        """Flat dict consumed by ray generation (the ``general.json`` shape)."""
        return {
            "DSD": self.DSD,
            "DSO": self.DSO,
            "nDetector": self.nDetector.tolist(),
            "dDetector": self.dDetector.tolist(),
            "nVoxel": self.nVoxel[::-1].tolist(),
            "dVoxel": self.dVoxel.tolist(),
            "offOrigin": self.offOrigin.tolist(),
            "offDetector": self.offDetector.tolist(),
            "accuracy": self.accuracy,
            "mode": self.mode,
            "filter": self.filter,
        }


def get_near_far(geo: ConeGeometry, adjust: float = 0.0) -> tuple[float, float]:
    """Geometric near/far sampling bounds from the volume footprint corners.

    Matches ``preprocess/tigre_helpers.py:44-56`` (itself credited to
    naf_cbct): the max distance from the isocenter offset to the four
    in-plane volume corners bounds the reconstructable region around DSO.
    """
    half = geo.sVoxel / 2
    corners = [
        [geo.offOrigin[0] - half[0], geo.offOrigin[1] - half[1]],
        [geo.offOrigin[0] - half[0], geo.offOrigin[1] + half[1]],
        [geo.offOrigin[0] + half[0], geo.offOrigin[1] - half[1]],
        [geo.offOrigin[0] + half[0], geo.offOrigin[1] + half[1]],
    ]
    dist_max = max(np.linalg.norm(c) for c in corners)
    near = max(0.0, geo.DSO - dist_max - adjust)
    far = min(geo.DSO * 2, geo.DSO + dist_max + adjust)
    return float(near), float(far)


def _detector(family: str, data_size: int) -> tuple[list, list]:
    """The presets' detector: 200 x 200 at 1 mm or 50 x 50 at 4 mm."""
    if data_size == 200:
        return [200, 200], [1, 1]
    if data_size == 50:
        return [50, 50], [4, 4]
    raise ValueError(f"unknown {family} data_size {data_size}; expected 200 or 50")


def _preset(data_size: int, vol_dimensions: Sequence[int], family: str, dsd: float,
            dso: float, d_voxel: float, off_origin: list) -> dict:
    n_det, d_det = _detector(family, data_size)
    return {
        "DSD": dsd,
        "DSO": dso,
        "nDetector": n_det,
        "dDetector": d_det,
        "nVoxel": list(vol_dimensions),
        "dVoxel": [d_voxel, d_voxel, d_voxel],
        "offOrigin": off_origin,
        "offDetector": [0, 0],
        "accuracy": 0.5,
        "mode": "cone",
        "filter": None,
    }


def xcat_geometry(data_size: int, vol_dimensions: Sequence[int]) -> dict:
    """XCAT phantom acquisition preset (``preprocess/tigre_helpers.py:140-173``)."""
    return _preset(data_size, vol_dimensions, "XCAT", 2500, 450, 0.25, [10, -25, 25])


def ccta_geometry(data_size: int, vol_dimensions: Sequence[int]) -> dict:
    """MAGIX/CCTA acquisition preset (``preprocess/tigre_helpers.py:175-206``)."""
    return _preset(data_size, vol_dimensions, "CCTA", 2000, 600, 0.9, [0, 0, 0])


def synth_geometry(data_size: int, vol_dimensions: Sequence[int]) -> dict:
    """Geometry for the built-in synthetic phantom (no reference analog).

    XCAT's source/detector distances, but the voxel pitch scales with the
    grid so the phantom always spans ~128 mm (the XCAT volume's in-plane
    extent, 512 x 0.25 mm) regardless of resolution, and sits centered at
    the isocenter.
    """
    return _preset(data_size, vol_dimensions, "SYNTH", 2500, 450,
                   128.0 / max(vol_dimensions), [0, 0, 0])
