"""Volume I/O: npy grid loading and VTK export, dependency-free (port of
``nerfca_tpu/data/volume_io.py``, numpy only, unchanged).

Reference parity: ``preprocess/general_helpers.py:46-67`` (``load_vol_grid``
/ ``np_to_vtk``) and the ``.vtk`` debug dumps scattered through the XCAT and
CCTA pipelines. The VTK writer emits the legacy STRUCTURED_POINTS format
directly — readable by ParaView/VTK/pyvista — with no dependency beyond
numpy.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def load_volume(
    vol_file_name: str,
    dimensions: Sequence[int],
    case_folder_name: str = ".",
) -> np.ndarray:
    """Load a (possibly flattened) ``.npy`` volume and shape it to
    ``dimensions`` (``general_helpers.py:46-51`` without the pyvista grid)."""
    vol = np.load(os.path.join(case_folder_name, vol_file_name))
    return vol.reshape(tuple(dimensions))


def save_vtk(
    path: str,
    volume: np.ndarray,
    spacing: Sequence[float] = (1.0, 1.0, 1.0),
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    name: str = "scalars",
) -> None:
    """Write a legacy-VTK STRUCTURED_POINTS file (binary, big-endian floats
    per the VTK spec)."""
    vol = np.asarray(volume, dtype=np.float32)
    nx, ny, nz = vol.shape
    header = "\n".join(
        [
            "# vtk DataFile Version 3.0",
            "nerfca_tpu volume",  # the JAX writer's title: both write the same bytes
            "BINARY",
            "DATASET STRUCTURED_POINTS",
            f"DIMENSIONS {nx} {ny} {nz}",
            f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}",
            f"ORIGIN {origin[0]} {origin[1]} {origin[2]}",
            f"POINT_DATA {nx * ny * nz}",
            f"SCALARS {name} float 1",
            "LOOKUP_TABLE default",
            "",
        ]
    )
    # VTK point order is x-fastest: transpose (x,y,z) -> (z,y,x) then ravel
    data = np.ascontiguousarray(vol.transpose(2, 1, 0)).astype(">f4")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(data.tobytes())


def read_vtk(path: str) -> tuple[np.ndarray, dict]:
    """Read back a STRUCTURED_POINTS file written by :func:`save_vtk`."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.index(b"LOOKUP_TABLE default\n") + len(b"LOOKUP_TABLE default\n")
    header = raw[:head_end].decode()
    meta = {}
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "DIMENSIONS":
            meta["dimensions"] = [int(v) for v in parts[1:4]]
        elif parts[0] == "SPACING":
            meta["spacing"] = [float(v) for v in parts[1:4]]
        elif parts[0] == "ORIGIN":
            meta["origin"] = [float(v) for v in parts[1:4]]
    nx, ny, nz = meta["dimensions"]
    data = np.frombuffer(raw[head_end:], dtype=">f4", count=nx * ny * nz)
    vol = data.reshape(nz, ny, nx).transpose(2, 1, 0).astype(np.float32)
    return vol, meta


def normalize(img: np.ndarray):
    """Min-max normalize; returns (normalized, min, max)
    (``general_helpers.py:62-67``)."""
    lo, hi = float(np.min(img)), float(np.max(img))
    if hi == lo:
        return np.zeros_like(img), lo, hi
    return (img - lo) / (hi - lo), lo, hi
