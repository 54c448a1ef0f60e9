"""XCAT phantom pipeline: drive the external generator binary and extract
the left coronary artery (LCA). Port of ``nerfca_tpu/data/xcat.py`` (numpy
on the host, the same calls, so both packages write the same files).

The XCAT generator (``dxcat1_bin``) is proprietary and cannot be rebuilt;
this module keeps the reference's DRIVER CONTRACT (``preprocess/xcat.py``)
so existing XCAT installations work, while everything around the binary is
re-implemented:

  - ``phases.json`` registry of (heart phase, resp phase) -> run id
    (``xcat.py:61-88``);
  - ``.samp.par`` parameter-file override of the phase fields
    (``xcat.py:96-109``) — the value replaces the text before the first tab;
  - subprocess invocation per {volume, noarteries} parameter set
    (``xcat.py:32-49,90-94``);
  - raw ``512x512x401 float32`` bin loading (``xcat.py:111-113``);
  - artery volume = |full - noarteries| (``xcat.py:115-117``);
  - LCA crop to the bounding box ``[[0,280],[250,500],[0,260]]`` in grid
    units with the artery value pinned to ``lca_val`` (``xcat.py:119-158``;
    vectorized here — the reference builds a pyvista grid to do an index
    intersection that reduces to a boolean mask);
  - LCA bounding-box center (``xcat.py:160-192``).

Without the binary, ``prepare_and_run_xcat`` raises ``FileNotFoundError``
unless the bin artifacts already exist on disk. The stand-in generator
``nerfca_tpu_torch/data/dxcat_surrogate_bin.py`` (installed as
``<xcat_path>/dxcat1_bin``) drives the contract end to end.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

XCAT_DIMENSIONS = (512, 512, 401)
LCA_BOUNDS = np.array([[0, 280], [250, 500], [0, 260]])


def load_xcat_bin(path: str, dimensions: Sequence[int] = XCAT_DIMENSIONS) -> np.ndarray:
    """Raw float32 attenuation volume (``xcat.py:111-113``)."""
    return np.fromfile(path, dtype=np.float32).reshape(*dimensions)


def override_param_file(
    src_path: str, dst_path: str, overrides: dict[str, float]
) -> None:
    """Rewrite ``.samp.par`` lines whose text contains an override key.

    Matches the reference convention (``xcat.py:96-109``): the new value is
    prepended to the tab-separated remainder of the first matching line.
    """
    with open(src_path) as f:
        lines = [line.rstrip("\n") for line in f]
    for key, value in overrides.items():
        for i, line in enumerate(lines):
            if key in line:
                parts = line.split("\t")
                tail = "\t".join(parts[1:]) if len(parts) > 1 else ""
                lines[i] = f"{value}\t{tail}" if tail else str(value)
                break
        else:
            raise KeyError(f"parameter {key!r} not found in {src_path}")
    with open(dst_path, "w") as f:
        for line in lines:
            f.write(line + "\n")


def run_xcat_binary(xcat_path: str, par_file: str, save_name: str) -> None:
    """Invoke the generator binary (``xcat.py:90-94``). The binary name is
    platform-dependent; both the Windows name the reference uses and a
    bare ``dxcat1_bin`` are tried."""
    for exe in ("dxcat1_bin", "dxcat1_bin.exe"):
        candidate = os.path.join(xcat_path, exe) if xcat_path else exe
        try:
            subprocess.run(
                [candidate, par_file, save_name],
                cwd=xcat_path or None,
                check=True,
                capture_output=True,
            )
            return
        except FileNotFoundError:
            continue
    raise FileNotFoundError(
        "XCAT generator binary not found (proprietary; install separately). "
        "Pre-generated *_atn_1.bin artifacts are used when present."
    )


def extract_artery_volume(full_vol: np.ndarray, no_artery_vol: np.ndarray) -> np.ndarray:
    """Arteries = |with - without| (``xcat.py:115-117``)."""
    return np.abs(full_vol - no_artery_vol)


def extract_lca(
    full_vol: np.ndarray,
    artery_vol: np.ndarray,
    lca_val: float = 0.15,
    bounds: np.ndarray = LCA_BOUNDS,
) -> tuple[np.ndarray, np.ndarray]:
    """Crop the LCA by grid-space bounding box and pin its attenuation.

    Returns ``(full_vol_with_lca_pinned, lca_only_vol)``. Vectorized
    equivalent of ``xcat.py:119-158``: a voxel belongs to the LCA iff its
    grid coordinate lies inside ``bounds`` on every axis AND the artery
    difference volume is positive there.
    """
    dims = full_vol.shape
    mask = artery_vol > 0
    for axis, (lo, hi) in enumerate(np.asarray(bounds)):
        coords = np.linspace(0, dims[axis], dims[axis])
        axis_ok = (coords >= lo) & (coords <= hi)
        shape = [1, 1, 1]
        shape[axis] = dims[axis]
        mask &= axis_ok.reshape(shape)

    full_out = full_vol.copy()
    full_out[mask] = lca_val
    lca_vol = np.zeros_like(full_vol)
    lca_vol[mask] = lca_val
    return full_out, lca_vol


def lca_bounding_box_center(
    lca_vol: np.ndarray, spacing: Optional[Sequence[float]] = None
) -> list[float]:
    """Center of the occupied bounding box in grid units
    (``xcat.py:160-192``, reduced to a min/max over occupied indices)."""
    occ = np.argwhere(lca_vol > 0)
    if occ.size == 0:
        return [0.0, 0.0, 0.0]
    spacing = np.ones(3) if spacing is None else np.asarray(spacing)
    lo = occ.min(axis=0) * spacing
    hi = occ.max(axis=0) * spacing
    return ((lo + hi) / 2).tolist()


def find_phase_id(phases_lst: list, hrt_phase: float, resp_phase: float):
    """Registry lookup (``xcat.py:76-88``): existing entry or next id."""
    for obj in phases_lst:
        if (
            round(obj["hrt_phase"], 4) == round(hrt_phase, 4)
            and round(obj["resp_phase"], 4) == round(resp_phase, 4)
        ):
            return obj, obj["id"]
    return {}, len(phases_lst)


def prepare_and_run_xcat(
    hrt_phase: float,
    resp_phase: float,
    xcat_path: str,
    hrt_str: str = "hrt_start_phase_index",
    resp_str: str = "resp_start_phase_index",
    lca_val: float = 0.15,
    dimensions: Sequence[int] = XCAT_DIMENSIONS,
    lca_bounds: Optional[np.ndarray] = None,
) -> dict:
    """Full per-phase pipeline: registry -> param override -> binary ->
    bin load -> LCA extraction -> registry update (``xcat.py:10-74``).

    Also writes ``full_volume_tigre.npy`` (the volume with the LCA pinned,
    in the layout the dataset builder consumes) next to the reference's
    ``full_volume.npy``/``lca.npy`` artifacts.
    """
    phase_info_path = os.path.join(xcat_path, "phases.json")
    phases_lst = []
    if os.path.isfile(phase_info_path):
        with open(phase_info_path) as f:
            phases_lst = json.load(f)

    curr_obj, run_id = find_phase_id(phases_lst, hrt_phase, resp_phase)
    run_path = os.path.join(xcat_path, str(run_id))
    os.makedirs(run_path, exist_ok=True)

    for name in ("volume", "noarteries"):
        par_src = os.path.join(xcat_path, f"{name}.samp.par")
        par_dst = os.path.join(run_path, f"{name}.samp.par")
        bin_path = os.path.join(run_path, f"{name}_atn_1.bin")
        if not os.path.isfile(bin_path):
            override_param_file(
                par_src, par_dst, {hrt_str: hrt_phase, resp_str: resp_phase}
            )
            run_xcat_binary(
                xcat_path,
                os.path.join(str(run_id), f"{name}.samp.par"),
                os.path.join(str(run_id), name),
            )

    full_vol = load_xcat_bin(os.path.join(run_path, "volume_atn_1.bin"), dimensions)
    no_artery = load_xcat_bin(
        os.path.join(run_path, "noarteries_atn_1.bin"), dimensions
    )
    artery = extract_artery_volume(full_vol, no_artery)
    # the reference's crop box is in 512x512x401 grid units; scale it when
    # the caller runs reduced dimensions (tests) so the box stays the same
    # anatomical region
    if lca_bounds is None:
        scale = np.asarray(dimensions, np.float64) / np.asarray(
            XCAT_DIMENSIONS, np.float64
        )
        lca_bounds = (LCA_BOUNDS * scale[:, None]).astype(np.float64)
    full_pinned, lca_vol = extract_lca(
        full_vol, artery, lca_val, bounds=lca_bounds
    )

    np.save(os.path.join(run_path, "full_volume.npy"), full_pinned.flatten())
    np.save(os.path.join(run_path, "lca.npy"), lca_vol.flatten())
    np.save(os.path.join(run_path, "full_volume_tigre.npy"), full_pinned)
    # the extracted-LCA volume in projector layout: the dataset builder's
    # dynamic-GT provider reads <phase>/dyn_volume_tigre.npy to project the
    # decomposition ground truth (dataset.py::_default_dynamic_provider)
    np.save(os.path.join(run_path, "dyn_volume_tigre.npy"), lca_vol)

    center = lca_bounding_box_center(lca_vol)
    new_obj = {
        "id": run_id,
        "hrt_phase": hrt_phase,
        "resp_phase": resp_phase,
        "bounding_box_center": center,
    }
    if curr_obj:
        phases_lst[run_id] = new_obj
    else:
        phases_lst.append(new_obj)
    with open(phase_info_path, "w") as f:
        json.dump(phases_lst, f)
    return new_obj
