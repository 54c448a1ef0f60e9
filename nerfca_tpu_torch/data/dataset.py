"""Dataset builder (port of ``nerfca_tpu/data/dataset.py``).

Projects every train/test viewpoint of each phase's volume with the torch
cone-beam projector (on the chosen device) and writes the same artifact
contract as the JAX builder to ``data/<name>/<size>/``, so either package
reads the other's dataset. The acquisition preset follows the data family
(``SYNTH*``, ``XCAT*``, ``MAGIX*``/``CCTA*``). Volumes come from (in order
of preference) a ``volume_provider`` callable,
``<volume_root>/<phase>/full_volume_tigre.npy`` on disk (the XCAT/CCTA
pipelines' output contract), or the built-in synthetic phantom for the
SYNTH family; any other family without a volume on disk raises
``FileNotFoundError``. A phase's artery-only volume comes likewise from
``dynamic_volume_provider``, ``dyn_volume_tigre.npy`` beside the volume, or
the SYNTH vessel phantom, and is None for a phase that has none (a real
CCTA scan): such a phase writes no ``-dyn.npy``. The builder writes:

  - ``general.json``: scaled geometry + near/far + log max_pixel_value;
  - per-view ``image-hrt=<p>-resp=<r>-angles=<t>-<f>.npy`` (min-max
    normalized log-transmission, stored transposed) and ``.png``;
  - ``<image>-dyn.npy`` artery-only line integrals for test views;
  - ``train-*.json`` / ``test-*.json`` / ``evaluate.json`` frame lists,
    from the view selection or, with ``--use_experiment_name``, from the
    experiment json ``<root>/<data_name>/experiments/<name>.json`` or
    ``configs/experiments/<name>.json``;
  - per-viewpoint temporal variance maps ``image-<t>-<f>-var.npy``/``.png``
    (weights in [1, 2]) when all 10 phases are processed;
  - ``srcmatrices.json`` with the per-view 4x4 poses;
  - with ``--only_prepare_data`` (or ``write_mip``), the test views'
    maximum-intensity projections ``<image>-mip.npy``/``.png``;
  - with ``--visualize_geometry``, ``geometry.png``, the plot of the first
    phase's acquisition.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from nerfca_tpu_torch.data.phantom import synthetic_phantom_volume, synthetic_vessel_volume
from nerfca_tpu_torch.data.views import load_experiment_views, select_views
from nerfca_tpu_torch.geometry.cone import (
    MAX_PIXEL_VALUE, SCALE_FACTOR, ConeGeometry, ccta_geometry, get_near_far, synth_geometry,
    xcat_geometry,
)
from nerfca_tpu_torch.geometry.rays import pose_matrix
from nerfca_tpu_torch.ops.projector import project_view, transmission_image


@dataclasses.dataclass
class DatasetPaths:
    folder: str
    general: str
    train: str
    test: str
    evaluate: str
    srcmatrices: str


def parse_selection_views(spec) -> Optional[tuple]:
    """'t,p' or 't1,p1;t2,p2;...' -> ((t, p), ...); None/empty -> None."""
    if spec is None or (isinstance(spec, str) and not spec.strip()):
        return None
    if isinstance(spec, (tuple, list)):
        pairs = [spec] if not isinstance(spec[0], (tuple, list)) else list(spec)
    else:
        pairs = [s.split(",") for s in str(spec).split(";") if s.strip()]
    return tuple((float(t), float(p)) for t, p in pairs) or None


def _experiment_tag(args) -> str:
    if getattr(args, "use_experiment_name", False) and getattr(args, "experiment_name", None):
        return args.experiment_name
    tag = (
        f"{float(args.data_limited_range)}-{float(args.data_step_size)}"
        f"-{args.data_time_range_start}-{args.data_time_range_end}"
    )
    sel = parse_selection_views(getattr(args, "selection_view", None))
    if sel is not None:
        for t, p in sel:
            tag += f"-sel{t:g}-{p:g}"
    return tag


def dataset_paths(args, root: str = "data") -> DatasetPaths:
    folder = os.path.join(root, str(args.data_name), str(args.data_size))
    tag = _experiment_tag(args)
    return DatasetPaths(
        folder=folder,
        general=os.path.join(folder, "general.json"),
        train=os.path.join(folder, f"train-{tag}.json"),
        test=os.path.join(folder, f"test-{tag}.json"),
        evaluate=os.path.join(folder, "evaluate.json"),
        srcmatrices=os.path.join(folder, "srcmatrices.json"),
    )


def _geometry_for(args, vol_dimensions) -> dict:
    """The acquisition preset of ``args.data_name``'s family."""
    name = str(args.data_name)
    if name.startswith("SYNTH"):
        return synth_geometry(int(args.data_size), list(vol_dimensions))
    if name.startswith("XCAT"):
        return xcat_geometry(int(args.data_size), list(vol_dimensions))
    if name.startswith("MAGIX") or name.startswith("CCTA"):
        return ccta_geometry(int(args.data_size), list(vol_dimensions))
    raise ValueError(f"unknown data_name family: {name!r}")


def _phantom_kwargs(args, vessel: bool = False) -> dict:
    kw = {
        "lca_val": float(getattr(args, "synth_lca_val", 1.2)),
        "vessel_radius": float(getattr(args, "synth_vessel_radius", 0.045)),
        "motion_scale": float(getattr(args, "synth_motion_scale", 1.0)),
        "smooth_sigma": float(getattr(args, "synth_smooth_sigma", 1.0)),
        "vessel_extent": float(getattr(args, "synth_vessel_extent", 1.0)),
    }
    if not vessel:
        kw["rib_scale"] = float(getattr(args, "synth_rib_scale", 1.0))
    return kw


def _default_volume_provider(args) -> Callable[[int], np.ndarray]:
    """A phase's volume: ``<volume_root>/<phase>/full_volume_tigre.npy``
    when it exists, else the synthetic phantom's for the SYNTH family;
    ``FileNotFoundError`` for any other family
    (``nerfca_tpu/data/dataset.py:128-148``)."""
    root = getattr(args, "volume_root", None)
    size = int(getattr(args, "synth_vol_size", 64))

    def provider(int_phase: int) -> np.ndarray:
        if root:
            path = os.path.join(root, str(int_phase), "full_volume_tigre.npy")
            if os.path.isfile(path):
                return np.load(path)
        if str(args.data_name).startswith("SYNTH"):
            return synthetic_phantom_volume(size=size, phase=int_phase / 10,
                                            **_phantom_kwargs(args))
        raise FileNotFoundError(
            f"no volume for phase {int_phase}: set volume_root to a directory "
            f"with <phase>/full_volume_tigre.npy or use the SYNTH data family"
        )

    return provider


def _default_dynamic_provider(args) -> Callable[[int], Optional[np.ndarray]]:
    """A phase's dynamic (artery-only) volume:
    ``<volume_root>/<phase>/dyn_volume_tigre.npy`` when it exists, else the
    synthetic vessel phantom's for the SYNTH family, else None (no ground
    truth of the dynamic component, as for a real CCTA scan;
    ``nerfca_tpu/data/dataset.py:150-174``)."""
    root = getattr(args, "volume_root", None)
    size = int(getattr(args, "synth_vol_size", 64))

    def provider(int_phase: int) -> Optional[np.ndarray]:
        if root:
            path = os.path.join(root, str(int_phase), "dyn_volume_tigre.npy")
            if os.path.isfile(path):
                return np.load(path)
        if str(args.data_name).startswith("SYNTH"):
            return synthetic_vessel_volume(size=size, phase=int_phase / 10,
                                           **_phantom_kwargs(args, vessel=True))
        return None

    return provider


def _experiment_views(args, root: str) -> list[dict]:
    """The curated per-phase view list of ``args.experiment_name``: the json
    beside the dataset, else under ``configs/experiments/``."""
    candidates = [
        os.path.join(root, str(args.data_name), "experiments", f"{args.experiment_name}.json"),
        os.path.join("configs", "experiments", f"{args.experiment_name}.json"),
    ]
    for cand in candidates:
        if os.path.isfile(cand):
            return load_experiment_views(cand)
    raise FileNotFoundError(
        f"use_experiment_name set but no experiment json found at {candidates}"
    )


def _save_png(path: str, img: np.ndarray, cmap: str = "gray") -> None:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.imsave(path, img, cmap=cmap)
    except Exception:
        pass  # PNGs are a debugging convenience, never load-bearing


def _store_frame(image_id, image_id_str, img_min, img_max, view_key, resp_phase,
                 int_hrt_phase, hrt_phase, theta, phi, larm, folder) -> dict:
    return {
        "image_id_str": image_id_str,
        "image_id": image_id,
        "file_path": os.path.join(folder, f"{image_id_str}.npy"),
        "img_min_max": [float(img_min), float(img_max)],
        "weighted_file_path": os.path.join(folder, f"image-{view_key}-var.npy"),
        "resp_phase": resp_phase,
        "heart_phase": int_hrt_phase,
        "org_heart_phase": int(hrt_phase),
        "theta": float(theta),
        "phi": float(phi),
        "larm": float(larm),
    }


def build_dataset(args, root: str = "data",
                  volume_provider: Optional[Callable[[int], np.ndarray]] = None,
                  projector_samples: int = 1000, write_mip: bool = False,
                  dynamic_volume_provider: Optional[Callable[[int], Optional[np.ndarray]]] = None,
                  device=None) -> DatasetPaths:
    """Generate the dataset on disk; projections run on ``device``. The
    providers map an integer phase to its volume (and artery-only volume,
    or None); the defaults read ``--volume_root`` or make the SYNTH
    phantom. A pure data-preparation pass (``args.only_prepare_data``) or
    ``write_mip`` also writes the test views' maximum-intensity
    projections."""
    paths = dataset_paths(args, root)
    os.makedirs(paths.folder, exist_ok=True)
    volume = volume_provider or _default_volume_provider(args)
    dyn_volume_of = dynamic_volume_provider or _default_dynamic_provider(args)

    first_phase = int(args.data_time_range_start)
    vol0 = np.asarray(volume(first_phase), dtype=np.float32)
    geo = ConeGeometry.from_dict(_geometry_for(args, vol0.shape), SCALE_FACTOR)
    near, far = get_near_far(geo)
    info = geo.to_info_dict()
    info["near_thresh"] = near
    info["far_thresh"] = far
    info["max_pixel_value"] = float(np.log(MAX_PIXEL_VALUE))
    with open(paths.general, "w") as fp:
        json.dump(info, fp)

    if getattr(args, "use_experiment_name", False):
        phase_list = _experiment_views(args, root)
    else:
        phase_list = select_views(
            limited_range=float(args.data_limited_range),
            step_size=float(args.data_step_size),
            numb_angles=getattr(args, "data_numb_angles", None),
            time_range_start=int(args.data_time_range_start),
            time_range_end=int(args.data_time_range_end),
            limited_range_test=getattr(args, "data_limited_range_test", None),
            step_size_test=getattr(args, "data_step_size_test", None),
            selection_view=parse_selection_views(getattr(args, "selection_view", None)),
        )

    if getattr(args, "visualize_geometry", False) and phase_list:
        # the scene plot of the first phase's acquisition
        from nerfca_tpu_torch.utils.visualize import visualize_geometry

        half = 0.5 * np.asarray(info["nVoxel"]) * np.asarray(info["dVoxel"])
        off = np.asarray(info["offOrigin"])
        visualize_geometry(phase_list[0]["train_viewpoints"], info,
                           volume_bounds=np.stack([off - half, off + half], axis=-1),
                           save_path=os.path.join(paths.folder, "geometry.png"))
    write_mip = write_mip or bool(getattr(args, "only_prepare_data", False))

    def on_device(vol):  # one upload a volume, not one a view
        return torch.as_tensor(vol, dtype=torch.float32, device=device)

    def project(vol, theta, phi, mode="ct"):
        return project_view(vol, info, float(theta), float(phi), 0.0,
                            n_samples=projector_samples, mode=mode, device=device).cpu().numpy()

    train_frames: list[dict] = []
    test_frames: list[dict] = []
    src_matrices: dict[str, list] = {}
    per_view_integrals: dict[str, list[np.ndarray]] = {}
    image_id = 0
    for phase_obj in phase_list:
        hrt_phase = phase_obj["hrt_phase"]
        int_hrt = int(round(hrt_phase * 10))
        resp = phase_obj["resp_phase"]
        vol = on_device(vol0 if int_hrt == first_phase else volume(int_hrt))

        def process_view(theta, phi, frames):
            nonlocal image_id
            view_key = f"{theta}-{phi}"
            image_id_str = f"image-hrt={int_hrt}-resp={int(resp)}-angles={view_key}"
            line_integral = project(vol, theta, phi)
            norm_img, img_min, img_max = transmission_image(line_integral, MAX_PIXEL_VALUE)
            # saved transposed so the loader's reshape(W,H).T round-trips
            np.save(os.path.join(paths.folder, f"{image_id_str}.npy"), norm_img.T)
            _save_png(os.path.join(paths.folder, f"{image_id_str}.png"), norm_img)
            per_view_integrals.setdefault(view_key, []).append(line_integral)
            src_matrices[view_key] = pose_matrix(float(theta), float(phi), 0.0, geo.DSO).tolist()
            frames.append(_store_frame(
                image_id, image_id_str, img_min, img_max, view_key, resp, int_hrt,
                hrt_phase * 10, theta, phi, 0.0, paths.folder,
            ))
            image_id += 1
            return image_id_str

        for theta, phi in np.asarray(phase_obj["train_viewpoints"]):
            process_view(theta, phi, train_frames)
        dyn_volume, dyn_checked = None, False
        for theta, phi in np.asarray(phase_obj["test_viewpoints"]):
            image_id_str = process_view(theta, phi, test_frames)
            if not dyn_checked:
                dyn_checked = True
                dv = dyn_volume_of(int_hrt)
                dyn_volume = None if dv is None else on_device(dv)
            if dyn_volume is not None:
                dyn_li = project(dyn_volume, theta, phi)
                np.save(os.path.join(paths.folder, f"{image_id_str}-dyn.npy"), dyn_li.T)
                _save_png(os.path.join(paths.folder, f"{image_id_str}-dyn.png"), dyn_li)
            if write_mip:
                mip = project(vol, theta, phi, mode="mip")
                np.save(os.path.join(paths.folder, f"{image_id_str}-mip.npy"), mip)
                _save_png(os.path.join(paths.folder, f"{image_id_str}-mip.png"), mip)

    with open(paths.train, "w") as fp:
        json.dump({"frames": train_frames}, fp)
    with open(paths.test, "w") as fp:
        json.dump({"frames": test_frames}, fp)
    sel = parse_selection_views(getattr(args, "selection_view", None))
    eval_frames = test_frames
    if sel is not None:
        excluded = set(sel)
        eval_frames = [f for f in test_frames
                       if (float(f["theta"]), float(f["phi"])) not in excluded]
    with open(paths.evaluate, "w") as fp:
        json.dump({"frames": eval_frames}, fp)
    with open(paths.srcmatrices, "w") as fp:
        json.dump(src_matrices, fp)
    if int(args.data_time_range_end) - int(args.data_time_range_start) == 10:
        write_variance_maps(per_view_integrals, paths.folder)
    return paths


def write_variance_maps(per_view_integrals: dict, folder: str) -> None:
    """Per-viewpoint temporal variance of the absorption images, min-max
    normalized and shifted to weights in [1, 2], stored transposed."""
    for view_key, integrals in per_view_integrals.items():
        stack = np.stack(integrals, axis=0)
        var_pix = np.ones(stack.shape[1:], dtype=np.float64)
        if stack.shape[0] > 1:
            absorption = np.exp(-stack.reshape(stack.shape[0], -1))
            var = np.var(absorption, axis=0).reshape(stack.shape[1:])
            vmin, vmax = var.min(), var.max()
            var_pix = (var - vmin) / (vmax - vmin + 1e-10)
        _save_png(os.path.join(folder, f"image-{view_key}-var.png"), var_pix, cmap="Reds")
        np.save(os.path.join(folder, f"image-{view_key}-var.npy"), (var_pix + 1).T)
