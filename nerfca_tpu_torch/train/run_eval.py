"""Offline evaluation CLI: render held-out views from a checkpoint and score
PSNR/SSIM (port of ``nerfca_tpu/train/run_eval.py``).

    python -m nerfca_tpu_torch.train.run_eval --config configs/synth-4view-best.txt \
        --resume_from cases/SYNTH-FOVHC/runs/<ts>-composite/checkpoint-best

Renders every frame of ``evaluate.json`` (composite and decomposed
static/dynamic) through ``render_test_view``, so the field kernel K1 runs
on the card with ``--use_pallas true``; writes per-view PNGs (best effort)
and ``<checkpoint>/eval/eval_scores.json`` with per-view, per-angle and
mean PSNR/SSIM and, where the dataset has the artery-only ground truth,
the decomposition scores. A checkpoint with fine models, scored with
``--depth_samples_per_ray_fine`` > 0, also gets each view's ``psnr_fine``
and ``ssim_fine`` from the fine pair's render on the unjittered fine
grid. ``--platform cpu`` runs on the CPU.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from nerfca_tpu_torch.data.dataset import dataset_paths
from nerfca_tpu_torch.data.loader import denormalize_image
from nerfca_tpu_torch.geometry.rays import detector_rays
from nerfca_tpu_torch.ops.hull import apply_hull_args_record, hull_from_args
from nerfca_tpu_torch.ops.sampling import linspace_depths
from nerfca_tpu_torch.train import evaluation
from nerfca_tpu_torch.train.checkpoint import load_checkpoint, load_field_configs
from nerfca_tpu_torch.train.config import parse_args
from nerfca_tpu_torch.train.step import make_optimizer
from nerfca_tpu_torch.train.trainer import (
    _init_composite_state, composite_hparams_from_args, field_configs_from_args,
    resolve_device, resolve_pallas_support,
)


def load_for_render(args) -> dict:
    """What an offline render needs: the dataset's geometry, the configs
    (from the checkpoint's metadata when present, else from ``args``), the
    checkpoint's params and step, the unjittered depths, and the hull
    rebuilt from the checkpoint's persisted record (the record wins over
    the CLI; a mismatch warns)."""
    if not args.resume_from:
        raise ValueError("--resume_from <checkpoint dir> is required")
    device = resolve_device(args.platform)
    paths = dataset_paths(args, args.data_root)
    with open(paths.general) as f:
        info = json.load(f)
    try:
        cfgs = load_field_configs(args.resume_from)
    except (OSError, KeyError):
        cfgs = field_configs_from_args(args)
    hp = resolve_pallas_support(composite_hparams_from_args(args), cfgs)
    tx = make_optimizer(args.lr, args.lr_end_factor, args.lr_decay_steps)
    state = load_checkpoint(args.resume_from, _init_composite_state(args, cfgs, tx, device),
                            params_only=True)
    try:
        with open(os.path.join(args.resume_from, "metadata.json")) as f:
            hull_record = json.load(f).get("run", {}).get("hull")
    except (OSError, json.JSONDecodeError):
        hull_record = None
    if hull_record is not None:
        apply_hull_args_record(args, hull_record)
    with open(paths.train) as f:
        train_frames = json.load(f)["frames"]
    return {
        "device": device, "paths": paths, "info": info, "cfgs": cfgs, "hp": hp,
        "params": state.params, "step": int(state.step),
        "depth_values": linspace_depths(info["near_thresh"], info["far_thresh"],
                                        args.depth_samples_per_ray_coarse, device=device),
        "hull": hull_from_args(args, train_frames, info, device=device),
    }


def render_view(loaded: dict, theta: float, phi: float, larm: float, phase: int,
                depth_values_fine=None) -> dict:
    """``render_test_view`` of one full detector view of the loaded model
    (and of its fine models on ``depth_values_fine``, when given)."""
    info, device = loaded["info"], loaded["device"]
    w, h = (int(v) for v in info["nDetector"])
    origins, dirs = detector_rays(theta, phi, larm, info, device=device)
    return evaluation.render_test_view(
        loaded["params"], origins.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous(),
        torch.full((w * h,), phase, dtype=torch.int32, device=device), loaded["depth_values"],
        loaded["step"], loaded["cfgs"], loaded["hp"], info["max_pixel_value"],
        depth_values_fine=depth_values_fine, hull=loaded["hull"])


def as_image(render: dict, key: str, w: int, h: int) -> np.ndarray:
    return render[key].cpu().numpy().reshape(w, h)


def evaluate_checkpoint(args, write_images: bool = True) -> dict:
    """Score a checkpoint over the full evaluate.json frame set.

    ``write_images=False`` skips the per-frame PNG panels, which bound the
    host time of an eval of every checkpoint."""
    loaded = load_for_render(args)
    info = loaded["info"]
    with open(loaded["paths"].evaluate) as f:
        frames = json.load(f)["frames"]
    w, h = (int(v) for v in info["nDetector"])
    # the fine models too when the checkpoint has them, on the unjittered grid
    depth_values_fine = None
    if args.depth_samples_per_ray_fine > 0 and "static_fine" in loaded["params"]:
        depth_values_fine = linspace_depths(info["near_thresh"], info["far_thresh"],
                                            args.depth_samples_per_ray_fine,
                                            device=loaded["device"])
    out_dir = os.path.join(args.resume_from, "eval")
    os.makedirs(out_dir, exist_ok=True)

    scores = []
    for frame in frames:
        gt = denormalize_image(np.load(frame["file_path"]), w, h,
                               frame["img_min_max"]).astype(np.float32)
        render = render_view(loaded, frame["theta"], frame["phi"], frame["larm"],
                             frame["heart_phase"], depth_values_fine)
        pred = as_image(render, "pix", w, h)
        psnr = evaluation.image_psnr(pred, gt)
        lo, hi = float(gt.min()), float(gt.max())
        scale = (hi - lo) or 1.0
        ssim = evaluation.image_ssim((pred - lo) / scale, (gt - lo) / scale)
        row = {"image_id_str": frame["image_id_str"], "theta": frame["theta"],
               "phi": frame["phi"], "heart_phase": frame["heart_phase"], "psnr": psnr,
               "ssim": ssim}
        if "pix_fine" in render:
            pred_f = as_image(render, "pix_fine", w, h)
            row["psnr_fine"] = evaluation.image_psnr(pred_f, gt)
            row["ssim_fine"] = evaluation.image_ssim((pred_f - lo) / scale, (gt - lo) / scale)
        # decomposition scores against the artery-only ground truth: the
        # temporal field's line integral I0 - pix_temp against the raw line
        # integral of the dynamic component
        dyn_path = frame["file_path"].replace(".npy", "-dyn.npy")
        if os.path.isfile(dyn_path):
            gt_dyn = np.load(dyn_path).reshape((w, h)).T.astype(np.float32)
            pred_dyn = info["max_pixel_value"] - as_image(render, "pix_temp", w, h)
            row["dyn_psnr"] = evaluation.image_psnr(pred_dyn, gt_dyn)
            # whole-frame dyn_psnr rewards near-empty renders: read it only
            # beside dyn_corr or dyn_psnr_masked
            row["dyn_psnr_masked"] = evaluation.masked_region_psnr(pred_dyn, gt_dyn)
            dscale = float(gt_dyn.max() - gt_dyn.min()) or 1.0
            dlo = float(gt_dyn.min())
            row["dyn_ssim"] = evaluation.image_ssim((pred_dyn - dlo) / dscale,
                                                    (gt_dyn - dlo) / dscale)
            row["dyn_corr"] = _pearson(pred_dyn, gt_dyn)
            if write_images:
                save_png(os.path.join(out_dir, f"{frame['image_id_str']}-dyn-gt.png"),
                         evaluation.normalize01(gt_dyn))
        scores.append(row)
        if write_images:
            for name, key in (("pred", "pix"), ("static", "pix_static"),
                              ("dynamic", "pix_temp")):
                save_png(os.path.join(out_dir, f"{frame['image_id_str']}-{name}.png"),
                         evaluation.normalize01(as_image(render, key, w, h)))
        extra = (f" dyn_psnr={row['dyn_psnr']:.3f} dyn_corr={row['dyn_corr']:.3f}"
                 if "dyn_psnr" in row else "")
        print(f"{frame['image_id_str']}: psnr={psnr:.3f} ssim={ssim:.4f}{extra}")

    result = {
        "step": loaded["step"],
        "per_view": scores,
        "mean_psnr": float(np.mean([s["psnr"] for s in scores])),
        "mean_ssim": float(np.mean([s["ssim"] for s in scores])),
        # per-view-angle means across phases: the 40-view mean hides a view
        # that never reconstructs
        "per_view_angle": _per_angle_means(scores),
    }
    if args.selection_view:
        result["selection_view"] = args.selection_view
    dyn_rows = [s for s in scores if "dyn_psnr" in s]
    if dyn_rows:
        for key in ("dyn_psnr", "dyn_psnr_masked", "dyn_ssim", "dyn_corr"):
            result[f"mean_{key}"] = float(np.mean([s[key] for s in dyn_rows]))
    with open(os.path.join(out_dir, "eval_scores.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(f"mean over {len(scores)} views: psnr={result['mean_psnr']:.3f} "
          f"ssim={result['mean_ssim']:.4f} -> {out_dir}/eval_scores.json")
    return result


def _per_angle_means(scores: list[dict]) -> dict:
    groups: dict[str, list[dict]] = {}
    for s in scores:
        groups.setdefault(f"{s['theta']}-{s['phi']}", []).append(s)
    out = {}
    for key, rows in groups.items():
        entry = {"psnr": float(np.mean([r["psnr"] for r in rows])),
                 "ssim": float(np.mean([r["ssim"] for r in rows])),
                 "n_phases": len(rows)}
        if all("dyn_corr" in r for r in rows):
            entry["dyn_corr"] = float(np.mean([r["dyn_corr"] for r in rows]))
        out[key] = entry
    return out


_pearson = evaluation.pearson_corr


def save_png(path: str, img: np.ndarray) -> None:
    """Write a grayscale PNG; nothing when matplotlib is absent."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, img, cmap="gray")


def main(argv=None):
    return evaluate_checkpoint(parse_args(argv))


if __name__ == "__main__":
    main()
