"""Novel-view rendering CLI: render any (theta, phi, phase) views from a
checkpoint (port of ``nerfca_tpu/train/run_render.py``, coarse pass).

    python -m nerfca_tpu_torch.train.run_render --config configs/synth-4view-best.txt \
        --resume_from cases/SYNTH-FOVHC/runs/<ts>-composite/checkpoint-best \
        --render_views "-30,30,0;60,-30,5" --render_spin 8

``--render_views``: semicolon-separated ``theta,phi,phase`` triplets.
``--render_spin N``: also N views sweeping theta over [-60, 60] at phi=0
through the cardiac cycle (a rotating-gantry cine). Writes the composite
and decomposed static/dynamic images as ``.npy`` arrays and, where
matplotlib is present, PNGs, under ``<checkpoint>/renders``.
"""

from __future__ import annotations

import os

import numpy as np

from nerfca_tpu_torch.train import evaluation
from nerfca_tpu_torch.train.config import parse_args
from nerfca_tpu_torch.train.run_eval import as_image, load_for_render, render_view, save_png


def parse_views(spec: str) -> list[tuple[float, float, int]]:
    views = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        theta, phi, phase = part.split(",")
        views.append((float(theta), float(phi), int(phase)))
    return views


def spin_views(n: int) -> list[tuple[float, float, int]]:
    """``n`` views sweeping theta over [-60, 60] at phi=0, phase i % 10."""
    return [(round(-60 + 120 * i / max(1, n - 1), 1), 0.0, i % 10) for i in range(n)]


def render_views(args, views: list[tuple[float, float, int]]) -> list[dict]:
    loaded = load_for_render(args)
    w, h = (int(v) for v in loaded["info"]["nDetector"])
    out_dir = os.path.join(args.resume_from, "renders")
    os.makedirs(out_dir, exist_ok=True)

    results = []
    for theta, phi, phase in views:
        render = render_view(loaded, theta, phi, 0.0, phase)
        tag = f"view-{theta}-{phi}-phase{phase}"
        arrays = {"composite": as_image(render, "pix", w, h),
                  "static": as_image(render, "pix_static", w, h),
                  "dynamic": as_image(render, "pix_temp", w, h)}
        for name, img in arrays.items():
            np.save(os.path.join(out_dir, f"{tag}-{name}.npy"), img)
            save_png(os.path.join(out_dir, f"{tag}-{name}.png"), evaluation.normalize01(img))
        results.append({"theta": theta, "phi": phi, "phase": phase, "tag": tag})
        print(f"rendered {tag}")
    print(f"-> {out_dir}")
    return results


def main(argv=None):
    args = parse_args(argv)
    views = parse_views(args.render_views) if args.render_views else []
    if args.render_spin:
        views += spin_views(args.render_spin)
    if not views:
        raise SystemExit("nothing to render: pass --render_views or --render_spin")
    return render_views(args, views)


if __name__ == "__main__":
    main()
