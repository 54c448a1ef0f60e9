"""Full-image test rendering and evaluation metrics (port of
``nerfca_tpu/train/evaluation.py``).

The W*H rays of a view are rendered in tiles of 4096 rays (2,048,000 points
per field-kernel launch at 500 samples), then the composite and the
decomposed static-only / dynamic-only intensity maps are formed, plus the
reference's test losses and pure image PSNR / SSIM. With the fine pass the
fine pair is rendered the same way on its own fixed depth grid. The static
method's view (:func:`render_static_test_view`) is the single-field render
of the static field through the same renderer and tiles.

On the card, with both fields of a pair on K1, each tile's composite is
one launch of the Beer-Lambert kernel right after the tile's K1
(``ops/cuda/fused_train.py::eval_composite``), into buffers allocated once
for the view; the static method's field takes the one-field K1
(``ops/cuda/fused_field.py::StaticFieldRays``) and the kernel's one-field
sibling (``eval_static``) the same way. Everywhere else the tiles are
joined and rendered by ``ops/render.py``. Both give the same sigmas and
dists bit for bit and the same images up to the order of each per-ray sum.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops.losses import weighted_mse
from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite
from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.ops.cuda.fused_field import (
    StaticFieldRays, kernel_supported, plain_static_field_rays,
)
from nerfca_tpu_torch.train.step import (
    CompositeHParams, StaticHParams, evaluate_fields, field_window, field_windows,
    loss_weights, regularized_loss, regularizer_losses,
)
from nerfca_tpu_torch.utils.profiling import span


def _fields(cfgs: dict, suffix: str) -> tuple:
    """The fields of the pair ``suffix`` names: the static and the temporal
    one, or, for the static method, the static field alone."""
    return ("static", "temp") if "temp" + suffix in cfgs else ("static",)


def _tile_fields(params, step: int, windows, cfgs, hp, z, tile: int, suffix: str,
                 on_kernel: bool):
    """A tile's raw densities ``[r, S]``, one for each field of the pair
    ``suffix`` names, from its rays and phases: both fields through
    :func:`evaluate_fields` (``windows``: :func:`field_windows`); the static
    method's field through the one-field K1 on the card (``on_kernel``:
    packed with its window once for the view's tiles), else the plain field
    under ``hp.dtype``, as the JAX package renders it."""
    if "temp" + suffix in cfgs:
        def both(o, d, ph):
            s_raw, t_raw = evaluate_fields(params, o, d, z, ph, windows, cfgs, hp, suffix)
            return s_raw[..., 0], t_raw[..., 0]
        return both
    p, cfg = params["static" + suffix], cfgs["static" + suffix]
    window = field_window(cfg, step, z.device)
    if on_kernel:
        k1 = StaticFieldRays(p, cfg, window, hp.compute_dtype, tile)
        return lambda o, d, ph: (k1(o, d, z),)
    return lambda o, d, ph: (plain_static_field_rays(p, o, d, z, cfg, window, hp.dtype)[..., 0],)


def _tiles(params, origins, directions, phases, depth_values, step: int, windows, cfgs, hp,
           tile: int, hull, suffix: str, on_kernel: bool):
    """The pair ``suffix`` names on every ray, ``tile`` rays at a time: per
    tile its first ray, the raw densities ``[tile, S]`` of each field
    (:func:`_tile_fields`) and the hull gate (None without a hull)."""
    fields = _tile_fields(params, step, windows, cfgs, hp, depth_values, tile, suffix,
                          on_kernel)
    for start in range(0, origins.shape[0], tile):
        with span("nerfca.eval.tile"):
            rows = slice(start, start + tile)
            o, d = origins[rows], directions[rows]
            raws = fields(o, d, None if phases is None else phases[rows])
            gate = hull_gate_rays(hull, o, d, depth_values) if hull is not None else None
        yield start, raws, gate


def composite_on_kernel(origins, cfgs: dict, hp, suffix: str = "") -> bool:
    """Whether the pair ``suffix`` names takes the eval's Beer-Lambert kernel
    (the static method's field alone: its one-field sibling): CUDA tensors
    with every field of the pair on K1 (:func:`evaluate_fields`'s
    condition)."""
    return (origins.device.type == "cuda" and hp.use_pallas
            and all(kernel_supported(cfgs[f + suffix]) for f in _fields(cfgs, suffix)))


def _render_pair(params, origins, directions, phases, depth_values, step: int, windows, cfgs,
                 hp, tile: int, hull, i0: float, suffix: str, images: bool,
                 on_kernel: bool) -> dict:
    """The pair's composite and, with ``images``, its static and dynamic
    images; the static method's pair (one field): its image ``pix_static``,
    UNSCALED sigma and dists. ``on_kernel``: each tile's Beer-Lambert
    kernel right after its K1, into buffers for the view; else the tiles
    joined, then the renders of ``ops/render.py`` over the whole view."""
    one = len(_fields(cfgs, suffix)) == 1
    tiles = _tiles(params, origins, directions, phases, depth_values, step, windows, cfgs, hp,
                   tile, hull, suffix, on_kernel)
    act = hp.output_activation
    if on_kernel and one:
        out = None
        for start, (raw,), _ in tiles:
            with span("nerfca.eval.composite"):
                if out is None:  # made once tile 0's K1 is queued
                    out = ft.eval_static_buffers(origins.shape[0], depth_values)
                ft.eval_static(raw, depth_values, i0, act, out, start)
        return out
    if on_kernel:
        out = ft.eval_composite_buffers(origins.shape[0], depth_values, images)
        for start, (s_raw, t_raw), gate in tiles:
            with span("nerfca.eval.composite"):
                ft.eval_composite(s_raw, t_raw, depth_values, i0, act, out, start, gate)
        return out
    parts = list(tiles)
    with span("nerfca.eval.composite"):
        raws = [torch.cat([p[1][k] for p in parts])[..., None] for k in range(len(parts[0][1]))]
        gate = torch.cat([p[2] for p in parts]) if hull is not None else None
        del parts  # the tiles, released before the renders as the joins replace them
        i0_rays = torch.full((raws[0].shape[0],), i0, device=origins.device)
        if one:
            pix, sigma, dists = render_transmission(raws[0], i0_rays, depth_values, act)
            return {"pix_static": pix, "static_sigma": sigma, "dists": dists}
        s_raw, t_raw = raws
        pix, s_sig, t_sig, dists = render_transmission_composite(
            s_raw, t_raw, i0_rays, depth_values, act, temp_gate=gate)
        out = {"pix": pix}
        if images:
            out["pix_static"] = render_transmission(s_raw, i0_rays, depth_values, act)[0]
            out["pix_temp"] = render_transmission(t_raw, i0_rays, depth_values, act,
                                                  gate=gate)[0]
    out.update(static_sigma=s_sig, temp_sigma=t_sig, dists=dists)
    return out


@torch.no_grad()
def render_test_view(params, test_origins, test_directions, test_phases, depth_values,
                     step: int, cfgs: dict, hp, initial_intensity: float,
                     tile: int = 4096, depth_values_fine=None, hull=None) -> dict:
    """Render one full test view; per-pixel composite and decomposed
    intensity maps plus the scaled sigmas and dists, the fields under
    ``hp.compute_dtype`` (``nerfca_tpu/train/evaluation.py:80``). ``hull``:
    optional ``MotionHull`` gating the dynamic density exactly as in
    training.

    With ``depth_values_fine`` and fine params, the fine pair is rendered
    directly on that fixed grid, as the reference's eval does (not a
    resampled hierarchical pass): ``pix_fine`` and the fine sigmas and
    dists. Each pair's composite takes the Beer-Lambert kernel where
    :func:`composite_on_kernel` holds; a view whose composite ran in torch
    counts one ``fused_train.LAUNCHES["eval_composite.torch"]``.

    The static method's view: ``cfgs`` ``{"static": cfg}`` with its
    ``StaticHParams``, no phases (``test_phases`` None) and no hull; it
    returns ``pix_static``, the single-field render of the static field,
    with its UNSCALED sigma ``static_sigma`` and the ``dists``
    (:func:`render_static_test_view`)."""
    if hull is not None and "temp" not in cfgs:
        raise ValueError("the motion hull gates the temporal field; the static method has none")
    with span("nerfca.eval.view"):
        # the static method's field takes its window in _tile_fields
        windows = field_windows(cfgs, step, test_origins.device) if "temp" in cfgs else None
        pairs = [("", depth_values)]
        if depth_values_fine is not None and "static_fine" in params:
            pairs.append(("_fine", depth_values_fine))
        out, on_kernel = {}, True
        for suffix, z in pairs:
            kernel = composite_on_kernel(test_origins, cfgs, hp, suffix)
            on_kernel = on_kernel and kernel
            got = _render_pair(params, test_origins, test_directions, test_phases, z, step,
                               windows, cfgs, hp, tile, hull, initial_intensity, suffix,
                               images=not suffix, on_kernel=kernel)
            out.update({k + suffix: v for k, v in got.items()})
        ft.LAUNCHES["eval_composite.torch"] += int(not on_kernel)
        return out


def render_static_test_view(params, test_origins, test_directions, depth_values, step: int,
                            cfg, hp: StaticHParams, initial_intensity: float,
                            tile: int = 4096) -> dict:
    """One full test view of the static method
    (``nerfca_tpu/train/evaluation.py:227-275``): ``pix_static``, the
    single-field render of the static field, with its UNSCALED sigma and
    the dists. The JAX package renders it through its composite renderer
    beside a zero temporal field, on the plain path (its hyperparameters
    there leave ``use_pallas`` off), and scores ``pix_static``, which that
    field does not enter; this renders the static field alone through the
    same renderer, :func:`render_test_view`: on the card with
    ``use_pallas`` through the one-field K1 and its Beer-Lambert kernel,
    elsewhere plain under ``hp.compute_dtype``
    (``nerfca_tpu/train/evaluation.py:261``)."""
    return render_test_view(params, test_origins, test_directions, None, depth_values, step,
                            {"static": cfg}, hp, initial_intensity, tile=tile)


def test_metrics(render: dict, test_img_flat: torch.Tensor, step: int, hp: CompositeHParams,
                 img_shape: Optional[tuple] = None) -> dict:
    """Test losses + PSNR as the reference logs them, plus image PSNR/SSIM."""
    weights = loss_weights(step, hp)
    ones = torch.ones_like(test_img_flat)
    pixel_loss = torch.mean(weighted_mse(render["pix"], test_img_flat, ones))
    losses = regularizer_losses(render["static_sigma"], render["temp_sigma"], render["dists"],
                                ones, hp)
    test_loss = regularized_loss(pixel_loss, losses, weights)
    pixel_loss_fine = None
    if "pix_fine" in render:
        # the fine terms add to test_loss, and the logged regularizers are
        # the fine pass's (run_composite.py:380-389)
        pixel_loss_fine = torch.mean(weighted_mse(render["pix_fine"], test_img_flat, ones))
        losses = regularizer_losses(render["static_sigma_fine"], render["temp_sigma_fine"],
                                    render["dists_fine"], ones, hp)
        test_loss = test_loss + regularized_loss(pixel_loss_fine, losses, weights)
    test_loss = float(test_loss)
    pred = render["pix"].double().cpu().numpy()
    gt = test_img_flat.double().cpu().numpy()
    out = {
        "test_loss": test_loss,
        "test_psnr": float(-10.0 * np.log10(test_loss)),
        "test_pixel_loss_coarse": float(pixel_loss),
        "test_favor_s_loss": float(losses.favor_s_loss),
        "test_blendw": float(losses.blendw_mean),
        "test_s_entropy_loss": float(losses.static_entropy_loss),
        "test_d_entropy_loss": float(losses.dynamic_entropy_loss),
        "test_image_psnr": image_psnr(pred, gt),
    }
    if pixel_loss_fine is not None:
        out["test_pixel_loss_fine"] = float(pixel_loss_fine)
        out["test_image_psnr_fine"] = image_psnr(render["pix_fine"].double().cpu().numpy(), gt)
    if img_shape is not None:
        lo, hi = float(gt.min()), float(gt.max())
        scale = (hi - lo) or 1.0
        out["test_image_ssim"] = image_ssim((pred.reshape(img_shape) - lo) / scale,
                                            (gt.reshape(img_shape) - lo) / scale)
    return out


def normalize01(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi == lo:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation of two images (flattened); 0 when degenerate."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def image_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """Data-range PSNR ``10 log10(range(gt)^2 / MSE)`` on the raw values."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    if mse == 0:
        return float("inf")
    data_range = float(np.max(gt) - np.min(gt))
    if data_range == 0:
        return float("-inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def image_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Gaussian-windowed SSIM on 2-D images (standard constants)."""
    from scipy.ndimage import gaussian_filter

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    sigma = 1.5
    mu_a = gaussian_filter(a, sigma)
    mu_b = gaussian_filter(b, sigma)
    va = gaussian_filter(a * a, sigma) - mu_a**2
    vb = gaussian_filter(b * b, sigma) - mu_b**2
    cov = gaussian_filter(a * b, sigma) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return float(np.mean(num / den))


def masked_region_psnr(pred: np.ndarray, gt: np.ndarray, rel_thresh: float = 0.05,
                       dilate: int = 2) -> float:
    """PSNR restricted to the ground truth's support (pixels with
    ``gt > rel_thresh * max(gt)``, dilated by ``dilate`` pixels).

    Whole-frame ``dyn_psnr`` rewards a near-empty dynamic render, because
    the artery ground truth is mostly zero; scoring only where the vessel
    projects makes an empty render score the full ground-truth range
    against ~zero. The data range stays the full ground-truth range, so the
    score compares with :func:`image_psnr`. Plain PSNR when the mask would
    be empty."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    top = float(gt.max())
    mask = gt > rel_thresh * top
    if top <= 0 or not mask.any():
        return image_psnr(pred, gt)
    if dilate > 0:
        from scipy.ndimage import binary_dilation

        mask = binary_dilation(mask, iterations=dilate)
    mse = float(np.mean((pred[mask] - gt[mask]) ** 2))
    data_range = float(gt.max() - gt.min())
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
