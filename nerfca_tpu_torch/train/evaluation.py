"""Full-image test rendering and evaluation metrics (port of
``nerfca_tpu/train/evaluation.py``).

The W*H rays of a view are rendered in tiles of 4096 rays (2,048,000 points
per field-kernel launch at 500 samples), then the composite and the
decomposed static-only / dynamic-only intensity maps are formed, plus the
reference's test losses and pure image PSNR / SSIM. With the fine pass the
fine pair is rendered the same way on its own fixed depth grid. The static
method's view (:func:`render_static_test_view`) is the single-field render
of the static field in plain torch, as the JAX package renders it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops.losses import weighted_mse
from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite
from nerfca_tpu_torch.ops.cuda.fused_field import plain_static_field
from nerfca_tpu_torch.train.step import (
    CompositeHParams, StaticHParams, evaluate_fields, field_window, loss_weights,
    regularized_loss, regularizer_losses,
)
from nerfca_tpu_torch.utils.profiling import span


def _render_tiles(params, origins, directions, phases, depth_values, windows, cfgs,
                  hp: CompositeHParams, tile: int, hull, suffix: str = "") -> tuple:
    """The pair ``suffix`` names on every ray, ``tile`` rays at a time:
    the raw densities ``[tile, S]`` of each field and the hull gate, a list
    of tiles each (the gate's empty without a hull)."""
    s_parts, t_parts, g_parts = [], [], []
    for start in range(0, origins.shape[0], tile):
        with span("nerfca.eval.tile"):
            o, d = origins[start:start + tile], directions[start:start + tile]
            s_raw, t_raw = evaluate_fields(params, o, d, depth_values,
                                           phases[start:start + tile], windows, cfgs, hp,
                                           suffix)
            s_parts.append(s_raw[..., 0])
            t_parts.append(t_raw[..., 0])
            if hull is not None:
                g_parts.append(hull_gate_rays(hull, o, d, depth_values))
    return s_parts, t_parts, g_parts


def _joined(s_parts, t_parts, g_parts) -> tuple:
    """The tiles of :func:`_render_tiles` as ``[N, S]`` densities of each
    field and the gate (None without a hull)."""
    return torch.cat(s_parts), torch.cat(t_parts), torch.cat(g_parts) if g_parts else None


@torch.no_grad()
def render_test_view(params, test_origins, test_directions, test_phases, depth_values,
                     step: int, cfgs: dict, hp: CompositeHParams, initial_intensity: float,
                     tile: int = 4096, depth_values_fine=None, hull=None) -> dict:
    """Render one full test view; per-pixel composite and decomposed
    intensity maps plus the scaled sigmas and dists, the fields under
    ``hp.compute_dtype`` (``nerfca_tpu/train/evaluation.py:80``). ``hull``:
    optional ``MotionHull`` gating the dynamic density exactly as in
    training.

    With ``depth_values_fine`` and fine params, the fine pair is rendered
    directly on that fixed grid, as the reference's eval does (not a
    resampled hierarchical pass): ``pix_fine`` and the fine sigmas and
    dists."""
    with span("nerfca.eval.view"):
        dev = test_origins.device
        windows = {k: field_window(cfgs[k], step, dev) for k in ("static", "temp")}
        parts = _render_tiles(params, test_origins, test_directions, test_phases,
                              depth_values, windows, cfgs, hp, tile, hull)
        with span("nerfca.eval.composite"):
            s_raw, t_raw, gate = _joined(*parts)
            del parts  # the tiles, released before the renders as the joins replace them
            i0 = torch.full((s_raw.shape[0],), initial_intensity, device=dev)
            pix, s_sig, t_sig, dists = render_transmission_composite(
                s_raw[..., None], t_raw[..., None], i0, depth_values, hp.output_activation,
                temp_gate=gate)
            pix_temp, _, _ = render_transmission(t_raw[..., None], i0, depth_values,
                                                 hp.output_activation, gate=gate)
            pix_static, _, _ = render_transmission(s_raw[..., None], i0, depth_values,
                                                   hp.output_activation)
        out = {"pix": pix, "pix_static": pix_static, "pix_temp": pix_temp,
               "static_sigma": s_sig, "temp_sigma": t_sig, "dists": dists}
        if depth_values_fine is not None and "static_fine" in params:
            parts = _render_tiles(params, test_origins, test_directions, test_phases,
                                  depth_values_fine, windows, cfgs, hp, tile, hull, "_fine")
            with span("nerfca.eval.composite"):
                s_raw, t_raw, gate = _joined(*parts)
                del parts
                pix, s_sig, t_sig, dists = render_transmission_composite(
                    s_raw[..., None], t_raw[..., None], i0, depth_values_fine,
                    hp.output_activation, temp_gate=gate)
            out.update(pix_fine=pix, static_sigma_fine=s_sig, temp_sigma_fine=t_sig,
                       dists_fine=dists)
        return out


@torch.no_grad()
def render_static_test_view(params, test_origins, test_directions, depth_values, step: int,
                            cfg, hp: StaticHParams, initial_intensity: float,
                            tile: int = 4096) -> dict:
    """One full test view of the static method
    (``nerfca_tpu/train/evaluation.py:227-275``): ``pix_static``, the
    single-field render of the static field, with its UNSCALED sigma and
    the dists. The JAX package renders it through its composite renderer
    beside a zero temporal field, on the plain path (its hyperparameters
    there leave ``use_pallas`` off), and scores ``pix_static``, which that
    field does not enter; this renders the static field alone, plain, under
    ``hp.compute_dtype`` (``nerfca_tpu/train/evaluation.py:261``)."""
    window = field_window(cfg, step, test_origins.device)
    parts = []
    for start in range(0, test_origins.shape[0], tile):
        o, d = test_origins[start:start + tile], test_directions[start:start + tile]
        pts = o[:, None, :] + d[:, None, :] * depth_values[:, None]
        parts.append(plain_static_field(params["static"], pts, cfg, window, hp.dtype)[..., 0])
    raw = torch.cat(parts)
    i0 = torch.full((raw.shape[0],), initial_intensity, device=test_origins.device)
    pix, sigma, dists = render_transmission(raw[..., None], i0, depth_values,
                                            hp.output_activation)
    return {"pix_static": pix, "static_sigma": sigma, "dists": dists}


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
