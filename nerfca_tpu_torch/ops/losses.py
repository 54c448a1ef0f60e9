"""Separation regularizers and the pixel loss (port of
``nerfca_tpu/ops/losses.py``). Quirks kept:

  - ``occlusion_loss`` without ``use_back``/``front_only`` masks the ENTIRE
    ray (the reference initializes the back mask to ones), so it is a
    full-ray L1 of ``sigma * dists``;
  - static L1/L2 reduce with ``sum`` over rays, not ``mean``;
  - the static ray entropy is logged but never enters the loss.

Every clip is :func:`clip`, whose derivative at a bound is 0.5 as JAX's
``jnp.clip`` gives it (``torch.clamp`` gives 1): ``1 - 1e-19`` is 1.0 in
f32, so a blend ratio of exactly 1.0 sits on the bound.

Every mean over rays is :func:`ray_mean`. With ``total_rays`` (a
data-parallel rank's slice of a larger batch) it gives this slice's partial
of the mean over all ``total_rays`` rays, so that the ranks' partials sum
to the batch's mean; by default it is ``torch.mean``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, so a value ON a bound
    passes half its gradient (``torch.clamp`` passes all of it). The bounds
    are filled on the device (``torch.tensor(lo, device=...)`` would copy
    from the host and synchronize the stream)."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def ray_mean(x: torch.Tensor, total_rays=None) -> torch.Tensor:
    """``torch.mean(x)`` over ``x``'s leading ray axis (and any others).
    With ``total_rays``: the local mean scaled by ``x.shape[0] /
    total_rays``, this slice's share of the mean over ``total_rays`` rays;
    exactly the local mean when the slice holds them all."""
    m = torch.mean(x)
    if total_rays is None or total_rays == x.shape[0]:
        return m
    return m * (x.shape[0] / total_rays)


def blend_ratio(sigma_s, sigma_d):
    """``sigma_d / (sigma_s + sigma_d + 1e-10)`` plus detached maxima."""
    blendw = sigma_d / (sigma_s + sigma_d + 1e-10)
    return blendw, sigma_s.detach().max(), sigma_d.detach().max()


def blendw_entropy_loss(blendw, skewness: float = 1.0, clip_threshold: float = 1e-19,
                        total_rays=None):
    """Mean binary entropy of ``blendw ** skewness``."""
    b = clip(blendw ** skewness, clip_threshold, 1 - clip_threshold)
    rev = clip(1 - b, lo=clip_threshold)
    entropy = torch.mean(-(b * torch.log(b) + rev * torch.log(rev)), dim=-1)
    return ray_mean(entropy, total_rays)


def ray_entropy_loss(sigma, dists, mask_threshold: float = 0.1,
                     clip_threshold: float = 1e-19, use_weighting: bool = False,
                     weighted_pixs=None, weighted_thresh: float = 0.25, total_rays=None):
    """Per-ray density-distribution entropy, masked to rays whose
    attenuation sum reaches ``mask_threshold`` (OR the variance mask when
    ``use_weighting``). Returns ``(mean entropy, mean attenuation sum)``.

    Double-where guard: on rays whose sum is below 1e-15 the denominator's
    cotangent is dropped (``clipped.detach()``), so an all-zero ray gives a
    finite gradient; forward values are unchanged."""
    sigma_dist = sigma * dists
    sigma_sum = torch.sum(sigma_dist, dim=-1, keepdim=True)
    mask = sigma_sum[..., 0] >= mask_threshold
    if use_weighting and weighted_pixs is not None:
        mask = mask | (weighted_pixs > 1.0 + weighted_thresh)
    clipped = clip(sigma_sum, lo=clip_threshold)
    risky = sigma_sum < 1e-15
    denom = torch.where(risky, clipped.detach(), clipped)
    ray_p = sigma_dist / denom
    entropy = mask * -torch.sum(ray_p * torch.log(ray_p + 1e-10), dim=-1)
    return ray_mean(entropy, total_rays), ray_mean(sigma_sum, total_rays)


def occlusion_mask(dists, reg_perc: float = 0.1, use_back: bool = False,
                   front_only: bool = False):
    """``[S]`` boolean mask of the ray portion the occlusion loss covers
    (the full ray by default, see the module docstring)."""
    cum_dists = torch.cumsum(dists, dim=0)
    total = cum_dists[-1]
    if front_only:
        return cum_dists < reg_perc * total
    if use_back:
        return (cum_dists < reg_perc * total) | (cum_dists > (1 - reg_perc) * total)
    return torch.ones_like(cum_dists, dtype=torch.bool)


def occlusion_loss(sigma, dists, reg_perc: float = 0.1, use_back: bool = False,
                   front_only: bool = False, total_rays=None):
    """L1 of ``sigma * dists`` over the masked ray portion; ``dists`` is the
    shared ``[S]``."""
    mask = occlusion_mask(dists, reg_perc, use_back, front_only)
    return ray_mean(torch.sum(sigma * dists * mask, dim=-1), total_rays)


def weighted_mse(preds, gts, weights):
    """Per-pixel weighted squared error; the caller reduces."""
    return (preds - gts) ** 2 * weights


class CompositeLosses(NamedTuple):
    blendw_mean: torch.Tensor
    sigma_s_max: torch.Tensor
    sigma_d_max: torch.Tensor
    favor_s_loss: torch.Tensor
    static_entropy_loss: torch.Tensor
    static_entropy_sum: torch.Tensor
    dynamic_entropy_loss: torch.Tensor
    dynamic_entropy_sum: torch.Tensor
    dynamic_occl_loss: torch.Tensor
    static_l1_loss: torch.Tensor
    static_l2_loss: torch.Tensor


def composite_losses(static_sigma, temp_sigma, dists, weighted_pixs, *,
                     skewness_val: float = 1.0, entro_mask_thre: float = 0.1,
                     entro_use_weighting: bool = False, entro_weighted_thresh: float = 0.0,
                     occl_reg_perc: float = 0.1, entro_clip_threshold: float = 1e-19,
                     occl_front_only: bool = False, total_rays=None) -> CompositeLosses:
    """The composite regularizer battery. ``total_rays``: the rays are one
    slice of a batch of ``total_rays`` (each mean is this slice's partial,
    the L1/L2 sums its part, the maxima its own; see :func:`ray_mean`)."""
    blendw, sigma_s_max, sigma_d_max = blend_ratio(static_sigma, temp_sigma)
    favor_s = blendw_entropy_loss(blendw, skewness=skewness_val, total_rays=total_rays)
    s_entropy, s_entropy_sum = ray_entropy_loss(
        static_sigma, dists, mask_threshold=entro_mask_thre,
        clip_threshold=entro_clip_threshold, total_rays=total_rays,
    )
    d_entropy, d_entropy_sum = ray_entropy_loss(
        temp_sigma, dists, mask_threshold=entro_mask_thre,
        clip_threshold=entro_clip_threshold, use_weighting=entro_use_weighting,
        weighted_pixs=weighted_pixs, weighted_thresh=entro_weighted_thresh,
        total_rays=total_rays,
    )
    d_occl = occlusion_loss(temp_sigma, dists, occl_reg_perc, front_only=occl_front_only,
                            total_rays=total_rays)
    static_l1 = torch.sum(torch.sum(static_sigma * dists, dim=-1))
    static_l2 = torch.sum(torch.sum((static_sigma * dists) ** 2, dim=-1))
    return CompositeLosses(
        blendw_mean=ray_mean(blendw, total_rays), sigma_s_max=sigma_s_max, sigma_d_max=sigma_d_max,
        favor_s_loss=favor_s, static_entropy_loss=s_entropy,
        static_entropy_sum=s_entropy_sum, dynamic_entropy_loss=d_entropy,
        dynamic_entropy_sum=d_entropy_sum, dynamic_occl_loss=d_occl,
        static_l1_loss=static_l1, static_l2_loss=static_l2,
    )
