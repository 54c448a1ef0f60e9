"""Depth sampling along rays (port of ``nerfca_tpu/ops/sampling.py``):
uniform, stratified, and the fine pass's inverse-CDF ``sample_pdf``.

Like the reference, the stratified jitter draws ONE shared depth vector per
call: all rays in a batch share the same jittered depths. ``sample_pdf``
draws its uniforms from an ``ops/prng.py`` key as JAX draws them from its
key, so a key gives JAX's fine depths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerfca_tpu_torch.ops import prng


def linspace_depths(near: float, far: float, n_samples: int, device=None) -> torch.Tensor:
    """Evenly spaced depths in [near, far], shape ``[n_samples]``, equal to
    the JAX package's bit for bit: ``jnp.linspace(0, 1, n)`` is
    ``i * f32(1 / (n - 1))`` (XLA divides by a constant through its f32
    reciprocal) with the last entry exactly 1."""
    t = torch.zeros(n_samples, dtype=torch.float32, device=device)
    if n_samples > 1:
        step = torch.tensor(1.0) / torch.tensor(float(n_samples - 1))  # f32, correctly rounded
        t[:-1] = torch.arange(n_samples - 1, dtype=torch.float32, device=device) * step.item()
        t[-1] = 1.0
    return near * (1.0 - t) + far * t


def stratify_depths(z_vals: torch.Tensor, generator: Optional[torch.Generator] = None,
                    t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Jitter depths uniformly within their midpoint intervals. ``t_rand``
    (same shape as ``z_vals``) injects the uniforms; otherwise they are
    drawn from ``generator`` on the depths' device."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                            device=z_vals.device)
    return lower + (upper - lower) * t_rand


def sample_pdf(key: Optional[np.ndarray], bins: torch.Tensor, weights: torch.Tensor,
               n_samples: int, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-transform sample ``n_samples`` depths per ray from a
    piecewise PDF over ``bins`` (``nerfca_tpu/ops/sampling.py:40-78``).

    ``bins``: ``[R, B]`` bin positions (depth midpoints), ``weights``:
    ``[R, B-1]`` unnormalized interval densities, so the CDF with its
    prepended zero has exactly ``B`` entries. Returns ``[R, n_samples]``,
    differentiable w.r.t. ``weights`` as JAX's is. Keeps the reference's
    +1e-5 on the weights, ``searchsorted(..., right)``, the clamps of the
    gathered indices into ``bins`` and the ``< 1e-5`` denominator guard.

    ``u``: the uniforms ``[R, n_samples]``; otherwise drawn from ``key``
    (an ``ops/prng.py`` key) as ``jax.random.uniform(key, (R, n_samples))``."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [R, B]
    if u is None:
        u = torch.from_numpy(prng.uniform(key, (*cdf.shape[:-1], n_samples))).to(cdf.device)
    u = u.to(cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf.detach().contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    # clamp into ``bins`` as the reference's gather does, for bins shorter
    # than the CDF (an out-of-range ``above`` only where denom ~ 0)
    bmax = bins.shape[-1] - 1
    bins_below = torch.gather(bins, -1, torch.clamp(below, max=bmax))
    bins_above = torch.gather(bins, -1, torch.clamp(above, max=bmax))
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
