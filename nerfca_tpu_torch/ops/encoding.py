"""Positional encodings with annealed frequency windows (port of
``nerfca_tpu/ops/encoding.py``).

Modes: ``'none'`` (raw coordinates), ``'fourier'`` (a fixed Gaussian
projection, sin and cos, no raw coordinates), ``'nerfies_windowed'`` (2^j
frequencies with the Nerfies cosine ease window) and ``'free_windowed'``
(FreeNeRF binary-with-fractional-edge mask), raw coordinates prepended.
The annealing state is a pure function of the step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerfca_tpu_torch.ops import prng

# 2 pi as the JAX package multiplies by it: a Python float rounded to f32
TWO_PI_F32 = float(np.float32(2 * np.pi))


def encoded_feature_count(mode: str, basis: int, num_channels: int = 3) -> int:
    if mode == "none" or basis == 0:
        return num_channels
    if mode == "fourier":
        return num_channels * 2 * basis
    return num_channels + num_channels * 2 * basis


def free_window_alpha(basis: int, step, decay_steps: int, window_start: int = 0,
                      window_max: float = 0.0) -> float:
    """FreeNeRF moving pointer (the value logged as ``*_windowed``)."""
    ptr = basis * step / decay_steps + window_start
    alpha = ptr if step < decay_steps else float(basis + 1)
    if 0 < window_max < basis:  # a cap at >= basis bands never binds
        alpha = min(alpha, float(window_max))
    return float(alpha)


def free_window_mask(basis: int, step, decay_steps: int, window_start: int = 0,
                     window_max: float = 0.0, device=None) -> torch.Tensor:
    """FreeNeRF per-band frequency mask ``[basis]``: clip(ptr - band, 0, 1)
    clipped to [1e-8, 1-1e-8]; exactly ones after ``decay_steps`` unless a
    binding ``window_max`` caps the pointer."""
    bands = torch.arange(basis, dtype=torch.float32, device=device)
    ptr = torch.tensor(basis * step / decay_steps + window_start,
                       dtype=torch.float32, device=device)
    capped = 0 < window_max < basis
    if capped:
        ptr = torch.clamp(ptr, max=float(window_max))
    mask = torch.clamp(torch.clamp(ptr - bands, 0.0, 1.0), 1e-8, 1.0 - 1e-8)
    if capped or step < decay_steps:
        return mask
    return torch.ones(basis, dtype=torch.float32, device=device)


def nerfies_alpha(basis: int, step, decay_steps: int) -> float:
    return basis * step / decay_steps


def nerfies_window(basis: int, alpha, device=None) -> torch.Tensor:
    """``0.5 * (1 + cos(pi * clip(alpha - j, 0, 1) + pi))`` over bands."""
    bands = torch.arange(basis, dtype=torch.float32, device=device)
    x = torch.clamp(torch.tensor(alpha, dtype=torch.float32, device=device) - bands, 0.0, 1.0)
    return 0.5 * (1 + torch.cos(math.pi * x + math.pi))


def make_fourier_coefficients(key, basis: int, sigma: float, num_channels: int = 3,
                              device=None) -> torch.Tensor:
    """The fixed Gaussian projection of ``'fourier'`` mode,
    ``[num_channels * basis]``: ``jax.random.normal`` from an
    ``ops/prng.py`` key, times ``sigma`` in f32."""
    coef = prng.normal(key, (num_channels * basis,)) * np.float32(sigma)
    return torch.from_numpy(coef.astype(np.float32)).to(device)


def posenc(x: torch.Tensor, mode: str, basis: int, window=None,
           fourier_coefficients=None) -> torch.Tensor:
    """Encode ``x[..., C]``. Windowed modes: raw coordinates, then per band
    C sin features and C cos features, cos taken as ``sin(t + pi/2)`` in
    f32 exactly as the JAX package computes it. ``'fourier'``: with
    ``v = (f32(2 pi) * tiled) * coef`` over ``tiled = [x] * basis``, the
    features ``[sin(v), cos(v)]``; the coefficients take no gradient."""
    if mode == "none" or basis == 0:
        return x
    if mode == "fourier":
        if fourier_coefficients is None:
            raise ValueError("fourier mode requires fourier_coefficients")
        coef = fourier_coefficients.detach().to(x.dtype)
        value = (TWO_PI_F32 * torch.cat([x] * basis, dim=-1)) * coef
        return torch.cat([torch.sin(value), torch.cos(value)], dim=-1)
    scales = 2.0 ** torch.arange(basis, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * scales[:, None]  # [..., basis, C]
    four_feat = torch.sin(torch.stack([xb, xb + 0.5 * math.pi], dim=-2))
    if window is not None:
        four_feat = window[:, None, None].to(x.dtype) * four_feat
    four_feat = four_feat.reshape(*x.shape[:-1], -1)
    return torch.cat([x, four_feat], dim=-1)
