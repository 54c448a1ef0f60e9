"""Positional encodings with annealed frequency windows (port of
``nerfca_tpu/ops/encoding.py``).

Modes: ``'none'`` (raw coordinates), ``'fourier'`` (a fixed Gaussian
projection, sin and cos, no raw coordinates), ``'nerfies_windowed'`` (2^j
frequencies with the Nerfies cosine ease window) and ``'free_windowed'``
(FreeNeRF binary-with-fractional-edge mask), raw coordinates prepended.
The annealing state is a pure function of the step.

``'hashgrid'`` (:func:`hash_encode`, the port's own: the JAX package has
no such mode) is Instant-NGP's multiresolution hash encoding (Müller,
Evans, Schied, Keller, SIGGRAPH 2022) at the sizes NAF's attenuation
field uses (Zha, Zhang, Li, MICCAI 2022, ``DensityNetwork`` with its
``hashgrid`` encoder): L = 16 levels of F = 2 features, T = 2^19 entries
a level, N_min = 16 and N_max = 2048 cells a side, growth b = 2^(7/15).
Exactly, in f32:

  - a point maps to the unit cube over the volume's box, a cube of half
    extent ``bound`` at the origin: ``u = clamp((x + bound) / (bound +
    bound), 0, 1)``;
  - level ``l`` has ``N_l = floor(N_min * b^l)`` cells a side (16, 22, 30,
    42, 58, 80, ..., 2048); ``pos = u * N_l``, the cell ``g = min(floor(pos),
    N_l - 1)``, so that its corners ``g + {0, 1}^3`` stay in ``[0, N_l]``;
  - levels 0-4, whose ``(N_l + 1)^3`` corners fit T, index densely,
    ``g0 + (N_l + 1) * (g1 + (N_l + 1) * g2)``; levels 5-15 hash,
    ``(g0 * 1 ^ g1 * 2654435761 ^ g2 * 805459861) mod T`` in uint32;
  - with ``f = pos - g``, corner ``c`` (bit k of c the offset along axis
    k) weighs ``(w0 * w1) * w2``, ``w_k = f_k`` or ``1 - f_k``; a level's
    two features are ``acc = acc + weight * entry`` over c = 0..7 from 0
    (a product, then a sum: no fused multiply-add);
  - the levels' pairs are concatenated, the coarsest first: 32 features.

The table is one ``[HASH_TABLE_ENTRIES, 2]`` f32 leaf, ``params["table"]``,
the levels one after the other (``HASH_OFFSETS``), each level's entries
rounded up to a multiple of 8: 6,098,944 entries, 48.8 MB.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerfca_tpu_torch.ops import prng

# 2 pi as the JAX package multiplies by it: a Python float rounded to f32
TWO_PI_F32 = float(np.float32(2 * np.pi))


HASH_LEVELS = 16
HASH_FEATURES = 2
HASH_LOG2_T = 19
HASH_N_MIN = 16
HASH_N_MAX = 2048
HASH_PRIMES = (1, 2654435761, 805459861)


def _hash_levels() -> tuple:
    """Per level: cells a side, dense or hashed, entries, offset."""
    t = 2 ** HASH_LOG2_T
    growth = math.log2(HASH_N_MAX / HASH_N_MIN) / (HASH_LEVELS - 1)  # 7/15: N_15 is 2048
    res, dense, entries, offsets, at = [], [], [], [], 0
    for lv in range(HASH_LEVELS):
        n = int(math.floor(HASH_N_MIN * 2.0 ** (lv * growth)))
        res.append(n)
        dense.append((n + 1) ** 3 <= t)
        entries.append(-(-((n + 1) ** 3 if dense[-1] else t) // 8) * 8)
        offsets.append(at)
        at += entries[-1]
    return tuple(res), tuple(dense), tuple(entries), tuple(offsets), at


HASH_RES, HASH_DENSE, HASH_ENTRIES, HASH_OFFSETS, HASH_TABLE_ENTRIES = _hash_levels()


def hash_encode(x: torch.Tensor, table: torch.Tensor, bound: float) -> torch.Tensor:
    """The ``'hashgrid'`` encoding (the module's note) of ``x [..., 3]``
    over the table ``[HASH_TABLE_ENTRIES, 2]``: ``[..., 32]``. Autograd
    reaches the table (and not the points: ``floor`` has no gradient, and
    the weights' is not kept)."""
    if not bound > 0:
        raise ValueError(f"a hashgrid field needs the volume's half extent, got {bound!r}")
    if table.shape != (HASH_TABLE_ENTRIES, HASH_FEATURES):
        raise ValueError(f"hash table {tuple(table.shape)}, expected "
                         f"({HASH_TABLE_ENTRIES}, {HASH_FEATURES})")
    shape = x.shape[:-1]
    pts = x.reshape(-1, 3).detach().float()
    b = torch.tensor(np.float32(bound), device=pts.device)
    u = torch.clamp((pts + b) / (b + b), 0.0, 1.0)
    mask = 2 ** HASH_LOG2_T - 1
    feats = []
    for n, dense, offset in zip(HASH_RES, HASH_DENSE, HASH_OFFSETS):
        pos = u * float(n)
        g = torch.clamp(torch.floor(pos), max=float(n - 1))
        f = pos - g
        g = g.long()
        acc = torch.zeros(pts.shape[0], HASH_FEATURES, dtype=table.dtype, device=pts.device)
        for c in range(8):
            bit = [(c >> k) & 1 for k in range(3)]
            k0, k1, k2 = (g[:, k] + bit[k] for k in range(3))
            if dense:
                idx = k0 + (n + 1) * (k1 + (n + 1) * k2)
            else:
                idx = ((k0 * HASH_PRIMES[0]) ^ (k1 * HASH_PRIMES[1]) ^ (k2 * HASH_PRIMES[2])) & mask
            w = [f[:, k] if bit[k] else 1.0 - f[:, k] for k in range(3)]
            acc = acc + ((w[0] * w[1]) * w[2])[:, None] * table[offset + idx]
        feats.append(acc)
    return torch.cat(feats, dim=-1).reshape(*shape, HASH_LEVELS * HASH_FEATURES)


def encoded_feature_count(mode: str, basis: int, num_channels: int = 3) -> int:
    if mode == "hashgrid":
        return HASH_LEVELS * HASH_FEATURES
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
