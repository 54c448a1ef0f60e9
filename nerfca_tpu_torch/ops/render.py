"""X-ray transmission rendering, Beer-Lambert in log-intensity space (port
of ``nerfca_tpu/ops/render.py``).

The pixel prediction is ``I0 - sum_i sigma_i * dist_i``. Two quirks are
kept: the single-field renderer returns the UNSCALED sigma while the
composite renderer returns sigmas multiplied by ``scale_value``; the final
sample's dist is 1e-10.
"""

from __future__ import annotations

import torch

from nerfca_tpu_torch.ops.losses import clip


def depth_deltas(depth_values: torch.Tensor) -> torch.Tensor:
    """Adjacent depth differences with a 1e-10 terminal delta."""
    tail = torch.full_like(depth_values[..., :1], 1e-10)
    return torch.cat([depth_values[..., 1:] - depth_values[..., :-1], tail], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` for every x, as ``jax.nn.softplus`` computes it
    (``torch.nn.functional.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def output_activation(raw: torch.Tensor, kind: str = "softplus") -> torch.Tensor:
    kind = kind.lower()
    if kind == "softplus":
        return softplus(raw)
    if kind == "sigmoid":
        return torch.sigmoid(raw)
    if kind == "clamp":
        return clip(softplus(raw), 0.0, 1.0)
    raise ValueError(f"unknown output activation {kind!r}")


def render_transmission(raw_field, initial_intensities, depth_values,
                        activation: str = "softplus", scale_value: float = 1e-2, gate=None):
    """Single-field renderer: ``(int_map [R], sigma [R, S] UNSCALED, dists)``.
    ``gate``: optional ``[R, S]`` multiplier on the activated density (the
    motion hull, ``ops/hull.py``)."""
    dists = depth_deltas(depth_values)
    sigma = output_activation(raw_field[..., -1], activation)
    if gate is not None:
        sigma = sigma * gate
    int_map = initial_intensities - torch.sum(sigma * dists * scale_value, dim=-1)
    return int_map, sigma, dists


def render_transmission_composite(static_raw, temp_raw, initial_intensities, depth_values,
                                  activation: str = "softplus", scale_value: float = 1e-2,
                                  temp_gate=None):
    """Two-field renderer: ``(int_map [R], static_sigma, temp_sigma, dists)``
    with both sigmas PRE-SCALED by ``scale_value``. ``temp_gate``: optional
    ``[R, S]`` multiplier on the scaled dynamic density (the motion hull);
    the regularizers then see the gated dynamic sigma."""
    dists = depth_deltas(depth_values)
    static_sigma = output_activation(static_raw[..., -1], activation) * scale_value
    temp_sigma = output_activation(temp_raw[..., -1], activation) * scale_value
    if temp_gate is not None:
        temp_sigma = temp_sigma * temp_gate
    weights = (static_sigma + temp_sigma) * dists
    int_map = initial_intensities - torch.sum(weights, dim=-1)
    return int_map, static_sigma, temp_sigma, dists
