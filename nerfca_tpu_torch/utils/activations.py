"""Model-understanding API: capture intermediate activations (port of
``nerfca_tpu/utils/activations.py``).

The reference carries a dormant activation-capture stub on both models
(``store_activations`` / ``activation_dictionary``, ``model/CPPN.py:67-86``,
``model/Temporal.py:56-58,107-111``) that is never populated. Here it is
functional: run a plain field forward and get a named dictionary of every
hidden activation, without mutating any state.
"""

from __future__ import annotations

import torch

from nerfca_tpu_torch.models.fields import (
    FieldConfig,
    apply_static_field,
    apply_temporal_field,
)


def capture_static_activations(params, points, cfg: FieldConfig,
                               window=None) -> dict[str, torch.Tensor]:
    """Forward the static field and return ``{layer_name: activation}``
    plus the raw output under ``'output'``."""
    out, inter = apply_static_field(params, points, cfg, window=window,
                                    return_intermediates=True)
    return _name_activations(out, inter, cfg)


def capture_temporal_activations(params, points, phases, cfg: FieldConfig,
                                 window=None) -> dict[str, torch.Tensor]:
    """:func:`capture_static_activations` for the temporal field, plus the
    latent rows the ``phases`` (cast to int) select under ``'latents'``."""
    phases = torch.as_tensor(phases, device=points.device).long()
    out, inter = apply_temporal_field(params, points, phases, cfg, window=window,
                                      return_intermediates=True)
    acts = _name_activations(out, inter, cfg)
    acts["latents"] = params["latents"][phases]
    return acts


def _name_activations(out, intermediates, cfg: FieldConfig) -> dict:
    names = ["input_layer"] + [f"early_{i}" for i in range(cfg.num_early_layers)]
    if cfg.num_late_layers > 0:
        names.append("skip")
        names += [f"late_{i}" for i in range(cfg.num_late_layers - 1)]
    acts = dict(zip(names, intermediates))
    acts["output"] = out
    return acts


def activation_statistics(acts: dict) -> dict:
    """Per-layer summary stats (mean/std/frac-dead) for quick inspection;
    ``std`` is the population one (``correction=0``), as ``jnp.std``."""
    stats = {}
    for name, a in acts.items():
        a = a.detach().float()
        stats[name] = {
            "mean": float(torch.mean(a)),
            "std": float(torch.std(a, correction=0)),
            "frac_zero": float(torch.mean((a == 0.0).float())),
            "shape": tuple(a.shape),
        }
    return stats
