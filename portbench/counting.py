"""Operations, bytes and peaks: the least time the H100 could take for the
work a function needs from its inputs, whatever implements it.

A field's forward is ``2 * MACs`` per point, its MACs the input layer,
the hidden layers and the output (``field_macs``). K1 is every field's
forward over the points; K2, whose inputs hold no activations, is three
times that (the recompute, dX and dW); a train step is three forward
passes' worth (forward and backward, the recompute not counted) and a
rendered view one. Bytes count each input read once and each output
written once. Peaks are NVIDIA's for the H100 SXM, dense, at 700 W:
f32 products run at the TF32 tensor rate, the fastest the card multiplies
f32 operands.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def field_macs(f: dict) -> int:
    """Multiply-adds of one field per point."""
    f_in = f["encoded_features"] + (f["num_time_dim"] if f["use_time_latents"] else 0)
    w = f["num_filters"]
    return f_in * w + f["num_early_layers"] * w * w + w


def field_params(f: dict) -> int:
    """Floats of one field's weights, biases and latent table."""
    f_in = f["encoded_features"] + (f["num_time_dim"] if f["use_time_latents"] else 0)
    w, n = f["num_filters"], f["num_early_layers"]
    lat = 10 * f["num_time_dim"] if f["use_time_latents"] else 0
    return f_in * w + w + n * (w * w + w) + w + 1 + lat


def forward_flops(cfg: dict, points: int) -> float:
    """Every field's forward over ``points``."""
    return 2.0 * sum(field_macs(f) for f in cfg["fields"].values()) * points


def _input_bytes(cfg: dict, rays: int, samples: int) -> float:
    """What the kernels read besides weights: rays (origins, directions,
    phases) and the shared depths for the ray form; the points (and their
    phases, with a temporal field) for the point form of one field."""
    points = rays * samples
    if cfg["method"] == "static":
        return 12.0 * points
    tables = sum(f["pos_enc_basis"] for f in cfg["fields"].values())
    return 4.0 * (7 * rays + samples + tables)


def k1_bound_s(cfg: dict, rays: int, samples: int) -> float:
    """K1: max(operations / peak, bytes / bandwidth); it writes one raw
    density per field and point."""
    n, fields = rays * samples, len(cfg["fields"])
    par = sum(field_params(f) for f in cfg["fields"].values())
    flops = forward_flops(cfg, n)
    nbytes = _input_bytes(cfg, rays, samples) + 4.0 * par + 4.0 * fields * n
    return max(flops / PEAK_FLOPS[cfg["compute_dtype"]], nbytes / PEAK_BYTES)


def k2_bound_s(cfg: dict, rays: int, samples: int) -> float:
    """K2: three forwards' operations; it reads one cotangent per field and
    point and the weights, and writes every gradient."""
    n, fields = rays * samples, len(cfg["fields"])
    par = sum(field_params(f) for f in cfg["fields"].values())
    flops = 3 * forward_flops(cfg, n)
    nbytes = _input_bytes(cfg, rays, samples) + 8.0 * par + 4.0 * fields * n
    return max(flops / PEAK_FLOPS[cfg["compute_dtype"]], nbytes / PEAK_BYTES)
