"""Static (CPPN) and temporal coordinate-MLP fields as plain functions over a
parameter dict (port of ``nerfca_tpu/models/fields.py``).

    encode(x) -> [input layer -> ReLU] -> num_early x [hidden -> ReLU]
              -> optional skip: concat(encoded, h) -> [skip layer -> ReLU]
                 -> (num_late - 1) x [hidden -> ReLU]
              -> linear output (1 channel of raw density)

The temporal field concatenates a learnable per-phase latent row
(10 cardiac phases x ``num_time_dim``) to the encoded position.

``hidden_activation`` ``'leaky_relu'`` (slope 0.01) takes the ReLUs'
place; ``pos_enc`` ``'hashgrid'`` encodes through a learned table, the
leaf ``"table"`` (``ops/encoding.py::hash_encode``), over a cube of half
extent ``hash_bound`` at the origin. Both are the port's own, for NAF's
attenuation field (Zha et al., MICCAI 2022: the hash grid, then 32 -> 32
-> 32, ``concat(encoded, h)`` -> 32, -> 1, LeakyReLU between), which maps
onto the layers above as one early layer, a skip and no late layer at
width 32. A checkpoint leaves them out of its field configs where they
hold their defaults (:data:`PORT_ONLY_DEFAULTS`), so that the JAX package
reads those configs.

Parameter layout: the same tree as the JAX package, ``{"early": [{"w",
"b"}, ...], "out": {"w", "b"}, "latents", "fourier"}``, but every ``w`` is
kept in the ``nn.Linear`` layout ``[out, in]`` (JAX keeps ``[in, out]``);
:func:`params_from_jax` and :func:`params_to_jax` convert. A ``fourier``
field carries its fixed Gaussian projection as the leaf ``"fourier"``,
drawn as JAX draws it; it is a buffer that no gradient reaches. A field
with ``num_late_layers > 0`` adds the leaves ``"skip"`` and ``"late"``, a
``hashgrid`` field the trained leaf ``"table"``.

``compute_dtype`` ``torch.bfloat16`` (or ``"bfloat16"``) rounds every
matmul operand to bf16 (round to nearest even) and keeps the products, the
biases and the ReLUs in f32, as JAX's ``astype`` + ``preferred_element_type``
does; autograd through the casts then rounds each weight's and each
activation's gradient to bf16, as the transpose of JAX's ``astype`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.encoding import (
    HASH_FEATURES, HASH_TABLE_ENTRIES, encoded_feature_count, hash_encode,
    make_fourier_coefficients, posenc,
)

Params = Dict[str, Any]

NUM_CARDIAC_PHASES = 10
LEAKY_SLOPE = 0.01  # NAF's nn.LeakyReLU() default
HASH_INIT = 1e-4  # Instant-NGP's table init, U(-1e-4, 1e-4)
# the FieldConfig keys the JAX package lacks, at their defaults
PORT_ONLY_DEFAULTS = {"hidden_activation": "relu", "hash_bound": 0.0}


@dataclasses.dataclass(frozen=True)
class FieldConfig:
    """Hyperparameters of one field MLP (same fields as the JAX package)."""

    num_early_layers: int = 4
    num_late_layers: int = 0
    num_filters: int = 128
    num_input_channels: int = 3
    num_output_channels: int = 1
    use_bias: bool = True
    pos_enc: str = "free_windowed"
    pos_enc_basis: int = 12
    pos_enc_window_start: int = 0
    pos_enc_window_decay_steps: int = 150000
    pos_enc_window_max: float = 0.0
    fourier_sigma: float = 0.0
    use_time_latents: bool = False
    num_time_dim: int = 8
    hidden_activation: str = "relu"
    hash_bound: float = 0.0

    @property
    def encoded_features(self) -> int:
        return encoded_feature_count(self.pos_enc, self.pos_enc_basis, self.num_input_channels)

    @property
    def input_features(self) -> int:
        if self.use_time_latents:
            return self.encoded_features + self.num_time_dim
        return self.encoded_features


def _init_linear(key, fan_in: int, fan_out: int, use_bias: bool, device) -> Params:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weight and bias, the
    ``nn.Linear`` default, drawn as the JAX package draws them (the weight
    as ``[in, out]``, stored transposed)."""
    bound = np.float32(1.0) / np.sqrt(np.float32(fan_in))
    wkey, bkey = prng.split(key)
    w = prng.uniform(wkey, (fan_in, fan_out), -bound, bound)
    layer = {"w": torch.from_numpy(w.T.copy()).to(device)}
    if use_bias:
        layer["b"] = torch.from_numpy(prng.uniform(bkey, (fan_out,), -bound, bound)).to(device)
    return layer


def _init_mlp(key, cfg: FieldConfig, device) -> Params:
    keys = iter(prng.split(key, cfg.num_early_layers + cfg.num_late_layers + 3))
    f_in, width = cfg.input_features, cfg.num_filters
    early = [_init_linear(next(keys), f_in, width, cfg.use_bias, device)]
    for _ in range(cfg.num_early_layers):
        early.append(_init_linear(next(keys), width, width, cfg.use_bias, device))
    params: Params = {"early": early}
    if cfg.num_late_layers > 0:
        params["skip"] = _init_linear(next(keys), width + f_in, width, cfg.use_bias, device)
        params["late"] = [_init_linear(next(keys), width, width, cfg.use_bias, device)
                          for _ in range(cfg.num_late_layers - 1)]
    params["out"] = _init_linear(next(keys), width, cfg.num_output_channels, cfg.use_bias,
                                 device)
    return params


def init_static_field(key, cfg: FieldConfig, device=None) -> Params:
    """Initialize a static field from an ``ops/prng.py`` key: the params the
    JAX package's ``init_static_field`` draws from the same key (for
    ``'fourier'``, the projection from ``fold_in(key, 0xF0)`` times
    ``fourier_sigma``)."""
    params = _init_mlp(key, cfg, device)
    if cfg.pos_enc == "fourier":
        params["fourier"] = make_fourier_coefficients(
            prng.fold_in(key, 0xF0), cfg.pos_enc_basis, cfg.fourier_sigma,
            cfg.num_input_channels, device)
    if cfg.pos_enc == "hashgrid":
        table = prng.uniform(prng.fold_in(key, 0x4A5), (HASH_TABLE_ENTRIES, HASH_FEATURES),
                             -HASH_INIT, HASH_INIT)
        params["table"] = torch.from_numpy(table).to(device)
    return params


def init_temporal_field(key, cfg: FieldConfig, device=None) -> Params:
    """Initialize a temporal field including its Uniform[0,1) latent table
    (from ``fold_in(key, 0x71)``, as the JAX package draws it)."""
    if not cfg.use_time_latents:
        raise ValueError("temporal field requires use_time_latents=True")
    params = init_static_field(key, cfg, device)
    latents = prng.uniform(prng.fold_in(key, 0x71), (NUM_CARDIAC_PHASES, cfg.num_time_dim))
    params["latents"] = torch.from_numpy(latents).to(device)
    return params


def torch_dtype(compute_dtype) -> torch.dtype:
    """``compute_dtype`` (a torch dtype, its name, or None for f32) as a torch
    dtype: float32 or bfloat16."""
    if compute_dtype in (torch.float32, "float32", None):
        return torch.float32
    if compute_dtype in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype!r}")


def _linear(layer: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w.T + b`` with both operands rounded to ``compute_dtype``, the
    product accumulated and the bias added in f32."""
    w = layer["w"]
    if compute_dtype == torch.bfloat16:
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    return F.linear(x, w, layer.get("b"))


def hidden_activation(cfg: FieldConfig):
    """The hidden layers' activation: ReLU, or LeakyReLU at :data:`LEAKY_SLOPE`."""
    if cfg.hidden_activation == "relu":
        return torch.relu
    if cfg.hidden_activation == "leaky_relu":
        return lambda x: F.leaky_relu(x, LEAKY_SLOPE)
    raise ValueError(f"hidden_activation must be relu or leaky_relu, got "
                     f"{cfg.hidden_activation!r}")


def apply_mlp(params: Params, features: torch.Tensor, cfg: FieldConfig,
              return_intermediates: bool = False, compute_dtype=torch.float32):
    """Run the MLP trunk on already-encoded features ``[..., F]``."""
    cd = torch_dtype(compute_dtype)
    act = hidden_activation(cfg)
    intermediates = []
    h = features
    for layer in params["early"]:
        h = act(_linear(layer, h, cd))
        if return_intermediates:
            intermediates.append(h)
    if cfg.num_late_layers > 0:
        h = act(_linear(params["skip"], torch.cat([features, h], dim=-1), cd))
        if return_intermediates:
            intermediates.append(h)
        for layer in params["late"]:
            h = act(_linear(layer, h, cd))
            if return_intermediates:
                intermediates.append(h)
    out = _linear(params["out"], h, cd)
    if return_intermediates:
        return out, intermediates
    return out


def apply_static_field(params: Params, points: torch.Tensor, cfg: FieldConfig,
                       window: Optional[torch.Tensor] = None,
                       return_intermediates: bool = False, compute_dtype=torch.float32):
    """``points [..., 3] -> raw density [..., C_out]``."""
    return apply_mlp(params, encode(params, points, cfg, window), cfg, return_intermediates,
                     compute_dtype)


def encode(params: Params, points: torch.Tensor, cfg: FieldConfig, window=None):
    """A field's encoding of ``points [..., 3]``: the hash grid over the
    field's table, or :func:`posenc`."""
    if cfg.pos_enc == "hashgrid":
        return hash_encode(points, params["table"], cfg.hash_bound)
    return posenc(points, cfg.pos_enc, cfg.pos_enc_basis, window=window,
                  fourier_coefficients=params.get("fourier"))


def apply_temporal_field(params: Params, points: torch.Tensor, phases: torch.Tensor,
                         cfg: FieldConfig, window: Optional[torch.Tensor] = None,
                         return_intermediates: bool = False, compute_dtype=torch.float32):
    """``points [..., 3]``, integer ``phases [...]`` -> raw density; the
    phase's latent row is concatenated to the encoded position."""
    enc = encode(params, points, cfg, window)
    latents = params["latents"][phases.long()]
    return apply_mlp(params, torch.cat([enc, latents], dim=-1), cfg, return_intermediates,
                     compute_dtype)


def _map_tree(tree, leaf_fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, leaf_fn) if isinstance(v, (dict, list)) else leaf_fn(k, v)
                for k, v in tree.items()}
    return [_map_tree(v, leaf_fn) for v in tree]


def params_from_jax(tree, device=None) -> Params:
    """JAX field parameters (numpy arrays, ``w`` as ``[in, out]``) -> the
    port's tensors (``w`` as ``[out, in]``)."""
    def leaf(key, v):
        a = np.asarray(v, dtype=np.float32)
        return torch.tensor(a.T.copy() if key == "w" else a, device=device)
    return _map_tree(tree, leaf)


def params_to_jax(params: Params) -> dict:
    """Inverse of :func:`params_from_jax`: numpy arrays, ``w`` as ``[in, out]``."""
    def leaf(key, v):
        a = v.detach().cpu().numpy()
        return a.T.copy() if key == "w" else a
    return _map_tree(params, leaf)
