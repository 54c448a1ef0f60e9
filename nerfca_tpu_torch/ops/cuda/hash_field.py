"""The hash-grid field's forward on the card: one launch of
``csrc/hash_field.cu::hash_field_kernel`` a tile of rays, with its torch
twin.

The field is NAF's attenuation field (``models/fields.py``: a
``hashgrid`` encoding over the ``"table"`` leaf, one early layer, a skip,
width 32, LeakyReLU). The kernel takes the ray form (origins, directions,
the shared depths), so no ``[R * S, 3]`` array is ever made, and writes the
tile's raw densities ``[R * S]``, which the static method's Beer-Lambert
kernel (``fused_train.py::eval_static``) reads. The eval renderer takes it
(``train/evaluation.py``); training runs the plain field, whose autograd
reaches the table (no kernel computes the hash grid's backward).

:func:`twin_hash_field_rays` is the kernel's math in torch: the points,
the plain field's encoding (``ops/encoding.py::hash_encode``, which the
kernel computes bitwise), and the MLP as the kernel's ``fmaf`` chains (each
multiply-add rounded once, through float64: the exact product plus the
addend, rounded to f32, which is the fused result but where a double
rounding lands on a tie). Its raw densities are the kernel's up to those
rare ties.

``LAUNCHES["hash_field.kernel"]`` counts the kernel's launches, one a tile;
``["hash_field.plain_views"]`` the eval views whose hash field rendered on
the plain path (counted by ``train/evaluation.py``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nerfca_tpu_torch.models.fields import LEAKY_SLOPE, FieldConfig
from nerfca_tpu_torch.ops.cuda import build
from nerfca_tpu_torch.ops.encoding import (
    HASH_DENSE, HASH_FEATURES, HASH_LEVELS, HASH_OFFSETS, HASH_RES, HASH_TABLE_ENTRIES,
    hash_encode,
)

WIDTH = 32
ENCODED = HASH_LEVELS * HASH_FEATURES

LAUNCHES = {"hash_field.kernel": 0, "hash_field.plain_views": 0}


def kernel_supported(cfg: FieldConfig) -> bool:
    """The kernel's envelope: NAF's field, a ``hashgrid`` encoding over a
    box, one early layer and a skip at width 32, LeakyReLU, one output."""
    return (
        cfg.pos_enc == "hashgrid"
        and cfg.hash_bound > 0
        and cfg.num_filters == WIDTH
        and cfg.num_early_layers == 1
        and cfg.num_late_layers == 1
        and cfg.hidden_activation == "leaky_relu"
        and cfg.num_input_channels == 3
        and cfg.num_output_channels == 1
        and cfg.use_bias
        and not cfg.use_time_latents
    )


def _weights(params) -> list:
    """The kernel's eight weight and bias tensors, in its order."""
    (l0, l1), skip, out = params["early"], params["skip"], params["out"]
    return [l0["w"], l0["b"], l1["w"], l1["b"], skip["w"], skip["b"], out["w"], out["b"]]


# ---------------------------------------------------------------------------
# The twin


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)``: the exact product plus ``c``, rounded once (to
    f64, then f32)."""
    return (a.double() * b.double() + c.double()).float()


def _dense(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, acc=None) -> torch.Tensor:
    """Each output's ``fmaf`` chain over the inputs in order, from the bias
    (or ``acc``): ``[P, in] -> [P, out]``."""
    acc = b.expand(x.shape[0], -1) if acc is None else acc
    for i in range(x.shape[1]):
        acc = _fma(w[:, i][None, :], x[:, i:i + 1], acc)
    return acc


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, x * LEAKY_SLOPE)


@torch.no_grad()
def twin_hash_field_rays(params, origins, directions, z, cfg: FieldConfig) -> torch.Tensor:
    """The kernel's raw densities ``[R, S]`` in torch, for the rays
    ``origins/directions [R, 3]`` at the shared depths ``z [S]``."""
    pts = (origins[:, None, :] + directions[:, None, :] * z[None, :, None]).reshape(-1, 3)
    enc = hash_encode(pts, params["table"], cfg.hash_bound)
    w0, b0, w1, b1, ws, bs, wo, bo = _weights(params)
    h1 = _leaky(_dense(w0, b0, enc))
    h2 = _leaky(_dense(w1, b1, h1))
    h3 = _leaky(_dense(ws[:, ENCODED:], None, h2, acc=_dense(ws[:, :ENCODED], bs, enc)))
    raw = bo.expand(pts.shape[0], 1)
    for j in range(WIDTH):
        raw = _fma(wo[:, j][None, :], h3[:, j:j + 1], raw)
    return raw.reshape(origins.shape[0], z.shape[0])


# ---------------------------------------------------------------------------
# The kernel


class HashLevels(ctypes.Structure):
    _fields_ = [("res", ctypes.c_int * HASH_LEVELS), ("offset", ctypes.c_int * HASH_LEVELS),
                ("dense", ctypes.c_int * HASH_LEVELS)]


class HashFieldArgs(ctypes.Structure):
    _fields_ = [*((n, ctypes.c_void_p) for n in ("w0", "b0", "w1", "b1", "ws", "bs", "wo", "bo",
                                                 "table", "origins", "dirs", "z", "out")),
                ("bound", ctypes.c_float), ("slope", ctypes.c_float),
                ("n_rays", ctypes.c_int), ("n_samples", ctypes.c_int), ("lv", HashLevels)]


LEVELS = HashLevels((ctypes.c_int * HASH_LEVELS)(*HASH_RES),
                    (ctypes.c_int * HASH_LEVELS)(*HASH_OFFSETS),
                    (ctypes.c_int * HASH_LEVELS)(*(int(d) for d in HASH_DENSE)))

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("hash_field")
        lib.hash_field_fwd.argtypes = [ctypes.POINTER(HashFieldArgs), ctypes.c_void_p]
        lib.hash_field_fwd.restype = ctypes.c_int
        if (lib.hash_field_args_bytes() != ctypes.sizeof(HashFieldArgs)
                or lib.hash_field_levels() != HASH_LEVELS):
            raise RuntimeError("the hash-field kernel's arguments differ from the wrapper's")
        _LIB = lib
    return _LIB


class HashFieldRays:
    """The hash-grid field in the ray form on the card, for a caller that
    takes no gradient (the eval renderer): the field's tensors checked once,
    then each call one launch of the kernel on up to ``n_rays`` rays at the
    shared ``[S]`` depths. The kernel reads the weights and the table where
    they are, so a CUDA graph of its launches reads them at replay."""

    def __init__(self, params, cfg: FieldConfig, n_rays: int):
        if not kernel_supported(cfg):
            raise ValueError("the hash-field kernel takes NAF's field alone (kernel_supported)")
        self.leaves = _weights(params) + [params["table"]]
        dev = params["table"].device
        shapes = [(WIDTH, ENCODED), (WIDTH,), (WIDTH, WIDTH), (WIDTH,),
                  (WIDTH, ENCODED + WIDTH), (WIDTH,), (1, WIDTH), (1,),
                  (HASH_TABLE_ENTRIES, HASH_FEATURES)]
        for t, shape in zip(self.leaves, shapes):
            if (t.shape != shape or t.dtype != torch.float32 or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(f"a hash-field leaf {tuple(t.shape)} {t.dtype} on {t.device}: "
                                 f"expected a contiguous float32 {shape} on {dev}")
        self.cfg, self.n_rays, self.device = cfg, n_rays, dev

    def __call__(self, origins, directions, z) -> torch.Tensor:
        """The raw densities ``[R, S]`` of the rays ``origins/directions
        [R, 3]`` at the shared depths ``z [S]``."""
        r, s = origins.shape[0], z.shape[-1]
        for name, t in (("origins", origins), ("directions", directions), ("z", z)):
            if t.device != self.device or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous float32 tensor on {self.device}")
        if origins.shape != (r, 3) or directions.shape != (r, 3) or z.dim() != 1:
            raise ValueError("origins and directions must both be [R, 3], z the shared [S]")
        if r > self.n_rays or r * s >= 2**31:
            raise ValueError(f"{r} rays x {s} samples outside the launch's {self.n_rays} rays")
        out = torch.empty(r * s, device=self.device)
        args = HashFieldArgs(*(t.data_ptr() for t in self.leaves), origins.data_ptr(),
                             directions.data_ptr(), z.data_ptr(), out.data_ptr(),
                             self.cfg.hash_bound, LEAKY_SLOPE, r, s, LEVELS)
        LAUNCHES["hash_field.kernel"] += 1
        code = _lib().hash_field_fwd(ctypes.byref(args),
                                     torch.cuda.current_stream(self.device).cuda_stream)
        if code != 0:
            raise RuntimeError(f"hash_field_fwd failed: CUDA error {code}")
        return out.view(r, s)
