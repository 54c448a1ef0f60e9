"""Fused encode -> MLP evaluation of the composite fields, or of the static
field alone: CUDA kernels K1 (forward) and K2 (its backward) with their
plain PyTorch version.

K1 ``fused_field_fwd`` replaces ``nerfca_tpu/ops/pallas/fused_field.py::
_fwd_kernel`` and K2 ``fused_field_bwd`` replaces ``::_bwd_kernel``, the
custom VJP of K1. Both live in ``nerfca_tpu_torch/csrc/fused_field.cu``;
the source note there says what bounds them on the H100 and how the
design keeps every activation out of HBM. Both run their matrix products
on the tensor cores in 3xTF32. K1 in f32 is ``fwd_kernel_wgmma``
(``csrc/k1_wgmma.cuh``): ``wgmma`` with the activations in registers,
a producer warp streaming weight planes (split into their TF32 parts once
a launch by ``fwd_kernel_wsplit``) to clusters of two persistent CTAs,
encoder warps filling the next tile. K2, and K1 in bf16, run ``mma.sync``
(``csrc/field_mma.cuh``) over 128-point tiles. The fused-loss step
(``fused_train.py``) takes its forward from K1. The kernels take the ray
form (origins, directions, per-ray or shared depths, per-ray phases, the
latent table) and build points and latents themselves, so no ``[R*S, 3]``
or ``[N, 8]`` array is ever materialized.

Entries, each with its plain twin:

  - :func:`fused_composite_fields_rays`, the ray form (both fields);
  - :func:`fused_composite_fields`, the point form: already-materialized
    points ``[R, S, 3]`` with per-point phases, run as ``R*S`` rays of one
    sample each (origin the point, direction 0, depth 0, so ``o + z*d`` is
    the point bit for bit);
  - :func:`fused_static_field`, the static method's field: the point form
    with no temporal field, which launches the one-field instantiation of
    K1 and K2 (``NF == 1`` in the source: half the CTAs of a composite
    launch, the gradient the static block alone).

bf16 compute (``compute_dtype="bfloat16"``, ``nerfca_tpu/ops/pallas/
fused_field.py:709,730-738,793``): the kernels' BF16 instantiations round
every matmul operand (weights, encoding, latents, each hidden ``h``) to
bf16 at the fragment load and run one bf16 ``mma.sync.m16n8k16`` product
per MAC into f32; biases, ReLUs and the output stay f32, and every
gradient leaves in f32 with the JAX kernel's cast points (``_field_bwd``).
The weights stay f32 in memory: the kernels convert, so there is no copy
per step. K3 also launches K2 over bf16 residual storage
(``fused_field_bwd(..., res_bf16=True)``, f32 products).

Dispatch: CPU tensors take the plain twin (:func:`twin_composite_fields_rays`
and its kin: encode + MLP in torch; in f32 the plain fields with autograd,
in bf16 :class:`_TwinMLP`, whose backward follows the JAX kernel's cast
points); CUDA tensors launch the kernels or raise. The kernels are
built with ``nvcc`` into ``build/kernels/`` at first use (a plain C
interface loaded with ``ctypes``; see ``build.py``).

Encodings: ``'none'``, the windowed modes and ``'fourier'``. A fourier
field hands its fixed projection (the ``"fourier"`` leaf) to the kernels
in place of the band window; they recompute ``[sin(v), cos(v)]`` with the
plain version's roundings, and its gradient is zero, as in JAX
(``fused_field.py:623-627``; the plain version stops it). The C entries
launch the kernels' FOURIER instantiation when a field is fourier.

Launch counts: ``LAUNCHES["fused_field_fwd"]`` / ``["fused_field_bwd"]``
(two fields) and ``["fused_static_field_fwd"]`` /
``["fused_static_field_bwd"]`` (one field) grow by one at each launch of
the f32 instantiations and nowhere else; the same names with ``_bf16``
count the bf16 ones, and ``["fused_field_bwd_res_bf16"]`` K2 over bf16
residuals. K1's route, whatever its fields: ``["fused_field_fwd.wgmma"]``
counts the f32 launches (``fwd_kernel_wgmma``), ``["fused_field_fwd.mma_sync"]``
the bf16 ones (``fwd_kernel``).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nerfca_tpu_torch.models.fields import (
    FieldConfig,
    apply_mlp,
    apply_static_field,
    apply_temporal_field,
    torch_dtype,
)
from nerfca_tpu_torch.ops.cuda import build
from nerfca_tpu_torch.ops.encoding import posenc

WIDTH = 128
ROW_STRIDE = 140  # LDH in the source
BWD_TILE_POINTS = 128  # BTP in the source: K2's tile (K1's is K1_TP there)
MAX_ENCODED = 128
MAX_LAT = 8
MAX_PHASES = 16
BWD_CTAS = 132  # fixed so the gradient reduction order never depends on the card

# the C entries' modes: f32 products (3xTF32), bf16 products, and (K2 with
# two fields) f32 products over bf16 residual storage
MODE_F32, MODE_BF16, MODE_RES_BF16 = 0, 1, 2
_SUFFIX = {MODE_F32: "", MODE_BF16: "_bf16", MODE_RES_BF16: "_res_bf16"}

LAUNCHES = {"fused_field_fwd": 0, "fused_field_bwd": 0, "fused_static_field_fwd": 0,
            "fused_static_field_bwd": 0, "fused_field_fwd_bf16": 0, "fused_field_bwd_bf16": 0,
            "fused_static_field_fwd_bf16": 0, "fused_static_field_bwd_bf16": 0,
            "fused_field_bwd_res_bf16": 0, "fused_field_fwd.wgmma": 0,
            "fused_field_fwd.mma_sync": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_supported(cfg: FieldConfig) -> bool:
    """Envelope of the CUDA kernels: the Pallas envelope
    (``fused_field.py:71-80``: fourier with ``6 * basis <= 128`` included),
    with biases."""
    return (
        cfg.num_filters == WIDTH
        and cfg.num_late_layers == 0
        and cfg.num_output_channels == 1
        and cfg.num_input_channels == 3
        and cfg.use_bias
        and cfg.pos_enc in ("none", "free_windowed", "nerfies_windowed", "fourier")
        and cfg.encoded_features <= MAX_ENCODED
        and cfg.num_time_dim <= MAX_LAT
    )


def is_bf16(compute_dtype) -> bool:
    return torch_dtype(compute_dtype) == torch.bfloat16


def enc_table(params, cfg: FieldConfig, window):
    """What a field's encoding reads besides the points: its projection for
    ``'fourier'`` (the window is then unused, as in JAX), else its window."""
    return params["fourier"] if cfg.pos_enc == "fourier" else window


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the reference on the card)


def _points(origins, directions, z):
    z_rs = z if z.dim() == 2 else z.expand(origins.shape[0], z.shape[0])
    return origins[:, None, :] + directions[:, None, :] * z_rs[..., None]


def plain_composite_fields_rays(params_s, params_t, origins, directions, z, ray_phases,
                                cfg_s: FieldConfig, cfg_t: FieldConfig, window_s, window_t,
                                compute_dtype="float32"):
    """Encode + both MLPs in torch (the plain fields, autograd through them):
    ``[R, S, 1]`` raw densities per field."""
    pts = _points(origins, directions, z)
    phases = ray_phases.long()[:, None].expand(pts.shape[:2])
    return plain_composite_fields(params_s, params_t, pts, phases, cfg_s, cfg_t, window_s,
                                  window_t, compute_dtype)


def plain_composite_fields(params_s, params_t, points, point_phases, cfg_s: FieldConfig,
                           cfg_t: FieldConfig, window_s, window_t, compute_dtype="float32"):
    """Point form in torch: ``points [R, S, 3]``, integer ``point_phases
    [R, S]`` -> two ``[R, S, 1]`` raw-density tensors."""
    raw_s = apply_static_field(params_s, points, cfg_s, window=window_s,
                               compute_dtype=compute_dtype)
    raw_t = apply_temporal_field(params_t, points, point_phases.long(), cfg_t, window=window_t,
                                 compute_dtype=compute_dtype)
    return raw_s, raw_t


def plain_static_field(params, points, cfg: FieldConfig, window, compute_dtype="float32"):
    """The static field in torch: ``points [R, S, 3] -> [R, S, 1]``."""
    return apply_static_field(params, points, cfg, window=window, compute_dtype=compute_dtype)


# The kernels' twins: in f32 the plain fields above; in bf16 (or over bf16
# residuals) the same forward with the backward of the JAX kernel
# (``nerfca_tpu/ops/pallas/fused_field.py::_field_bwd``), whose cast points
# differ from autograd through the plain bf16 fields: it returns f32 weight
# gradients (autograd rounds them to bf16) and casts g, dpre and h to bf16
# at each product.


def _round(x: torch.Tensor, on: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if on else x


class _TwinMLP(torch.autograd.Function):
    """One field's MLP on ``[..., k0]`` features (the encoding, then the
    latents) with the JAX kernel's backward. ``bf16``: bf16 operands at
    every product, forward and backward. ``res_bf16`` (f32 products): the
    stored post-ReLU activations are rounded to bf16 before the backward
    reads them (ReLU masks, dW and dwo operands), as the JAX K3 stores its
    residuals; the forward is the f32 one, bit for bit. Gradients flow to
    the leaves (``_leaves`` order) and to ``lat``; ``enc`` is constant."""

    @staticmethod
    def forward(ctx, cfg, bf16, res_bf16, enc, lat, *leaves):
        feats = enc if lat is None else torch.cat([enc, lat], -1)
        n_layers = len(leaves) // 2 - 1
        params = {"early": [{"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                            for i in range(n_layers)],
                  "out": {"w": leaves[-2], "b": leaves[-1]}}
        out, hs = apply_mlp(params, feats, cfg, return_intermediates=True,
                            compute_dtype=torch.bfloat16 if bf16 else torch.float32)
        ctx.flags = (bf16, res_bf16, enc.shape[-1], None if lat is None else lat.shape)
        ctx.save_for_backward(feats, *hs, *leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        bf16, res_bf16, n_enc, lat_shape = ctx.flags
        feats, *rest = ctx.saved_tensors
        n_layers = len(rest) // 3
        hs, leaves = rest[:n_layers], rest[n_layers:]
        rc = lambda x: _round(x, bf16)  # noqa: E731 - a product operand
        k0 = feats.shape[-1]
        feats, g = feats.reshape(-1, k0), g.reshape(-1, 1)
        hs = [_round(h.reshape(-1, h.shape[-1]), res_bf16) for h in hs]  # the stored residuals
        ws = leaves[0:-2:2]
        grads = [None] * len(leaves)
        grads[-2] = rc(g).t() @ rc(hs[-1])
        grads[-1] = g.sum(0)
        dh = rc(leaves[-2]) * rc(g)
        for l in range(n_layers - 1, -1, -1):
            dpre = dh * (hs[l] > 0)
            grads[2 * l] = rc(dpre).t() @ rc(feats if l == 0 else hs[l - 1])
            grads[2 * l + 1] = dpre.sum(0)
            if l > 0:
                dh = rc(dpre) @ rc(ws[l])
        d_lat = None
        if lat_shape is not None and ctx.needs_input_grad[4]:
            d_lat = (rc(dpre) @ rc(ws[0][:, n_enc:])).reshape(lat_shape)
        return (None, None, None, None, d_lat, *grads)


def _twin_field(params, enc, lat, cfg: FieldConfig, bf16: bool, res_bf16: bool):
    if cfg.num_late_layers:
        raise NotImplementedError("skip/late layers lie outside the field kernels' envelope")
    return _TwinMLP.apply(cfg, bf16, res_bf16, enc, lat, *_leaves(params))


def twin_composite_fields(params_s, params_t, points, point_phases, cfg_s: FieldConfig,
                          cfg_t: FieldConfig, window_s, window_t, compute_dtype="float32",
                          res_bf16: bool = False, hand_backward: bool = False):
    """The kernels' twin in the point form: :func:`plain_composite_fields`
    in f32; with bf16 compute (or ``res_bf16``) the same forward with the
    JAX kernel's backward (:class:`_TwinMLP`). ``hand_backward`` takes that
    backward in f32 too: the same sums as the ``res_bf16`` twin's but for
    the rounding, the reference that its change is read against."""
    bf16 = is_bf16(compute_dtype)
    points = points.detach()  # the kernels return no cotangent for the points or depths
    if not (bf16 or res_bf16 or hand_backward):
        return plain_composite_fields(params_s, params_t, points, point_phases, cfg_s, cfg_t,
                                      window_s, window_t)
    enc_s = posenc(points, cfg_s.pos_enc, cfg_s.pos_enc_basis, window=window_s,
                   fourier_coefficients=params_s.get("fourier"))
    enc_t = posenc(points, cfg_t.pos_enc, cfg_t.pos_enc_basis, window=window_t,
                   fourier_coefficients=params_t.get("fourier"))
    lat = params_t["latents"][point_phases.long()]
    return (_twin_field(params_s, enc_s, None, cfg_s, bf16, res_bf16),
            _twin_field(params_t, enc_t, lat, cfg_t, bf16, res_bf16))


def twin_composite_fields_rays(params_s, params_t, origins, directions, z, ray_phases,
                               cfg_s: FieldConfig, cfg_t: FieldConfig, window_s, window_t,
                               compute_dtype="float32", res_bf16: bool = False,
                               hand_backward: bool = False):
    """The kernels' twin in the ray form (:func:`twin_composite_fields` on
    the rays' points)."""
    pts = _points(origins, directions, z)
    phases = ray_phases.long()[:, None].expand(pts.shape[:2])
    return twin_composite_fields(params_s, params_t, pts, phases, cfg_s, cfg_t, window_s,
                                 window_t, compute_dtype, res_bf16, hand_backward)


def twin_static_field(params, points, cfg: FieldConfig, window, compute_dtype="float32"):
    """The one-field kernels' twin: :func:`plain_static_field` in f32, else
    :class:`_TwinMLP` on the static field."""
    if not is_bf16(compute_dtype):
        return plain_static_field(params, points, cfg, window)
    enc = posenc(points, cfg.pos_enc, cfg.pos_enc_basis, window=window,
                 fourier_coefficients=params.get("fourier"))
    return _twin_field(params, enc, None, cfg, True, False)


# ---------------------------------------------------------------------------
# Build and bind


class FieldArgs(ctypes.Structure):
    _fields_ = [("w0", ctypes.c_void_p), ("b0", ctypes.c_void_p), ("wh", ctypes.c_void_p),
                ("bh", ctypes.c_void_p), ("wo", ctypes.c_void_p), ("bo", ctypes.c_void_p),
                ("table", ctypes.c_void_p),  # the band window, or the fourier projection
                ("basis", ctypes.c_int), ("enc", ctypes.c_int),
                ("n_lat", ctypes.c_int), ("n_hidden", ctypes.c_int)]


class RayArgs(ctypes.Structure):
    _fields_ = [("origins", ctypes.c_void_p), ("dirs", ctypes.c_void_p), ("z", ctypes.c_void_p),
                ("phases", ctypes.c_void_p), ("latents", ctypes.c_void_p),
                ("n_rays", ctypes.c_int), ("n_samples", ctypes.c_int),
                ("z_stride", ctypes.c_int), ("n_phases", ctypes.c_int)]


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("fused_field")
        ptr = ctypes.POINTER
        lib.fused_field_fwd.argtypes = [ptr(FieldArgs), ptr(FieldArgs), ptr(RayArgs),
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.fused_field_fwd.restype = ctypes.c_int
        lib.fused_field_fwd_planes_floats.argtypes = [ptr(FieldArgs), ptr(FieldArgs)]
        lib.fused_field_fwd_planes_floats.restype = ctypes.c_long
        lib.fused_field_fwd_split.argtypes = [ptr(FieldArgs), ptr(FieldArgs), ctypes.c_void_p,
                                              ctypes.c_void_p]
        lib.fused_field_fwd_split.restype = ctypes.c_int
        lib.fused_field_fwd_clusters.restype = ctypes.c_int
        lib.fused_field_bwd.argtypes = [ptr(FieldArgs), ptr(FieldArgs), ptr(RayArgs),
                                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                                        ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.fused_field_bwd.restype = ctypes.c_int
        lib.fused_field_grad_size.argtypes = [ptr(FieldArgs), ptr(FieldArgs), ctypes.c_int]
        lib.fused_field_grad_size.restype = ctypes.c_long
        lib.fused_field_bwd_tile_points.restype = ctypes.c_int
        if lib.fused_field_bwd_tile_points() != BWD_TILE_POINTS:
            raise RuntimeError("K2's tile differs between the wrapper and the kernel")
        _LIB = lib
    return _LIB


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


# ---------------------------------------------------------------------------
# K1's weight planes in f32, as ``csrc/k1_wgmma.cuh::fwd_kernel_wsplit``
# writes them: per field the input layer's k-steps of 8 rows (zero past
# its rows), then 16 per hidden layer; a k-step is its TF32 big plane, then
# its small plane, each the 128 x 8 tile of B in wgmma's K-major core
# matrices (element e: output n = 8 (e >> 6) + ((e >> 2) & 7), k slot
# s = 4 ((e >> 5) & 1) + (e & 3)). Slot s holds input SLOT_INPUT[s] of the
# k-step: A's slots t and t + 4 are the accumulator's columns 2t, 2t + 1.

SLOT_INPUT = (0, 2, 4, 6, 1, 3, 5, 7)
KSTEP_FLOATS = 2048


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero (``field_mma.cuh::tf32_rna``), on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _layer_planes(w_in_out: torch.Tensor) -> torch.Tensor:
    """One layer's planes from its ``[k, 128]`` (in, out) weight."""
    k = w_in_out.shape[0]
    w = torch.zeros(-(-k // 8) * 8, WIDTH, dtype=torch.float32, device=w_in_out.device)
    w[:k] = w_in_out
    nk = w.shape[0] // 8
    w = w.view(nk, 8, WIDTH)[:, list(SLOT_INPUT)]  # [kk, slot, n]
    w = w.view(nk, 2, 4, WIDTH // 8, 8).permute(0, 3, 1, 4, 2).reshape(nk, 1024)
    big = tf32_rna(w)
    return torch.stack([big, tf32_rna(w - big)], 1).reshape(-1)


def wgmma_planes(pack_s: "_Pack", pack_t: Optional["_Pack"] = None) -> torch.Tensor:
    """The planes of one pack, or of two (static field first), in torch."""
    out = []
    for pk in (pack_s, pack_t):
        if pk is None:
            continue
        out.append(_layer_planes(pk.w0))
        out += [_layer_planes(pk.wh[l]) for l in range(pk.cfg.num_early_layers)]
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Packing (the kernels read weights as [in, out])


def _leaves(params) -> list:
    """Differentiable leaves of one field, in kernel order."""
    out = []
    for layer in params["early"]:
        out += [layer["w"], layer["b"]]
    return out + [params["out"]["w"], params["out"]["b"]]


class _Pack:
    """Contiguous [in, out] weights of one field plus its FieldArgs; keeps
    the tensors alive while their pointers are in use. ``table`` is the
    field's :func:`enc_table`: its window (None: every band open) or its
    fourier projection. ``bf16`` selects the kernels' bf16 instantiations;
    the weights stay f32 and the kernels round them as they load them."""

    def __init__(self, cfg: FieldConfig, leaves, table, device, bf16: bool = False):
        self.bf16 = bf16
        n_hidden = cfg.num_early_layers
        ws, bs = leaves[0:-2:2], leaves[1:-2:2]
        self.w0 = ws[0].detach().t().contiguous()
        self.b0 = bs[0].detach().contiguous()
        if n_hidden:
            self.wh = torch.stack([w.detach().t() for w in ws[1:]]).contiguous()
            self.bh = torch.stack([b.detach() for b in bs[1:]]).contiguous()
        else:
            self.wh = self.bh = torch.zeros(1, device=device)
        self.wo = leaves[-2].detach().reshape(WIDTH).contiguous()
        self.bo = leaves[-1].detach().reshape(1).contiguous()
        basis = cfg.pos_enc_basis if cfg.pos_enc != "none" else 0
        if table is None:
            table = torch.ones(max(basis, 1), device=device)
        self.table = table.detach().to(torch.float32).contiguous()
        self.n_lat = cfg.num_time_dim if cfg.use_time_latents else 0
        self.cfg = cfg
        self.args = FieldArgs(
            self.w0.data_ptr(), self.b0.data_ptr(), self.wh.data_ptr(), self.bh.data_ptr(),
            self.wo.data_ptr(), self.bo.data_ptr(), self.table.data_ptr(),
            basis, cfg.encoded_features, self.n_lat, n_hidden,
        )

    def grad_layout(self, n_phases: int) -> dict:
        """Offsets of this field's block in the gradient vector (mirrors
        ``grad_layout`` in the source)."""
        k0, nh = self.cfg.encoded_features + self.n_lat, self.cfg.num_early_layers
        sizes = [("w0", k0 * WIDTH), ("b0", WIDTH), ("wh", nh * WIDTH * WIDTH),
                 ("bh", nh * WIDTH), ("wo", WIDTH), ("bo", 1),
                 ("lat", n_phases * self.n_lat)]
        out, off = {}, 0
        for name, size in sizes:
            out[name] = (off, size)
            off += 4 if name == "bo" else size  # bo padded to keep 16-byte alignment
        out["size"] = -(-off // 4) * 4
        return out

    def leaf_grads(self, flat: torch.Tensor, n_phases: int) -> tuple[list, Optional[torch.Tensor]]:
        lay = self.grad_layout(n_phases)
        k0, nh = self.cfg.encoded_features + self.n_lat, self.cfg.num_early_layers

        def seg(name):
            off, size = lay[name]
            return flat[off:off + size]

        grads = [seg("w0").view(k0, WIDTH).t(), seg("b0")]
        dwh = seg("wh").view(nh, WIDTH, WIDTH)
        dbh = seg("bh").view(nh, WIDTH)
        for l in range(nh):
            grads += [dwh[l].t(), dbh[l]]
        grads += [seg("wo").view(1, WIDTH), seg("bo")]
        lat = seg("lat").view(n_phases, self.n_lat) if self.n_lat else None
        return grads, lat


def _ray_args(origins, directions, z, phases, latents) -> RayArgs:
    r = origins.shape[0]
    s = z.shape[-1]
    return RayArgs(origins.data_ptr(), directions.data_ptr(), z.data_ptr(), phases.data_ptr(),
                   latents.data_ptr(), r, s, s if z.dim() == 2 else 0, latents.shape[0])


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _field_ptr(pack: Optional[_Pack]):
    """A pack's FieldArgs for the C entries; None (NULL) for no field."""
    return None if pack is None else ctypes.byref(pack.args)


def _planes_buffer(pack_s: _Pack, pack_t: Optional[_Pack], device) -> torch.Tensor:
    return torch.empty(_lib().fused_field_fwd_planes_floats(ctypes.byref(pack_s.args),
                                                           _field_ptr(pack_t)), device=device)


def fused_field_fwd(pack_s: _Pack, pack_t: Optional[_Pack], origins, directions, z, phases,
                    latents):
    """Launch K1 (its bf16 instantiation when ``pack_s.bf16``): the
    ``[R*S]`` raw densities of the static field and of the temporal field
    (None when ``pack_t`` is None: the one-field launch). In f32 the launch
    first splits the weights into their planes (:func:`wgmma_planes`) in
    a scratch buffer."""
    n = origins.shape[0] * z.shape[-1]
    out_s = torch.empty(n, device=origins.device)
    out_t = None if pack_t is None else torch.empty(n, device=origins.device)
    rays = _ray_args(origins, directions, z, phases, latents)
    mode = MODE_BF16 if pack_s.bf16 else MODE_F32
    planes = None if mode == MODE_BF16 else _planes_buffer(pack_s, pack_t, origins.device)
    name = "fused_field_fwd" if pack_t is not None else "fused_static_field_fwd"
    LAUNCHES[name + _SUFFIX[mode]] += 1
    LAUNCHES["fused_field_fwd." + ("mma_sync" if mode == MODE_BF16 else "wgmma")] += 1
    _check(_lib().fused_field_fwd(ctypes.byref(pack_s.args), _field_ptr(pack_t),
                                  ctypes.byref(rays), out_s.data_ptr(),
                                  None if out_t is None else out_t.data_ptr(), mode,
                                  None if planes is None else planes.data_ptr(), _stream()),
           "fused_field_fwd")
    return out_s, out_t


def fused_field_fwd_planes(pack_s: _Pack, pack_t: Optional[_Pack]) -> torch.Tensor:
    """The weight planes that K1 in f32 computes for itself at each launch
    (``fwd_kernel_wsplit`` alone), for a comparison with
    :func:`wgmma_planes`."""
    planes = _planes_buffer(pack_s, pack_t, pack_s.w0.device)
    _check(_lib().fused_field_fwd_split(ctypes.byref(pack_s.args), _field_ptr(pack_t),
                                        planes.data_ptr(), _stream()), "fused_field_fwd_split")
    return planes


def fwd_clusters() -> int:
    """Clusters of two CTAs in K1's persistent grid in f32 on this card."""
    n = _lib().fused_field_fwd_clusters()
    _check(0 if n > 0 else -n, "fused_field_fwd_clusters")
    return n


def fused_field_bwd(pack_s: _Pack, pack_t: Optional[_Pack], origins, directions, z, phases,
                    latents, g_s, g_t, res_bf16: bool = False) -> torch.Tensor:
    """Launch K2 (+ its fixed-order reduction): the flat gradient vector,
    static block then temporal block (the static block alone, and ``g_t``
    unused, when ``pack_t`` is None). The bf16 instantiation when
    ``pack_s.bf16``; otherwise with ``res_bf16`` (two fields) the f32 one
    over bf16 residual storage."""
    mode = MODE_BF16 if pack_s.bf16 else MODE_RES_BF16 if res_bf16 else MODE_F32
    if mode == MODE_RES_BF16 and pack_t is None:
        raise ValueError("bf16 residual storage is a two-field launch (K3's)")
    dev = origins.device
    n_phases = latents.shape[0]
    lib = _lib()
    packs = [pack_s] if pack_t is None else [pack_s, pack_t]
    size = sum(p.grad_layout(n_phases)["size"] for p in packs)
    if lib.fused_field_grad_size(ctypes.byref(pack_s.args), _field_ptr(pack_t),
                                 n_phases) != size:
        raise RuntimeError("gradient layout differs between the wrapper and the kernel")
    n_tiles = -(-origins.shape[0] * z.shape[-1] // BWD_TILE_POINTS)
    # two fields take an even count (even CTAs the static field, odd ones
    # the temporal); one field any
    nf = len(packs)
    n_ctas = max(nf, min(BWD_CTAS, nf * n_tiles))
    n_hidden = max(p.cfg.num_early_layers for p in packs)
    # residuals of one tile: the encoded input, then the input of each hidden
    # layer but the last (which stays in shared memory), as bf16 pairs over
    # bf16 residual storage
    per_hidden = WIDTH // 2 if mode == MODE_RES_BF16 else WIDTH
    scratch_stride = BWD_TILE_POINTS * (ROW_STRIDE + max(n_hidden - 1, 0) * per_hidden)
    partials = torch.empty(n_ctas * size, device=dev)
    scratch = torch.empty(n_ctas * scratch_stride, device=dev)
    grads = torch.empty(size, device=dev)
    rays = _ray_args(origins, directions, z, phases, latents)
    LAUNCHES[("fused_field_bwd" if pack_t is not None else "fused_static_field_bwd")
             + _SUFFIX[mode]] += 1
    _check(lib.fused_field_bwd(ctypes.byref(pack_s.args), _field_ptr(pack_t),
                               ctypes.byref(rays), g_s.data_ptr(),
                               None if g_t is None else g_t.data_ptr(), n_ctas,
                               partials.data_ptr(), size, scratch.data_ptr(), scratch_stride,
                               grads.data_ptr(), mode, _stream()), "fused_field_bwd")
    return grads


class FusedCompositeFields(torch.autograd.Function):
    """K1 forward, K2 backward. Gradients flow to every weight and bias of
    both fields and to the latent table; the ray geometry and the encoding
    tables (windows, fourier projections) are constant. With ``cfg_t`` None
    the leaves are the static field's alone, the launch is the one-field
    one, and the temporal output is None. ``bf16``: the bf16 instantiations."""

    @staticmethod
    def _packs(cfg_s, cfg_t, leaves, tables, device, bf16):
        n_s = 2 * (cfg_s.num_early_layers + 2)
        pack_s = _Pack(cfg_s, leaves[:n_s], tables[0], device, bf16)
        pack_t = None if cfg_t is None else _Pack(cfg_t, leaves[n_s:], tables[1], device, bf16)
        return pack_s, pack_t

    @staticmethod
    def forward(ctx, cfg_s, cfg_t, bf16, origins, directions, z, phases, table_s, table_t,
                latents, *leaves):
        pack_s, pack_t = FusedCompositeFields._packs(cfg_s, cfg_t, leaves,
                                                     (table_s, table_t), origins.device, bf16)
        out_s, out_t = fused_field_fwd(pack_s, pack_t, origins, directions, z, phases,
                                       latents.detach())
        ctx.bf16 = bf16
        ctx.cfgs = (cfg_s, cfg_t)
        ctx.tables = (table_s, table_t)
        ctx.save_for_backward(origins, directions, z, phases, latents, *leaves)
        return out_s, out_t

    @staticmethod
    def backward(ctx, g_s, g_t):
        origins, directions, z, phases, latents, *leaves = ctx.saved_tensors
        pack_s, pack_t = FusedCompositeFields._packs(*ctx.cfgs, leaves, ctx.tables,
                                                     origins.device, ctx.bf16)
        flat = fused_field_bwd(pack_s, pack_t, origins, directions, z, phases,
                               latents.detach(), g_s.contiguous(),
                               None if pack_t is None else g_t.contiguous())
        n_phases = latents.shape[0]
        size_s = pack_s.grad_layout(n_phases)["size"]
        grads_s, _ = pack_s.leaf_grads(flat[:size_s], n_phases)
        grads_t, d_lat = [], None
        if pack_t is not None:
            grads_t, d_lat = pack_t.leaf_grads(flat[size_s:], n_phases)
        return (None, None, None, None, None, None, None, None, None, d_lat, *grads_s,
                *grads_t)


def _leaf_shapes(cfg: FieldConfig) -> list:
    """Expected ``_leaves`` shapes of one field (``w`` as ``[out, in]``)."""
    k0 = cfg.input_features
    shapes = [(WIDTH, k0), (WIDTH,)]
    shapes += [(WIDTH, WIDTH), (WIDTH,)] * cfg.num_early_layers
    return shapes + [(1, WIDTH), (1,)]


def _check_field(field: str, params, cfg: FieldConfig, window, dev) -> None:
    """One field's config, parameters and window against the kernels'
    envelope and layout (weights are repacked by _Pack, windows cast)."""
    if not kernel_supported(cfg):
        raise NotImplementedError(f"field config outside the CUDA kernel envelope: {cfg}")
    leaves = _leaves(params)
    shapes = [tuple(t.shape) for t in leaves]
    if shapes != _leaf_shapes(cfg):
        raise ValueError(f"{field} field parameters {shapes}, expected {_leaf_shapes(cfg)}")
    for t in leaves:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{field} field parameters: expected float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    basis = cfg.pos_enc_basis if cfg.pos_enc != "none" else 0
    if cfg.pos_enc == "fourier":
        coef = params.get("fourier")
        if (coef is None or coef.device != dev or coef.dtype != torch.float32
                or coef.numel() != 3 * basis):
            raise ValueError(f"{field} fourier projection: expected {3 * basis} float32 values "
                             f"on {dev}")
    elif window is not None and (window.device != dev or window.numel() != basis):
        raise ValueError(f"{field} window: expected {basis} values on {dev}, "
                         f"got {window.numel()} on {window.device}")


def _check_inputs(params_s, params_t, origins, directions, z, cfg_s, cfg_t, windows):
    if not cfg_t.use_time_latents:
        raise ValueError("the temporal field needs time latents")
    dev = origins.device
    for name, t in (("origins", origins), ("directions", directions), ("z", z),
                    ("latents", params_t["latents"])):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {dev}, "
                             f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    for field, params, cfg, window in (("static", params_s, cfg_s, windows[0]),
                                       ("temp", params_t, cfg_t, windows[1])):
        _check_field(field, params, cfg, window, dev)
    r = origins.shape[0]
    if origins.shape != (r, 3) or directions.shape != (r, 3):
        raise ValueError("origins and directions must both be [R, 3]")
    if not (z.dim() == 1 or (z.dim() == 2 and z.shape[0] == r)):
        raise ValueError("z must be the shared [S] depths or per-ray [R, S]")
    lat = params_t["latents"]
    if lat.shape[0] > MAX_PHASES or lat.shape[1] != cfg_t.num_time_dim:
        raise ValueError(f"latent table {tuple(lat.shape)} outside [<= {MAX_PHASES}, D]")
    if r * z.shape[-1] >= 2**31:
        raise ValueError("too many points for one launch")


def fused_composite_fields_rays(params_s, params_t, origins, directions, z, ray_phases,
                                cfg_s: FieldConfig, cfg_t: FieldConfig, window_s, window_t,
                                compute_dtype="float32"):
    """Ray-form entry: ``origins/directions [R, 3]``, depths ``z`` as the
    shared ``[S]`` or per-ray ``[R, S]``, integer ``ray_phases [R]`` -> two
    ``[R, S, 1]`` raw-density tensors, differentiable w.r.t. both parameter
    dicts; ``compute_dtype`` ``"bfloat16"`` for bf16 products. CPU tensors
    take the twin (:func:`twin_composite_fields_rays`); CUDA tensors the
    kernels."""
    if origins.device.type == "cpu":
        return twin_composite_fields_rays(params_s, params_t, origins, directions, z,
                                          ray_phases, cfg_s, cfg_t, window_s, window_t,
                                          compute_dtype)
    if origins.device.type != "cuda":
        raise ValueError(f"no field kernel for device {origins.device}")
    _check_inputs(params_s, params_t, origins, directions, z, cfg_s, cfg_t, (window_s, window_t))
    phases = ray_phases.to(device=origins.device, dtype=torch.int32).contiguous()
    r, s = origins.shape[0], z.shape[-1]
    out_s, out_t = FusedCompositeFields.apply(
        cfg_s, cfg_t, is_bf16(compute_dtype), origins, directions, z, phases,
        enc_table(params_s, cfg_s, window_s), enc_table(params_t, cfg_t, window_t),
        params_t["latents"], *_leaves(params_s), *_leaves(params_t),
    )
    return out_s.view(r, s, 1), out_t.view(r, s, 1)


def _point_rays(points):
    """Points ``[R, S, 3]`` as ``R*S`` rays of one sample: origins the
    points (constant: no gradient flows to them, as in the JAX entry),
    directions 0 and the shared depth 0, so the kernels' ``o + z*d`` is
    each point bit for bit."""
    origins = points.detach().reshape(-1, 3).contiguous()
    return origins, torch.zeros_like(origins), torch.zeros(1, device=points.device)


def _check_points(points) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [R, S, 3], got {tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"points: expected float32, got {points.dtype}")
    if points.shape[0] * points.shape[1] >= 2**31:
        raise ValueError("too many points for one launch")


def fused_composite_fields(params_s, params_t, points, point_phases, cfg_s: FieldConfig,
                           cfg_t: FieldConfig, window_s, window_t, compute_dtype="float32"):
    """Point-form entry: ``points [R, S, 3]`` and integer ``point_phases
    [R, S]`` -> two ``[R, S, 1]`` raw-density tensors, differentiable
    w.r.t. both parameter dicts (not the points). CPU tensors take
    :func:`twin_composite_fields`; CUDA tensors the kernels, over the
    points as ``R*S`` rays of one sample. Prefer the ray form where the
    points lie on rays: it never materializes them."""
    if points.device.type == "cpu":
        return twin_composite_fields(params_s, params_t, points, point_phases, cfg_s, cfg_t,
                                     window_s, window_t, compute_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no field kernel for device {points.device}")
    _check_points(points)
    r, s, _ = points.shape
    if tuple(point_phases.shape) != (r, s):
        raise ValueError(f"point_phases must be [R, S] = {(r, s)}, got "
                         f"{tuple(point_phases.shape)}")
    origins, directions, z = _point_rays(points)
    _check_inputs(params_s, params_t, origins, directions, z, cfg_s, cfg_t, (window_s, window_t))
    phases = point_phases.to(device=points.device, dtype=torch.int32).reshape(-1).contiguous()
    out_s, out_t = FusedCompositeFields.apply(
        cfg_s, cfg_t, is_bf16(compute_dtype), origins, directions, z, phases,
        enc_table(params_s, cfg_s, window_s), enc_table(params_t, cfg_t, window_t),
        params_t["latents"], *_leaves(params_s), *_leaves(params_t),
    )
    return out_s.view(r, s, 1), out_t.view(r, s, 1)


def fused_static_field(params, points, cfg: FieldConfig, window, compute_dtype="float32"):
    """The static method's field: ``points [R, S, 3] -> [R, S, 1]``,
    differentiable w.r.t. ``params``. CPU tensors take
    :func:`twin_static_field`; CUDA tensors the one-field K1/K2 over the
    points as ``R*S`` rays of one sample (the point form with no temporal
    field, where the JAX entry runs a zero dummy one)."""
    if points.device.type == "cpu":
        return twin_static_field(params, points, cfg, window, compute_dtype)
    if points.device.type != "cuda":
        raise ValueError(f"no field kernel for device {points.device}")
    _check_points(points)
    r, s, _ = points.shape
    origins, directions, z = _point_rays(points)
    dev = points.device
    _check_field("static", params, cfg, window, dev)
    # the encoding reads a phase per ray even for a field without latents:
    # every point takes phase 0 of a one-row table that is never read
    phases = torch.zeros(r * s, dtype=torch.int32, device=dev)
    latents = torch.zeros(1, MAX_LAT, device=dev)
    out_s, _ = FusedCompositeFields.apply(cfg, None, is_bf16(compute_dtype), origins,
                                          directions, z, phases,
                                          enc_table(params, cfg, window), None, latents,
                                          *_leaves(params))
    return out_s.view(r, s, 1)
