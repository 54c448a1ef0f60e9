"""The fused-loss train step: CUDA kernel K3 ``fused_train_loss`` with its
plain PyTorch version.

K3 replaces ``nerfca_tpu/ops/pallas/fused_train.py::_train_kernel``
(``pallas_call`` in ``fused_train_loss_and_grads``): the whole coarse
composite step, from the encoded points through both MLPs, the motion-hull
gate, the Beer-Lambert render and the full loss battery to every parameter
gradient. On the card it runs in three launches:

1. K1 (``fused_field_fwd``): the forward of both fields over the batch's
   ``R * S`` points, 3xTF32 on the tensor cores, into two ``[R * S]`` raw
   densities;
2. ``fused_train_loss`` (``csrc/fused_train.cu``): one CTA per ray reads
   the ray's raw densities into shared memory, forms the per-ray sums in a
   fixed order in exact f32, writes the ray's 13 term partials and the
   hand-derived cotangents ``dL/draw_s``, ``dL/draw_t``; a one-block
   reduction sums the partials over rays in order and forms the loss;
3. K2 (``fused_field_bwd``) backpropagates those cotangents into every
   weight gradient and the latent-table gradient.

``hp.compute_dtype == "bfloat16"`` launches K1 and K2's bf16
instantiations (bf16 products, f32 gradients, the JAX kernel's cast
points); ``hp.pallas_bf16_residuals`` (``fused_train.py:562``) launches
K2 over bf16 residual storage: the stored post-ReLU activations are
rounded to bf16 while the forward and the loss stay f32, so the loss and
the terms are the f32 ones bit for bit. Under bf16 compute the residual
option changes nothing (the products already round every operand), as in
JAX.

The TPU kernel differentiates its loss with an in-kernel ``jax.vjp``;
here the cotangent is derived by hand (:func:`loss_cotangents_plain`
writes the same math as tensor ops, and the CPU tests hold it against
``torch.autograd``). Clips take JAX's derivative, 0.5 on a bound.

:func:`fused_train_loss_and_grads_sharded` replaces the data-parallel
composition of the same kernel (``fused_train.py:695-781``): each rank runs
K3 on its slice of the ray batch with the global ray count, then one SUM
all-reduce over the loss, the terms and every gradient (packed into one
buffer) and one MAX all-reduce over the two sigma maxima complete them.

Dispatch: CPU tensors take :func:`plain_train_loss_and_grads`; CUDA
tensors launch the kernels or raise. ``LAUNCHES["fused_train_loss"]``
grows by one at each launch of the loss kernel and nowhere else; a step
also counts one K1 and one K2 launch in ``fused_field.LAUNCHES``.

The same library holds the eval renderer's composite,
:func:`eval_composite` (``composite_kernel``): launched once per tile of
a test view after its K1, it forms the scaled sigmas and the three
Beer-Lambert images of ``ops/render.py`` in one pass over the raw
densities (no autograd; ``train/evaluation.py`` takes it on the card).
``LAUNCHES["eval_composite.kernel"]`` counts its launches,
``["eval_composite.torch"]`` the views whose composite ran in torch. Its
one-field sibling, :func:`eval_static` (``static_composite_kernel``),
renders the static method's view after the one-field K1, the UNSCALED
sigma and the image of ``render_transmission``;
``LAUNCHES["eval_static.kernel"]`` counts its launches.
``LAUNCHES["eval_view.capture"]``, ``["eval_view.replay"]`` and
``["eval_view.eager"]`` count the eval renderer's views by how they ran
(``train/evaluation.py::ViewGraphs``); a replay adds its captured
launches to the counts above.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.distributed as dist

from nerfca_tpu_torch.models.fields import FieldConfig
from nerfca_tpu_torch.ops.cuda import build
from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops import losses
from nerfca_tpu_torch.ops.losses import clip
from nerfca_tpu_torch.ops.render import depth_deltas, output_activation, softplus
from nerfca_tpu_torch.parallel.mesh import batch_sharding

TERMS = 16
# term indices, as in the JAX kernel; T_LOSS holds the weighted total
(T_PIX, T_FAVOR, T_S_ENT, T_S_SIG, T_D_ENT, T_D_SIG, T_OCCL, T_L1, T_L2,
 T_BLENDW, T_SMAX, T_DMAX, T_HL1, T_LOSS) = range(14)
TERM_NAMES = ("pixel_loss", "favor_s", "s_entropy", "s_entropy_sum", "d_entropy",
              "d_entropy_sum", "occl", "l1", "l2", "blendw", "sigma_s_max", "sigma_d_max",
              "hull_s_l1")
# terms that are maxima over the batch (MAX across shards); every other
# term is a partial of a global mean or sum (SUM)
MAX_TERMS = (T_SMAX, T_DMAX)
ACTIVATIONS = ("softplus", "sigmoid", "clamp")
MAX_SAMPLES = 1024  # the loss kernel keeps a ray's raw densities in shared memory

LAUNCHES = {"fused_train_loss": 0, "eval_composite.kernel": 0, "eval_composite.torch": 0,
            "eval_static.kernel": 0, "eval_view.capture": 0, "eval_view.replay": 0,
            "eval_view.eager": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fused_train_supported(cfg_s: FieldConfig, cfg_t: FieldConfig, hp) -> bool:
    """Envelope of the fused-loss step (``fused_train.py:62-88``): the
    coarse pass only, no static TV, both fields inside the field kernels'
    envelope, a kernel-side activation, and a ray that fits in shared
    memory."""
    return (
        hp.use_pallas
        and hp.use_fused_loss
        and hp.depth_samples_fine == 0
        and hp.static_tv_weight_start == 0.0
        and hp.static_tv_weight_end == 0.0
        and ff.kernel_supported(cfg_s)
        and ff.kernel_supported(cfg_t)
        and hp.output_activation.lower() in ACTIVATIONS
        and hp.depth_samples_coarse <= MAX_SAMPLES
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the reference on the card)


def _clip_grad(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """Derivative of ``jnp.clip(x, lo, hi)``: 1 inside, 0.5 on a bound, 0
    outside."""
    one = torch.ones_like(x)
    g = one
    if lo is not None:
        lo_t = x.new_full((), lo)
        g = torch.where(x > lo_t, one, torch.where(x == lo_t, 0.5 * one, 0.0 * one))
        x = torch.maximum(x, lo_t)
    if hi is not None:
        hi_t = x.new_full((), hi)
        g = g * torch.where(x < hi_t, one, torch.where(x == hi_t, 0.5 * one, 0.0 * one))
    return g


def _activation_grad(raw: torch.Tensor, kind: str) -> torch.Tensor:
    """Derivative of ``render.output_activation(raw, kind)``."""
    kind = kind.lower()
    if kind == "sigmoid":
        a = torch.sigmoid(raw)
        return a * (1 - a)
    grad = torch.sigmoid(raw)  # softplus'
    if kind == "clamp":
        grad = grad * _clip_grad(softplus(raw), 0.0, 1.0)
    return grad


def occlusion_mask(z: torch.Tensor, hp) -> torch.Tensor:
    """``[S]`` float occlusion mask of the shared depths ``z``."""
    return losses.occlusion_mask(depth_deltas(z), hp.occl_reg_perc,
                                 front_only=hp.occl_front_only).to(z.dtype)


def _weights5(loss_weights_vec) -> list:
    """``[favor, dentro, occl, l1]`` or with the hull L1 appended -> five
    floats (an absent hull weight is 0, so its term drops out exactly)."""
    lw = [float(v) for v in torch.as_tensor(loss_weights_vec, dtype=torch.float32).tolist()]
    return (lw + [0.0] * 5)[:5]


def loss_cotangents_plain(raw_s, raw_t, z, pixels, weights, initial_intensities,
                          loss_weights_vec, hp, gate=None, total_rays: Optional[int] = None):
    """The kernel's loss phase as tensor ops. ``raw_s``, ``raw_t``: ``[R, S]``
    raw densities; ``z`` the shared ``[S]`` depths; ``gate`` the optional
    ``[R, S]`` hull gate (its presence turns on the hull-gated static L1).

    Returns ``(terms [16], dL/draw_s [R, S], dL/draw_t [R, S])`` with the
    weighted loss in ``terms[T_LOSS]``. Normalizations use ``total_rays``
    (default R): pixel, entropies, sigma sums, occlusion and hull L1 are
    means over rays, favor and blendw means over ``R * S`` samples, l1/l2
    plain sums.
    """
    n_s = z.shape[0]
    n_r = total_rays if total_rays is not None else raw_s.shape[0]
    lw = _weights5(loss_weights_vec)  # f32 values as Python floats: no host-device copy
    dist = depth_deltas(z)
    occl = occlusion_mask(z, hp)

    sig_s = output_activation(raw_s, hp.output_activation) * 1e-2
    sig_t = output_activation(raw_t, hp.output_activation) * 1e-2
    if gate is not None:
        sig_t = sig_t * gate
    sd_s, sd_t = sig_s * dist, sig_t * dist
    sum_s, sum_t = sd_s.sum(-1), sd_t.sum(-1)

    err = initial_intensities - (sum_s + sum_t) - pixels
    den = sig_s + sig_t + 1e-10
    bw = sig_t / den
    k = float(hp.skewness_val)
    u = bw ** k
    b = clip(u, 1e-19, 1 - 1e-19)
    rev = clip(1 - b, lo=1e-19)
    log_b, log_rev = torch.log(b), torch.log(rev)
    ent_b = -(b * log_b + rev * log_rev)

    d_s = clip(sum_s, lo=hp.entro_clip_threshold)
    d_t = clip(sum_t, lo=hp.entro_clip_threshold)
    p_s, p_t = sd_s / d_s[:, None], sd_t / d_t[:, None]
    plog_s, plog_t = torch.log(p_s + 1e-10), torch.log(p_t + 1e-10)
    m_s = (sum_s >= hp.entro_mask_thre).float()
    m_t = sum_t >= hp.entro_mask_thre
    if hp.entro_use_weighting:
        m_t = m_t | (weights > 1.0 + hp.entro_weighted_thresh)
    m_t = m_t.float()

    terms = torch.zeros(TERMS, device=raw_s.device)
    terms[T_PIX] = (weights * err ** 2).sum() / n_r
    terms[T_FAVOR] = ent_b.sum() / (n_r * n_s)
    terms[T_S_ENT] = (m_s * -(p_s * plog_s).sum(-1)).sum() / n_r
    terms[T_S_SIG] = sum_s.sum() / n_r
    terms[T_D_ENT] = (m_t * -(p_t * plog_t).sum(-1)).sum() / n_r
    terms[T_D_SIG] = sum_t.sum() / n_r
    terms[T_OCCL] = (sd_t * occl).sum() / n_r
    terms[T_L1] = sd_s.sum()
    terms[T_L2] = (sd_s ** 2).sum()
    terms[T_BLENDW] = bw.sum() / (n_r * n_s)
    terms[T_SMAX] = sig_s.max()
    terms[T_DMAX] = sig_t.max()
    if gate is not None:
        terms[T_HL1] = (sd_s * gate).sum() / n_r
    terms[T_LOSS] = (terms[T_PIX] + lw[0] * terms[T_FAVOR] + lw[1] * terms[T_D_ENT]
                     + lw[2] * terms[T_OCCL] + lw[3] * terms[T_L2] + lw[3] * terms[T_L1]
                     + lw[4] * terms[T_HL1])

    # d/d(sigma * dist): pixel term, dynamic entropy, occlusion, L1/L2, hull L1
    g_pix = (-2.0 / n_r) * weights * err
    q_t = -(plog_t + p_t / (p_t + 1e-10))
    qp = (q_t * p_t).sum(-1)
    # the denominator's derivative: clip's (0.5 on the bound), and 0 on
    # near-empty rays, whose denominator carries no gradient (the
    # double-where guard of ray_entropy_loss)
    d_prime = _clip_grad(sum_t, lo=hp.entro_clip_threshold) * (sum_t >= 1e-15).float()
    c_t = lw[1] * m_t / n_r
    g_sd_t = (g_pix[:, None] + c_t[:, None] * (q_t - (d_prime * qp)[:, None]) / d_t[:, None]
              + lw[2] * occl / n_r)
    g_sd_s = g_pix[:, None] + lw[3] * (1 + 2 * sd_s)
    if gate is not None:
        g_sd_s = g_sd_s + lw[4] * gate / n_r
    # favor: binary entropy of clip(bw ** k) through bw = sig_t / den
    db = _clip_grad(u, 1e-19, 1 - 1e-19)
    drev = -_clip_grad(1 - b, lo=1e-19)
    du = k * bw ** (k - 1) if k != 0 else torch.zeros_like(bw)
    g_bw = (lw[0] / (n_r * n_s)) * (-(log_b + 1) - (log_rev + 1) * drev) * db * du
    g_sig_s = g_sd_s * dist - g_bw * sig_t / (den * den)
    g_sig_t = g_sd_t * dist + g_bw / den - g_bw * sig_t / (den * den)
    if gate is not None:
        g_sig_t = g_sig_t * gate
    return (terms, g_sig_s * 1e-2 * _activation_grad(raw_s, hp.output_activation),
            g_sig_t * 1e-2 * _activation_grad(raw_t, hp.output_activation))


def _param_trees(params_s, params_t):
    """Detached copies of both parameter trees whose leaves require grad
    (a fourier projection is carried along without), and the leaves in
    ``_leaves`` order (latents last)."""
    def tree(p):
        out = {"early": [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
                         for layer in p["early"]],
               "out": {k: v.detach().requires_grad_(True) for k, v in p["out"].items()}}
        if "latents" in p:
            out["latents"] = p["latents"].detach().requires_grad_(True)
        if "fourier" in p:
            out["fourier"] = p["fourier"].detach()
        return out
    ts, tt = tree(params_s), tree(params_t)
    return ts, tt, ff._leaves(ts) + ff._leaves(tt) + [tt["latents"]]


def _grad_tree(leaf_grads: list, params, latents=None) -> dict:
    """``_leaves``-ordered gradients -> the layout of the tree ``params``
    (a zero gradient for a fourier projection, as JAX gives it)."""
    n = len(params["early"])
    early = [{"w": leaf_grads[2 * i], "b": leaf_grads[2 * i + 1]} for i in range(n)]
    out = {"early": early, "out": {"w": leaf_grads[-2], "b": leaf_grads[-1]}}
    if latents is not None:
        out["latents"] = latents
    if "fourier" in params:
        out["fourier"] = torch.zeros_like(params["fourier"])
    return out


def _term_dict(terms: torch.Tensor) -> dict:
    return {name: terms[i] for i, name in enumerate(TERM_NAMES)}


def plain_train_loss_and_grads(*args, **kwargs):
    """:func:`fused_train_loss_and_grads`'s plain version (the same
    arguments and results): both fields in torch, the hand-derived loss
    cotangents of :func:`loss_cotangents_plain`, then
    ``torch.autograd.grad`` of the fields driven by those cotangents."""
    terms, flat, unpack = _plain_terms_grads(*args, **kwargs)
    return _results(terms, *unpack(flat))


def _results(terms, grads_s, grads_t) -> tuple:
    return terms[T_LOSS], _term_dict(terms), grads_s, grads_t


def _precision(hp) -> tuple:
    """``(bf16 products, bf16 residual storage)`` of a step; the residual
    option is moot under bf16 products."""
    bf16 = ff.is_bf16(hp.compute_dtype)
    return bf16, hp.pallas_bf16_residuals and not bf16


def _plain_terms_grads(params_s, params_t, origins, directions, z, ray_phases, pixels, weights,
                       initial_intensities, cfg_s: FieldConfig, cfg_t: FieldConfig, window_s,
                       window_t, loss_weights_vec, hp, total_rays: Optional[int] = None,
                       hull=None):
    """The plain version's ``(terms [16], flat grads, unpack)``: the
    gradients in ``_leaves`` order (the latent table last) concatenated,
    and ``unpack(flat) -> (grads_s, grads_t)``. The fields are the kernels'
    twin (``fused_field.twin_composite_fields_rays``) under the step's
    compute dtype and residual storage."""
    ts, tt, leaves = _param_trees(params_s, params_t)
    raw_s, raw_t = ff.twin_composite_fields_rays(ts, tt, origins, directions, z, ray_phases,
                                                 cfg_s, cfg_t, window_s, window_t,
                                                 hp.compute_dtype, _precision(hp)[1])
    raw_s, raw_t = raw_s[..., 0], raw_t[..., 0]
    gate = hull_gate_rays(hull, origins, directions, z) if hull is not None else None
    terms, g_s, g_t = loss_cotangents_plain(
        raw_s.detach(), raw_t.detach(), z, pixels, weights, initial_intensities,
        loss_weights_vec, hp, gate=gate, total_rays=total_rays)
    grads = torch.autograd.grad((raw_s, raw_t), leaves, grad_outputs=(g_s, g_t))
    shapes = [g.shape for g in grads]
    n_s = 2 * (cfg_s.num_early_layers + 2)

    def unpack(flat):
        g = [x.view(shape) for x, shape in
             zip(torch.split(flat, [shape.numel() for shape in shapes]), shapes)]
        return _grad_tree(g[:n_s], params_s), _grad_tree(g[n_s:-1], params_t, g[-1])

    return terms, torch.cat([g.reshape(-1) for g in grads]), unpack


# ---------------------------------------------------------------------------
# Build, bind and launch


class LossArgs(ctypes.Structure):
    _fields_ = [("pixels", ctypes.c_void_p), ("weights", ctypes.c_void_p),
                ("i0", ctypes.c_void_p), ("gate", ctypes.c_void_p), ("occl", ctypes.c_void_p),
                ("lw", ctypes.c_float * 5), ("skew", ctypes.c_float),
                ("mask_thre", ctypes.c_float), ("var_thre", ctypes.c_float),
                ("clip_thr", ctypes.c_float), ("n_rays_total", ctypes.c_float),
                ("n_samples_total", ctypes.c_float), ("activation", ctypes.c_int),
                ("use_weighting", ctypes.c_int), ("has_hull", ctypes.c_int)]


class CompositeArgs(ctypes.Structure):
    _fields_ = [("raw_s", ctypes.c_void_p), ("raw_t", ctypes.c_void_p),
                ("gate", ctypes.c_void_p), ("z", ctypes.c_void_p), ("sig_s", ctypes.c_void_p),
                ("sig_t", ctypes.c_void_p), ("dists", ctypes.c_void_p),
                ("pix", ctypes.c_void_p), ("pix_s", ctypes.c_void_p),
                ("pix_t", ctypes.c_void_p), ("i0", ctypes.c_float), ("n_rays", ctypes.c_int),
                ("n_samples", ctypes.c_int), ("z_stride", ctypes.c_int),
                ("activation", ctypes.c_int)]


class StaticCompositeArgs(ctypes.Structure):
    _fields_ = [("raw", ctypes.c_void_p), ("z", ctypes.c_void_p), ("sigma", ctypes.c_void_p),
                ("dists", ctypes.c_void_p), ("pix", ctypes.c_void_p), ("i0", ctypes.c_float),
                ("n_rays", ctypes.c_int), ("n_samples", ctypes.c_int),
                ("z_stride", ctypes.c_int), ("activation", ctypes.c_int)]


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load("fused_train")
        ptr = ctypes.POINTER
        lib.fused_train_loss.argtypes = [ptr(LossArgs), ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ctypes.c_void_p]
        lib.fused_train_loss.restype = ctypes.c_int
        lib.fused_train_terms.argtypes = [ctypes.c_int]
        lib.fused_train_terms.restype = ctypes.c_int
        if lib.fused_train_terms(0) != TERMS:
            raise RuntimeError("term layout differs between the wrapper and the kernel")
        lib.eval_composite.argtypes = [ptr(CompositeArgs), ctypes.c_void_p]
        lib.eval_composite.restype = ctypes.c_int
        lib.eval_composite_args_bytes.argtypes = [ctypes.c_int]
        lib.eval_composite_args_bytes.restype = ctypes.c_int
        if lib.eval_composite_args_bytes(0) != ctypes.sizeof(CompositeArgs):
            raise RuntimeError("CompositeArgs differs between the wrapper and the kernel")
        lib.eval_static.argtypes = [ptr(StaticCompositeArgs), ctypes.c_void_p]
        lib.eval_static.restype = ctypes.c_int
        lib.eval_static_args_bytes.argtypes = [ctypes.c_int]
        lib.eval_static_args_bytes.restype = ctypes.c_int
        if lib.eval_static_args_bytes(0) != ctypes.sizeof(StaticCompositeArgs):
            raise RuntimeError("StaticCompositeArgs differs between the wrapper and the kernel")
        _LIB = lib
    return _LIB


def loss_args(pixels, weights, initial_intensities, gate, occl, loss_weights_vec, hp,
              n_rays_total: int, n_samples: int) -> LossArgs:
    """The kernel's loss arguments; the tensors must stay alive while the
    launch uses their pointers."""
    return LossArgs(
        pixels.data_ptr(), weights.data_ptr(), initial_intensities.data_ptr(),
        gate.data_ptr() if gate is not None else None, occl.data_ptr(),
        (ctypes.c_float * 5)(*_weights5(loss_weights_vec)), float(hp.skewness_val),
        float(hp.entro_mask_thre), float(1.0 + hp.entro_weighted_thresh),
        float(hp.entro_clip_threshold), float(n_rays_total), float(n_rays_total * n_samples),
        ACTIVATIONS.index(hp.output_activation.lower()), int(bool(hp.entro_use_weighting)),
        int(gate is not None))


def fused_train_loss(raw_s, raw_t, z, largs: LossArgs):
    """Launch K3's loss kernel and its term reduction on K1's ``[R*S]`` raw
    densities and the shared ``[S]`` depths: ``(terms [16], dL/draw_s
    [R*S], dL/draw_t [R*S])``."""
    dev, n, s = raw_s.device, raw_s.numel(), z.shape[0]
    g_s = torch.empty(n, device=dev)
    g_t = torch.empty(n, device=dev)
    partials = torch.empty(n // s * TERMS, device=dev)
    terms = torch.empty(TERMS, device=dev)
    LAUNCHES["fused_train_loss"] += 1
    ff._check(_lib().fused_train_loss(
        ctypes.byref(largs), z.data_ptr(), n // s, s, raw_s.data_ptr(), raw_t.data_ptr(),
        g_s.data_ptr(), g_t.data_ptr(), partials.data_ptr(), terms.data_ptr(), ff._stream()),
        "fused_train_loss")
    return terms, g_s, g_t


def eval_composite_buffers(n_rays: int, z, images: bool = True) -> dict:
    """The outputs of a view's :func:`eval_composite` launches, allocated
    once for the view: ``pix [N]``, the scaled ``static_sigma`` and
    ``temp_sigma [N, S]``, ``dists`` shaped like the depths ``z`` (the
    shared ``[S]`` or per-ray ``[N, S]``), and with ``images`` the static
    and dynamic images ``pix_static``, ``pix_temp [N]``."""
    dev, s = z.device, z.shape[-1]
    if z.dim() == 2 and z.shape[0] != n_rays:
        raise ValueError(f"per-ray depths for {z.shape[0]} rays, not {n_rays}")
    out = {"pix": torch.empty(n_rays, device=dev)}
    if images:
        out.update(pix_static=torch.empty(n_rays, device=dev),
                   pix_temp=torch.empty(n_rays, device=dev))
    out.update(static_sigma=torch.empty(n_rays, s, device=dev),
               temp_sigma=torch.empty(n_rays, s, device=dev), dists=torch.empty_like(z))
    return out


def eval_composite(raw_s, raw_t, z, initial_intensity: float, activation: str, out: dict,
                   start: int, gate=None) -> None:
    """Launch the eval renderer's composite (``composite_kernel``) on one
    tile of a view: ``raw_s``, ``raw_t`` are K1's ``[r, S]`` raw densities
    of rays ``[start, start + r)``, ``gate`` their optional ``[r, S]``
    motion-hull gate, ``z`` the view's depths (the shared ``[S]`` or
    per-ray ``[N, S]``). Writes those rays' rows of the buffers ``out``
    (:func:`eval_composite_buffers`): what ``render_transmission_composite``
    and, for ``pix_static``/``pix_temp``, ``render_transmission`` return,
    the sigmas and dists bit for bit, each image's per-ray sum in another
    order of additions."""
    s = z.shape[-1]
    r = _check_tile({"raw_s": raw_s, "raw_t": raw_t, "gate": gate}, z, out, start, "pix")
    rows = slice(start, start + r)
    per_ray = z.dim() == 2

    def ptr(name):
        t = out.get(name)
        return None if t is None else t[rows].data_ptr()

    args = CompositeArgs(
        raw_s.data_ptr(), raw_t.data_ptr(), None if gate is None else gate.data_ptr(),
        z[rows].data_ptr() if per_ray else z.data_ptr(), ptr("static_sigma"), ptr("temp_sigma"),
        _dists_ptr(out, z, rows), ptr("pix"), ptr("pix_static"), ptr("pix_temp"),
        float(initial_intensity), r, s, s if per_ray else 0, ACTIVATIONS.index(activation.lower()))
    LAUNCHES["eval_composite.kernel"] += 1
    ff._check(_lib().eval_composite(ctypes.byref(args), ff._stream()), "eval_composite")


def eval_static_buffers(n_rays: int, z) -> dict:
    """The outputs of a static view's :func:`eval_static` launches,
    allocated once for the view: ``pix_static [N]``, the UNSCALED
    ``static_sigma [N, S]`` and ``dists`` shaped like the depths ``z``."""
    if z.dim() == 2 and z.shape[0] != n_rays:
        raise ValueError(f"per-ray depths for {z.shape[0]} rays, not {n_rays}")
    return {"pix_static": torch.empty(n_rays, device=z.device),
            "static_sigma": torch.empty(n_rays, z.shape[-1], device=z.device),
            "dists": torch.empty_like(z)}


def eval_static(raw, z, initial_intensity: float, activation: str, out: dict,
                start: int) -> None:
    """Launch the static method's render (``static_composite_kernel``) on
    one tile of a view: ``raw`` is the one-field K1's ``[r, S]`` raw
    densities of rays ``[start, start + r)``, ``z`` the view's depths (the
    shared ``[S]`` or per-ray ``[N, S]``). Writes those rays' rows of the
    buffers ``out`` (:func:`eval_static_buffers`): what
    ``render_transmission`` returns, the sigma and dists bit for bit, the
    image's per-ray sum in another order of additions."""
    s = z.shape[-1]
    r = _check_tile({"raw": raw}, z, out, start, "pix_static")
    rows = slice(start, start + r)
    per_ray = z.dim() == 2
    args = StaticCompositeArgs(
        raw.data_ptr(), z[rows].data_ptr() if per_ray else z.data_ptr(),
        out["static_sigma"][rows].data_ptr(), _dists_ptr(out, z, rows),
        out["pix_static"][rows].data_ptr(), float(initial_intensity), r, s,
        s if per_ray else 0, ACTIVATIONS.index(activation.lower()))
    LAUNCHES["eval_static.kernel"] += 1
    ff._check(_lib().eval_static(ctypes.byref(args), ff._stream()), "eval_static")


def _check_tile(raws: dict, z, out: dict, start: int, pix: str) -> int:
    """The checks of one tile's inputs against the view's buffers, made
    before a launch hands them to the card as pointers; the tile's ray
    count. ``raws``: the ``[r, S]`` inputs by name (None: absent)."""
    s = z.shape[-1]
    r = next(iter(raws.values())).numel() // s
    for name, t in (*raws.items(), ("z", z)):
        if t is not None and (t.device != z.device or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 tensor on {z.device}")
    if any(t is not None and t.numel() != r * s for t in raws.values()):
        raise ValueError(f"{', '.join(raws)} must each hold {r} x {s} values")
    if out["dists"].shape != z.shape or start + r > out[pix].shape[0]:
        raise ValueError(f"rays [{start}, {start + r}) at depths {tuple(z.shape)} outside the "
                         f"view's buffers")
    return r


def _dists_ptr(out: dict, z, rows: slice):
    """Where a tile writes its dists: its rows of per-ray deltas; the
    shared ``[S]`` deltas once, by the view's first tile."""
    if z.dim() == 2:
        return out["dists"][rows].data_ptr()
    return out["dists"].data_ptr() if rows.start == 0 else None


def _check_batch(origins, z, pixels, weights, initial_intensities):
    dev, r = origins.device, origins.shape[0]
    if z.dim() != 1:
        raise ValueError("the fused-loss kernel takes the shared [S] depth vector")
    if not 2 <= z.shape[0] <= MAX_SAMPLES:
        raise ValueError(f"{z.shape[0]} samples per ray outside [2, {MAX_SAMPLES}]")
    for name, t in (("pixels", pixels), ("weights", weights),
                    ("initial_intensities", initial_intensities)):
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (r,)):
            raise ValueError(f"{name}: expected a contiguous float32 [{r}] tensor on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def fused_train_loss_and_grads(params_s, params_t, origins, directions, z, ray_phases, pixels,
                               weights, initial_intensities, cfg_s: FieldConfig,
                               cfg_t: FieldConfig, window_s, window_t, loss_weights_vec, hp,
                               total_rays: Optional[int] = None, hull=None):
    """Training loss and parameter gradients of the coarse composite
    objective in one pass (the JAX contract of ``fused_train.py:416-454``).

    ``z`` is the shared ``[S]`` depth vector; ``loss_weights_vec`` is
    ``[favor, dentro, occl, l1]`` or ``[..., hull_static_l1]``;
    ``total_rays`` sets the normalizations when this call computes one
    shard of a larger batch (default: the local ray count); ``hull`` an
    optional :class:`~nerfca_tpu_torch.ops.hull.MotionHull`.

    Returns ``(loss, term_dict, grads_s, grads_t)``: the unweighted terms
    by name, and gradient trees shaped like the parameter trees (the
    latent-table gradient in ``grads_t["latents"]``).
    """
    terms, flat, unpack = _terms_grads(
        params_s, params_t, origins, directions, z, ray_phases, pixels, weights,
        initial_intensities, cfg_s, cfg_t, window_s, window_t, loss_weights_vec, hp,
        total_rays=total_rays, hull=hull)
    return _results(terms, *unpack(flat))


def _terms_grads(params_s, params_t, origins, directions, z, ray_phases, pixels, weights,
                 initial_intensities, cfg_s: FieldConfig, cfg_t: FieldConfig, window_s,
                 window_t, loss_weights_vec, hp, total_rays: Optional[int] = None, hull=None):
    """:func:`fused_train_loss_and_grads` as ``(terms [16], flat grads,
    unpack)``, the weighted loss in ``terms[T_LOSS]``: on the card the
    flat gradients are K2's buffer in its kernel layout, on the CPU the
    plain version's in ``_leaves`` order; ``unpack(flat) -> (grads_s,
    grads_t)``."""
    if origins.device.type == "cpu":
        return _plain_terms_grads(
            params_s, params_t, origins, directions, z, ray_phases, pixels, weights,
            initial_intensities, cfg_s, cfg_t, window_s, window_t, loss_weights_vec, hp,
            total_rays=total_rays, hull=hull)
    if origins.device.type != "cuda":
        raise ValueError(f"no fused-loss kernel for device {origins.device}")
    if hp.output_activation.lower() not in ACTIVATIONS:
        raise NotImplementedError(f"activation {hp.output_activation!r} outside the kernel")
    ff._check_inputs(params_s, params_t, origins, directions, z, cfg_s, cfg_t,
                     (window_s, window_t))
    _check_batch(origins, z, pixels, weights, initial_intensities)
    r, s = origins.shape[0], z.shape[0]
    dev = origins.device
    phases = ray_phases.to(device=dev, dtype=torch.int32).contiguous()
    latents = params_t["latents"].detach()
    bf16, res_bf16 = _precision(hp)
    pack_s = ff._Pack(cfg_s, ff._leaves(params_s), ff.enc_table(params_s, cfg_s, window_s), dev,
                      bf16)
    pack_t = ff._Pack(cfg_t, ff._leaves(params_t), ff.enc_table(params_t, cfg_t, window_t), dev,
                      bf16)
    gate = None
    if hull is not None:
        gate = hull_gate_rays(hull, origins, directions, z).contiguous()
    occl = occlusion_mask(z, hp).contiguous()
    largs = loss_args(pixels, weights, initial_intensities, gate, occl, loss_weights_vec, hp,
                      total_rays if total_rays is not None else r, s)
    raw_s, raw_t = ff.fused_field_fwd(pack_s, pack_t, origins, directions, z, phases, latents)
    terms, g_s, g_t = fused_train_loss(raw_s, raw_t, z, largs)
    flat = ff.fused_field_bwd(pack_s, pack_t, origins, directions, z, phases, latents, g_s, g_t,
                              res_bf16=res_bf16)
    n_phases = latents.shape[0]
    size_s = pack_s.grad_layout(n_phases)["size"]

    def unpack(flat):
        leaf_s, _ = pack_s.leaf_grads(flat[:size_s], n_phases)
        leaf_t, d_lat = pack_t.leaf_grads(flat[size_s:], n_phases)
        return _grad_tree(leaf_s, params_s), _grad_tree(leaf_t, params_t, d_lat)

    return terms, flat, unpack


def fused_train_loss_and_grads_sharded(mesh, axis_name: str, params_s, params_t, origins,
                                       directions, z, ray_phases, pixels, weights,
                                       initial_intensities, cfg_s: FieldConfig,
                                       cfg_t: FieldConfig, window_s, window_t, loss_weights_vec,
                                       hp, hull=None):
    """Data-parallel composition of K3 (the contract of JAX's
    ``fused_train_loss_and_grads_sharded``, ``fused_train.py:695-781``).

    Every rank passes the same GLOBAL batch (``[R]`` rays) and the same
    parameters; ``mesh`` is a ``DeviceMesh`` and ``axis_name`` its data
    axis. Each rank runs K3 on its slice of the rays with the
    normalizations set to the global count, so it emits partials of the
    global loss, terms and gradients; one SUM all-reduce over a single
    buffer (the 16 terms, then K2's gradient buffer as it came out) and one
    MAX all-reduce over ``sigma_s_max``/``sigma_d_max`` complete them. The
    hull grid and the depths are replicated. Returns what
    :func:`fused_train_loss_and_grads` returns, equal on every rank.

    ``R`` must split evenly over the shards (``RaySharding.slice`` raises
    otherwise). JAX also asks for whole Pallas tiles of rays per shard; the
    port's K3 has no ray tile (its loss kernel takes one block per ray, K1
    and K2 tile points with a masked edge), so the even split is all it
    needs. On the CPU each rank runs the plain version, as the unsharded
    entry does."""
    r_global = origins.shape[0]
    part = batch_sharding(mesh, axis_name).slice(r_global)
    terms, flat, unpack = _terms_grads(
        params_s, params_t, origins[part], directions[part], z, ray_phases[part], pixels[part],
        weights[part], initial_intensities[part], cfg_s, cfg_t, window_s, window_t,
        loss_weights_vec, hp, total_rays=r_global, hull=hull)
    group = mesh.get_group(axis_name)
    buf = torch.cat([terms, flat])
    maxima = terms[list(MAX_TERMS)].clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(maxima, op=dist.ReduceOp.MAX, group=group)
    terms = buf[:TERMS].clone()
    terms[list(MAX_TERMS)] = maxima
    return _results(terms, *unpack(buf[TERMS:]))
