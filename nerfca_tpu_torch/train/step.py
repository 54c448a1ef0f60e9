"""The composite (4-D) train step, coarse and fine passes, and the static
(3-D) train step (port of ``nerfca_tpu/train/step.py``).

One step: variance-oversampled ray batch -> optional sub-pixel ray jitter
-> one shared stratified depth vector -> the loss and its gradients -> Adam
with linear LR decay and the static-freeze gate. The gradients come from
one of three paths:

  - ``use_pallas`` and ``use_fused_loss`` inside the envelope (no fine
    pass): the fused-loss kernel K3 (``ops/cuda/fused_train.py``), which
    returns the loss terms and every gradient in one pass;
  - ``use_pallas``: the field kernels K1/K2 under the loss battery in
    torch autograd;
  - otherwise both fields and the loss in plain torch autograd.

With ``depth_samples_fine`` > 0 the hierarchical fine pass follows the
coarse one (``nerfca_tpu/train/step.py:349-398``): ``sample_pdf`` draws
fine depths per ray from the coarse pass's density, and a second field
pair (``static_fine``/``temp_fine``) runs on the sorted union of coarse and
fine depths, through the ray form of K1/K2 with per-ray depths when both
fine configs lie in the envelope and plain otherwise; its render takes ray
0's depths for every ray, as the reference does.

An optional motion hull (``ops/hull.py``) gates the dynamic density on
every path. Under a data-parallel mesh (``parallel/mesh.py``) every rank
draws the same global batch and takes its slice of the rays: the K3 path
runs its sharded entry, and the autograd paths (two-kernel, plain, the fine
pass, the static step) compute the slice's partial of the global loss and
join the ranks through ``parallel/collectives.py``, as JAX's
``batch_sharding`` step computes the global function under GSPMD. The step
draws its random numbers on the host as the JAX step draws them
(``ops/prng.py``, :func:`step_draws`), so a seed gives the JAX run's
batches, jitter and depths; the step is also split so tests can inject the
batch and the depths (:func:`composite_grads`,
:func:`_fused_loss_metrics_grads`). Metrics stay on the device as 0-d
tensors; the trainer reads them back once per chunk.

The static step (:func:`make_static_train_step`, the ``run_nerf`` method)
evaluates one field on the batch's materialized points, through the
one-field K1/K2 with ``use_pallas`` (:func:`static_loss_fn`), and takes the
pixel loss plus the occlusion loss; it draws three keys a step
(:func:`static_step_draws`). As in JAX, the static step's kernel branch
runs in f32 whatever ``compute_dtype`` says (``nerfca_tpu/train/
step.py:843`` passes no dtype to ``fused_static_field``); its plain branch
takes ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch

from nerfca_tpu_torch.models.fields import (
    FieldConfig, params_from_jax, params_to_jax, torch_dtype,
)
from nerfca_tpu_torch.ops.cuda.fused_field import (
    fused_composite_fields,
    fused_composite_fields_rays,
    fused_static_field,
    kernel_supported,
    plain_composite_fields,
    plain_composite_fields_rays,
    plain_static_field,
)
from nerfca_tpu_torch.ops.cuda.fused_train import (
    fused_train_loss_and_grads,
    fused_train_loss_and_grads_sharded,
    fused_train_supported,
)
from nerfca_tpu_torch.ops.encoding import (
    free_window_alpha, free_window_mask, nerfies_alpha, nerfies_window,
)
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops.losses import (
    composite_losses, occlusion_loss, ray_mean, weighted_mse,
)
from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite
from nerfca_tpu_torch.ops.sampling import sample_pdf, stratify_depths
from nerfca_tpu_torch.ops.schedules import linear_param_decay
from nerfca_tpu_torch.parallel.collectives import (
    all_reduce_grads, axis_group, from_first_shard, global_amax, reduce_metrics, sum_partials,
)
from nerfca_tpu_torch.parallel.mesh import axis_size, batch_sharding
from nerfca_tpu_torch.utils.profiling import span


DATA_AXIS = "data"
# the metrics that are maxima over the batch (MAX over the ranks of a mesh)
MAX_METRICS = ("train_sigma_s_max", "train_sigma_d_max")


@dataclasses.dataclass(frozen=True)
class CompositeHParams:
    """Hyperparameters of the composite method (the JAX fields this slice
    uses; TPU-only kernel knobs are dropped)."""

    img_sample_size: int = 1024
    nb_var_rays: int = 0
    depth_samples_coarse: int = 500
    depth_samples_fine: int = 0
    output_activation: str = "softplus"
    favor_s_weight_start: float = 0.0
    favor_s_weight_end: float = 0.0
    favor_s_weight_delay_steps: int = 0
    dynamic_entro_weight_start: float = 0.0
    dynamic_entro_weight_end: float = 0.0
    occl_weight_start: float = 0.0
    occl_weight_end: float = 0.0
    l1_weight_start: float = 0.0
    l1_weight_end: float = 0.0
    hull_static_l1_weight_start: float = 0.0
    hull_static_l1_weight_end: float = 0.0
    static_tv_weight_start: float = 0.0
    static_tv_weight_end: float = 0.0
    hyperparam_decay_steps: int = 100000
    static_freeze_step: int = 0
    skewness_val: float = 1.0
    entro_mask_thre: float = 1e-4
    entro_use_weighting: bool = False
    entro_weighted_thresh: float = 0.0
    entro_clip_threshold: float = 1e-19
    occl_reg_perc: float = 0.1
    occl_front_only: bool = False
    compute_dtype: str = "float32"
    ray_jitter: float = 0.0
    use_pallas: bool = False
    use_fused_loss: bool = False
    # the fused-loss step stores its post-ReLU residuals in bf16 (K2 over
    # bf16 scratch); the forward and the loss stay f32
    pallas_bf16_residuals: bool = False

    @property
    def dtype(self) -> torch.dtype:
        """The plain fields' matmul dtype (``compute_dtype`` as a torch dtype)."""
        return torch_dtype(self.compute_dtype)


def field_window(cfg: FieldConfig, step: int, device=None) -> Optional[torch.Tensor]:
    """Per-band annealing window for a field at ``step`` (None if N/A)."""
    if cfg.pos_enc == "free_windowed":
        return free_window_mask(cfg.pos_enc_basis, step, cfg.pos_enc_window_decay_steps,
                                cfg.pos_enc_window_start, cfg.pos_enc_window_max, device)
    if cfg.pos_enc == "nerfies_windowed":
        alpha = nerfies_alpha(cfg.pos_enc_basis, step, cfg.pos_enc_window_decay_steps)
        if cfg.pos_enc_window_max > 0:
            alpha = min(alpha, cfg.pos_enc_window_max)
        return nerfies_window(cfg.pos_enc_basis, alpha, device)
    return None


def same_window_schedule(cfg_s: FieldConfig, cfg_t: FieldConfig) -> bool:
    """Whether two fields' windows are equal at every step: the same
    windowed (or ``'none'``) encoding, basis and schedule. ``'fourier'``
    fields have no window but projections of their own."""
    keys = ("pos_enc", "pos_enc_basis", "pos_enc_window_decay_steps", "pos_enc_window_start",
            "pos_enc_window_max")
    return (cfg_s.pos_enc in ("none", "free_windowed", "nerfies_windowed")
            and all(getattr(cfg_s, k) == getattr(cfg_t, k) for k in keys))


def field_windows(cfgs: dict, step: int, device=None) -> dict:
    """Both fields' windows at ``step`` (:func:`field_window`), as one tensor
    when :func:`same_window_schedule` holds: K1 in f32 then encodes each
    tile once for both fields (``ops/cuda/fused_field.py::encodings_agree``)."""
    w_s = field_window(cfgs["static"], step, device)
    if same_window_schedule(cfgs["static"], cfgs["temp"]):
        return {"static": w_s, "temp": w_s}
    return {"static": w_s, "temp": field_window(cfgs["temp"], step, device)}


def window_alpha(cfg: FieldConfig, step: int) -> float:
    """The scalar logged as ``train_*_windowed``."""
    if cfg.pos_enc == "free_windowed":
        return free_window_alpha(cfg.pos_enc_basis, step, cfg.pos_enc_window_decay_steps,
                                 cfg.pos_enc_window_start, cfg.pos_enc_window_max)
    if cfg.pos_enc == "nerfies_windowed":
        alpha = nerfies_alpha(cfg.pos_enc_basis, step, cfg.pos_enc_window_decay_steps)
        if cfg.pos_enc_window_max > 0:
            alpha = min(alpha, cfg.pos_enc_window_max)
        return float(alpha)
    return 0.0


def jitter_directions(d: torch.Tensor, jitter: float, u: torch.Tensor) -> torch.Tensor:
    """Perturb ray directions ``d [n, 3]`` by a uniform offset in
    ``[-jitter/2, jitter/2]`` along two axes perpendicular to each ray;
    ``u [n, 2]`` holds the uniforms in [0, 1)."""
    up = torch.where(
        torch.abs(d[:, 2:3]) < 0.9,
        torch.tensor([0.0, 0.0, 1.0], dtype=d.dtype, device=d.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=d.dtype, device=d.device),
    )
    e1 = torch.linalg.cross(d, up.expand_as(d))
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(d, e1)
    e2 = e2 / torch.linalg.norm(e2, dim=-1, keepdim=True)
    u = (u - 0.5) * jitter
    return d + u[:, 0:1] * e1 + u[:, 1:2] * e2


def batch_from_ids(rays: torch.Tensor, phases: torch.Tensor, idx: torch.Tensor) -> dict:
    """Gather one ray batch from the flat ``[N, 4, 3]`` ray table."""
    batch = rays[idx]
    return {
        "origins": batch[:, 0, :].contiguous(),
        "directions": batch[:, 1, :].contiguous(),
        "pixels": batch[:, 2, 0].contiguous(),
        "weights": batch[:, 3, 0].contiguous(),
        "phases": phases[idx],
    }


def step_draws(rng: np.ndarray, hp: CompositeHParams, n_var_ids: int, n_non_var_ids: int,
               n_rays: int, n_samples: int) -> tuple:
    """One train step's random numbers, drawn as the JAX step draws them
    (``nerfca_tpu/train/step.py:663-682``) through ``ops/prng.py``: the
    next key; the batch's positions, the first ``nb_var_rays`` into the
    high-variance ids and the rest into their complement (with replacement;
    into all rays without the split); the jitter uniforms ``[n, 2]`` (None
    without jitter); the depth uniforms ``[n_samples]``. All bits come from
    one numpy pass."""
    rng, k_sample, k_depth, k_fine = prng.split(rng, 4)
    k_jitter = prng.fold_in(k_fine, 1) if hp.ray_jitter > 0 else None
    return (rng, *_batch_depth_draws(k_sample, k_depth, k_jitter, hp, n_var_ids,
                                     n_non_var_ids, n_rays, n_samples))


def static_step_draws(rng: np.ndarray, hp: CompositeHParams, n_var_ids: int,
                      n_non_var_ids: int, n_rays: int, n_samples: int) -> tuple:
    """The static step's random numbers as the JAX static step draws them
    (``nerfca_tpu/train/step.py:881-888``): a three-way split of the key
    (next key, batch, depths), no jitter. Returns the next key, the batch's
    positions and the depth uniforms."""
    rng, k_sample, k_depth = prng.split(rng, 3)
    positions, _, t = _batch_depth_draws(k_sample, k_depth, None, hp, n_var_ids,
                                         n_non_var_ids, n_rays, n_samples)
    return rng, positions, t


def fine_uniforms(rng: np.ndarray, hp: CompositeHParams) -> np.ndarray:
    """The fine pass's inverse-CDF uniforms ``[n, F]`` of the step that
    draws from ``rng``: JAX's ``sample_pdf`` draws
    ``jax.random.uniform(k_fine, (n, F))`` (``nerfca_tpu/train/step.py:663``)."""
    k_fine = prng.split(rng, 4)[3]
    return prng.uniform(k_fine, (hp.img_sample_size, hp.depth_samples_fine))


def _batch_depth_draws(k_sample, k_depth, k_jitter, hp: CompositeHParams, n_var_ids: int,
                       n_non_var_ids: int, n_rays: int, n_samples: int) -> tuple:
    """Positions, jitter uniforms (None without ``k_jitter``) and depth
    uniforms from their keys, in one numpy pass."""
    n, nv = hp.img_sample_size, hp.nb_var_rays
    if nv > 0:
        k_var, k_non_var = prng.split(k_sample)
        draws = [(k_var, nv, n_var_ids), (k_non_var, n - nv, n_non_var_ids)]
    else:
        draws = [(k_sample, n, n_rays)]
    segments = []
    for k, size, _ in draws:  # randint: high words, then low words
        segments += [(kk, size) for kk in prng.split(k)]
    if k_jitter is not None:
        segments.append((k_jitter, 2 * n))
    segments.append((k_depth, n_samples))
    words = prng.bits_segments(segments)
    positions, start = [], 0
    for _, size, span in draws:
        high, low = words[start:start + size], words[start + size:start + 2 * size]
        positions.append(prng.randint_from_bits(high, low, span))
        start += 2 * size
    u = None
    if k_jitter is not None:
        u = prng.uniform_from_bits(words[start:start + 2 * n]).reshape(n, 2)
        start += 2 * n
    return np.concatenate(positions), u, prng.uniform_from_bits(words[start:])


def sample_ray_batch(rays, phases, var_ids, non_var_ids, positions: torch.Tensor,
                     hp: CompositeHParams) -> dict:
    """The ray batch at ``positions`` (from :func:`step_draws`): the first
    ``nb_var_rays`` index the high-variance id set, the rest its complement;
    without the split they index the rays."""
    if hp.nb_var_rays > 0:
        nv = hp.nb_var_rays
        idx = torch.cat([var_ids[positions[:nv]], non_var_ids[positions[nv:]]])
    else:
        idx = positions
    return batch_from_ids(rays, phases, idx)


def to_device(device: torch.device, ints: np.ndarray, *floats) -> tuple:
    """``ints`` (as int64) and each f32 array of ``floats`` on ``device``,
    through one pinned, non-blocking copy on a card; a ``None`` among
    ``floats`` comes back as ``None``."""
    buf = np.concatenate([ints.astype(np.int32)] + [f.astype(np.float32).ravel().view(np.int32)
                                                    for f in floats if f is not None])
    t = torch.from_numpy(buf)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    out, start = [t[:len(ints)].long()], len(ints)
    for f in floats:
        if f is None:
            out.append(None)
            continue
        out.append(t[start:start + f.size].view(torch.float32).reshape(f.shape))
        start += f.size
    return tuple(out)


def loss_weights(step: int, hp: CompositeHParams) -> dict:
    """Annealed loss weights (host floats); occlusion shares the favor_s
    delay, as in the reference."""
    d = hp.hyperparam_decay_steps
    return {
        "favor_s": linear_param_decay(step, hp.favor_s_weight_start, hp.favor_s_weight_end,
                                      d, hp.favor_s_weight_delay_steps),
        "dynamic_entro": linear_param_decay(step, hp.dynamic_entro_weight_start,
                                            hp.dynamic_entro_weight_end, d),
        "occl": linear_param_decay(step, hp.occl_weight_start, hp.occl_weight_end, d,
                                   hp.favor_s_weight_delay_steps),
        "l1": linear_param_decay(step, hp.l1_weight_start, hp.l1_weight_end, d),
        "hull_static_l1": linear_param_decay(step, hp.hull_static_l1_weight_start,
                                             hp.hull_static_l1_weight_end, d),
        "static_tv": linear_param_decay(step, hp.static_tv_weight_start,
                                        hp.static_tv_weight_end, d),
    }


def regularized_loss(pix_loss, losses, weights):
    return (
        pix_loss
        + weights["favor_s"] * losses.favor_s_loss
        + weights["dynamic_entro"] * losses.dynamic_entropy_loss
        + weights["occl"] * losses.dynamic_occl_loss
        + weights["l1"] * losses.static_l2_loss
        + weights["l1"] * losses.static_l1_loss
    )


def regularizer_losses(static_sigma, temp_sigma, dists, pixel_weights, hp: CompositeHParams,
                       total_rays=None):
    """The regularizer battery (``composite_losses``) on one pass's sigmas
    and dists under ``hp``'s shape parameters; ``total_rays``: the rays are
    a slice of that many (``ops/losses.py::ray_mean``)."""
    return composite_losses(
        static_sigma, temp_sigma, dists, pixel_weights, skewness_val=hp.skewness_val,
        entro_mask_thre=hp.entro_mask_thre, entro_use_weighting=hp.entro_use_weighting,
        entro_weighted_thresh=hp.entro_weighted_thresh, occl_reg_perc=hp.occl_reg_perc,
        entro_clip_threshold=hp.entro_clip_threshold, occl_front_only=hp.occl_front_only,
        total_rays=total_rays)


def along_ray_tv(sigma, total_rays=None):
    """Mean over rays of sum_i |sigma_{i+1} - sigma_i|."""
    return ray_mean(torch.sum(torch.abs(sigma[..., 1:] - sigma[..., :-1]), dim=-1), total_rays)


def evaluate_fields(params, origins, directions, depth_values, phases, windows, cfgs,
                    hp: CompositeHParams, suffix: str = ""):
    """Both fields of the pair ``suffix`` names (``""`` coarse, ``"_fine"``)
    on rays with shared ``[S]`` or per-ray ``[R, S]`` depths: raw densities
    ``[R, S, 1]`` each, from the CUDA kernels (their twin on CPU tensors)
    under ``hp.compute_dtype`` with ``use_pallas`` when both configs lie in
    the envelope, from the plain fields under ``hp.dtype`` otherwise (JAX
    gates each pass on its own pair)."""
    cfg_s, cfg_t = cfgs["static" + suffix], cfgs["temp" + suffix]
    if hp.use_pallas and kernel_supported(cfg_s) and kernel_supported(cfg_t):
        fn, dtype = fused_composite_fields_rays, hp.compute_dtype
    else:
        fn, dtype = plain_composite_fields_rays, hp.dtype
    return fn(params["static" + suffix], params["temp" + suffix], origins, directions,
              depth_values, phases, cfg_s, cfg_t, windows["static"], windows["temp"], dtype)


def evaluate_composite(params, points, point_phases, cfgs: dict, windows,
                       hp: CompositeHParams, suffix: str = ""):
    """Both fields on ``points [R, S, 3]`` with per-point phases ``[R, S]``
    (``nerfca_tpu/train/step.py:234-275``): the point-form kernels with
    ``use_pallas`` when both configs of the pair ``suffix`` names lie in
    the envelope, plain torch otherwise."""
    cfg_s, cfg_t = cfgs["static" + suffix], cfgs["temp" + suffix]
    if hp.use_pallas and kernel_supported(cfg_s) and kernel_supported(cfg_t):
        fn, dtype = fused_composite_fields, hp.compute_dtype
    else:
        fn, dtype = plain_composite_fields, hp.dtype
    return fn(params["static" + suffix], params["temp" + suffix], points, point_phases, cfg_s,
              cfg_t, windows["static"], windows["temp"], dtype)


def fine_depths(static_sigma, temp_sigma, depth_values, n_fine: int, u_fine,
                mesh=None) -> torch.Tensor:
    """The fine pass's sorted per-ray depths ``[R, S + F]``
    (``nerfca_tpu/train/step.py:354-363``): ``sample_pdf`` over the coarse
    midpoints with weights ``|differences|`` of the total coarse density (a
    1e-10 first column), normalised by the batch's global max, its ``F``
    draws from the uniforms ``u_fine [R, F]`` joined to the shared coarse
    depths ``[S]``. Differentiable w.r.t. the sigmas, as JAX's is. Under
    ``mesh`` the rays are this rank's slice, and the max is taken over every
    rank's (:func:`~nerfca_tpu_torch.parallel.collectives.global_amax`)."""
    total = static_sigma + temp_sigma
    w = torch.cat([torch.full_like(total[:, :1], 1e-10),
                   torch.abs(total[:, 1:] - total[:, :-1])], dim=-1)
    w = w / (torch.amax(w) if mesh is None else global_amax(w, mesh, DATA_AXIS))
    z = depth_values.expand(total.shape[0], depth_values.shape[0])
    z_mid = 0.5 * (z[:, 1:] + z[:, :-1])
    z_pdf = sample_pdf(None, z_mid, w[:, 1:-1], n_fine, u=u_fine)
    return torch.sort(torch.cat([z_pdf, z], dim=-1), dim=-1).values.contiguous()


def composite_forward(params, batch, depth_values, windows, cfgs, hp: CompositeHParams,
                      hull=None, u_fine=None, mesh=None) -> dict:
    """Coarse (and fine) forward pass -> renders and sigmas. ``depth_values``:
    the already-jittered shared ``[S]`` vector. ``hull``: optional
    ``MotionHull`` gating the dynamic density. ``u_fine``: the fine pass's
    uniforms ``[R, F]`` (:func:`fine_uniforms`) with ``depth_samples_fine``
    > 0. ``mesh``: ``batch`` and ``u_fine`` are this rank's slice of the
    global batch's rays, the first rank's slice starting at ray 0; the fine
    pass then takes the max over every rank and global ray 0's depths."""
    origins, dirs = batch["origins"], batch["directions"]
    i0 = batch["initial_intensities"]
    static_raw, temp_raw = evaluate_fields(params, origins, dirs, depth_values, batch["phases"],
                                           windows, cfgs, hp)
    temp_gate = None
    if hull is not None:
        temp_gate = hull_gate_rays(hull, origins, dirs, depth_values)
    pix, s_sig, t_sig, dists = render_transmission_composite(
        static_raw, temp_raw, i0, depth_values, hp.output_activation, temp_gate=temp_gate)
    out = {"pix_coarse": pix, "static_sigma_coarse": s_sig, "temp_sigma_coarse": t_sig,
           "dists_coarse": dists, "static_raw_coarse": static_raw,
           "temp_raw_coarse": temp_raw}
    if temp_gate is not None:
        out["temp_gate_coarse"] = temp_gate  # reused by the hull-gated L1
    if hp.depth_samples_fine > 0:
        z_fine = fine_depths(s_sig, t_sig, depth_values, hp.depth_samples_fine, u_fine, mesh)
        static_raw_f, temp_raw_f = evaluate_fields(params, origins, dirs, z_fine,
                                                   batch["phases"], windows, cfgs, hp, "_fine")
        temp_gate_f = None if hull is None else hull_gate_rays(hull, origins, dirs, z_fine)
        # the reference renders the fine pass with ray 0's sorted depths
        # (model_helpers.py:147, depth_vals_fine[0, :])
        z0 = z_fine[0] if mesh is None else from_first_shard(z_fine[0], mesh, DATA_AXIS)
        pix_f, s_sig_f, t_sig_f, dists_f = render_transmission_composite(
            static_raw_f, temp_raw_f, i0, z0, hp.output_activation, temp_gate=temp_gate_f)
        out.update(pix_fine=pix_f, static_sigma_fine=s_sig_f, temp_sigma_fine=t_sig_f,
                   dists_fine=dists_f)
    return out


def shard_rays(mesh, batch: dict, *per_ray) -> tuple:
    """This rank's slice of the rays (``RaySharding.uneven_slice`` over the
    mesh's ``'data'`` axis): the batch dict's tensors and each of
    ``per_ray`` (None stays None), with the global ray count first."""
    n = batch["origins"].shape[0]
    part = batch_sharding(mesh, DATA_AXIS).uneven_slice(n)
    return (n, {k: v[part] for k, v in batch.items()},
            *(None if t is None else t[part] for t in per_ray))


def composite_loss_fn(params, batch, depth_values, step: int, cfgs, hp: CompositeHParams,
                      hull=None, u_fine=None, mesh=None):
    """Total regularized loss + metric dict (same names as the JAX step).
    ``hull``: optional motion-hull gate; it adds the hull-gated static L1
    (the mean over rays of the static line integral inside the hull).
    ``u_fine``: the fine pass's uniforms, with ``depth_samples_fine`` > 0;
    the fine pass adds its pixel loss, with unit pixel weights, and its
    regularizers.

    ``mesh``: a ``DeviceMesh`` with a ``'data'`` axis. ``batch`` and
    ``u_fine`` are the global batch's; each rank computes its slice's
    partial of the loss (ray means over the global ray count) and the
    returned loss and metrics are the global batch's on every rank (the
    sigma maxima by MAX), while the loss backpropagates this rank's share
    of the global gradient (``parallel/collectives.py``)."""
    n = None
    if mesh is not None:
        n, batch, u_fine = shard_rays(mesh, batch, u_fine)
    dev = batch["origins"].device
    windows = field_windows(cfgs, step, dev)
    fwd = composite_forward(params, batch, depth_values, windows, cfgs, hp, hull=hull,
                            u_fine=u_fine, mesh=mesh)
    weights = loss_weights(step, hp)
    pixel_loss_c = ray_mean(weighted_mse(fwd["pix_coarse"], batch["pixels"], batch["weights"]),
                            n)
    losses = regularizer_losses(fwd["static_sigma_coarse"], fwd["temp_sigma_coarse"],
                                fwd["dists_coarse"], batch["weights"], hp, n)
    loss = regularized_loss(pixel_loss_c, losses, weights)
    zero = torch.zeros((), device=dev)
    static_tv = zero
    if hp.static_tv_weight_start > 0 or hp.static_tv_weight_end > 0:
        static_tv = along_ray_tv(fwd["static_sigma_coarse"], n)
        loss = loss + weights["static_tv"] * static_tv
    hull_s_l1 = zero
    if hull is not None:
        hull_s_l1 = ray_mean(torch.sum(
            fwd["static_sigma_coarse"] * fwd["dists_coarse"] * fwd["temp_gate_coarse"], dim=-1), n)
        loss = loss + weights["hull_static_l1"] * hull_s_l1
    metrics = {
        "train_hull_s_l1": hull_s_l1.detach(),
        "hull_static_l1_weight": weights["hull_static_l1"],
        "train_static_tv": static_tv.detach(),
        "static_tv_weight": weights["static_tv"],
        "train_pixel_loss_coarse": pixel_loss_c.detach(),
        "train_blendw": losses.blendw_mean.detach(),
        "train_sigma_s_max": losses.sigma_s_max,
        "train_sigma_d_max": losses.sigma_d_max,
        "train_favor_s_loss": losses.favor_s_loss.detach(),
        "train_s_entropy_loss": losses.static_entropy_loss.detach(),
        "train_d_entropy_loss": losses.dynamic_entropy_loss.detach(),
        "train_s_entropy_sum": losses.static_entropy_sum.detach(),
        "train_d_entropy_sum": losses.dynamic_entropy_sum.detach(),
        "train_d_occl_loss": losses.dynamic_occl_loss.detach(),
        "train_s_l1": losses.static_l1_loss.detach(),
        "train_s_l2": losses.static_l2_loss.detach(),
        "favor_s_weight": weights["favor_s"],
        "dynamic_entro_weight": weights["dynamic_entro"],
        "occl_weight": weights["occl"],
        "l1_weight": weights["l1"],
        "train_static_windowed": window_alpha(cfgs["static"], step),
        "train_temp_windowed": window_alpha(cfgs["temp"], step),
    }
    if hp.depth_samples_fine > 0:
        # unit pixel weights (run_composite.py:296-301); the logged
        # regularizers are overwritten with the fine pass's, as the
        # reference logs them
        pixel_loss_f = ray_mean(weighted_mse(fwd["pix_fine"], batch["pixels"],
                                             torch.ones_like(batch["weights"])), n)
        losses_f = regularizer_losses(fwd["static_sigma_fine"], fwd["temp_sigma_fine"],
                                      fwd["dists_fine"], batch["weights"], hp, n)
        loss = loss + regularized_loss(pixel_loss_f, losses_f, weights)
        metrics.update(train_pixel_loss_fine=pixel_loss_f.detach(),
                       train_favor_s_loss=losses_f.favor_s_loss.detach(),
                       train_d_entropy_loss=losses_f.dynamic_entropy_loss.detach())
    if mesh is not None:
        loss = sum_partials(loss, mesh, DATA_AXIS)
        metrics = reduce_metrics(metrics, mesh, DATA_AXIS, MAX_METRICS)
    metrics["train_loss"] = loss.detach()
    metrics["train_psnr"] = -10.0 * torch.log10(loss.detach())
    return loss, metrics


# ---------------------------------------------------------------------------
# Parameters and the optimizer


def param_items(params) -> list:
    """``(name, tensor)`` for every leaf Adam holds, in a fixed order: the
    early layers, a ``fourier`` field's projection (a buffer: its gradient
    is zero, so Adam leaves it as it is, as optax does), the output layer,
    the latent table, then a field's skip and late layers."""
    items = []
    for group in sorted(params):
        p = params[group]
        for i, layer in enumerate(p["early"]):
            items += [(f"{group}/early/{i}/{k}", layer[k]) for k in sorted(layer)]
        if "fourier" in p:
            items.append((f"{group}/fourier", p["fourier"]))
        items += [(f"{group}/out/{k}", p["out"][k]) for k in sorted(p["out"])]
        if "latents" in p:
            items.append((f"{group}/latents", p["latents"]))
        if "skip" in p:
            items += [(f"{group}/skip/{k}", p["skip"][k]) for k in sorted(p["skip"])]
        for i, layer in enumerate(p.get("late", [])):
            items += [(f"{group}/late/{i}/{k}", layer[k]) for k in sorted(layer)]
    return items


def params_from_leaves(params, leaves) -> dict:
    """A tree shaped as ``params`` holding ``leaves`` (``param_items`` order)."""
    it = iter(leaves)
    out = {}
    for group in sorted(params):
        p = params[group]
        g = {"early": [{k: next(it) for k in sorted(layer)} for layer in p["early"]]}
        if "fourier" in p:
            g["fourier"] = next(it)
        g["out"] = {k: next(it) for k in sorted(p["out"])}
        if "latents" in p:
            g["latents"] = next(it)
        if "skip" in p:
            g["skip"] = {k: next(it) for k in sorted(p["skip"])}
        if "late" in p:
            g["late"] = [{k: next(it) for k in sorted(layer)} for layer in p["late"]]
        out[group] = g
    return out


def is_buffer(name: str) -> bool:
    """A leaf that no gradient reaches: a ``fourier`` field's projection."""
    return name.endswith("/fourier")


def _grads_of(loss, params) -> list:
    """The gradient of ``loss`` w.r.t. every ``param_items`` leaf, zeros for
    the buffers."""
    items = param_items(params)
    trained = [t for n, t in items if not is_buffer(n)]
    it = iter(torch.autograd.grad(loss, trained))
    return [torch.zeros_like(t) if is_buffer(n) else next(it) for n, t in items]


def _require_grads(params) -> None:
    for n, t in param_items(params):
        if not is_buffer(n):
            t.requires_grad_(True)


def _global_grads(loss, params, mesh) -> list:
    """:func:`_grads_of`, SUMmed over the mesh's ``'data'`` axis in one
    all-reduce under ``mesh``: each rank's loss backpropagates its share."""
    grads = _grads_of(loss, params)
    return grads if mesh is None else all_reduce_grads(grads, mesh, DATA_AXIS)


def composite_grads(params, batch, depth_values, step: int, cfgs, hp: CompositeHParams,
                    hull=None, u_fine=None, mesh=None):
    """Loss, metrics and the gradient of every leaf (``param_items`` order)
    for an injected batch, depths and (with the fine pass) fine uniforms;
    under ``mesh`` the global batch's, equal on every rank
    (:func:`composite_loss_fn`)."""
    _require_grads(params)
    loss, metrics = composite_loss_fn(params, batch, depth_values, step, cfgs, hp, hull=hull,
                                      u_fine=u_fine, mesh=mesh)
    return loss.detach(), metrics, _global_grads(loss, params, mesh)


def _fused_loss_metrics_grads(params, batch, depth_values, step: int, cfgs,
                             hp: CompositeHParams, hull=None, fused_fn=None):
    """The fused-loss path: loss, the metric dict of the JAX fused path
    (``nerfca_tpu/train/step.py:729-773``; no static-TV entries) and the
    gradient of every leaf in ``param_items`` order. ``fused_fn`` is K3's
    entry (default :func:`fused_train_loss_and_grads`; under a mesh the
    sharded one)."""
    fused_fn = fused_fn or fused_train_loss_and_grads
    dev = batch["origins"].device
    windows = field_windows(cfgs, step, dev)
    weights = loss_weights(step, hp)
    lw = [weights["favor_s"], weights["dynamic_entro"], weights["occl"], weights["l1"],
          weights["hull_static_l1"]]
    loss, terms, g_s, g_t = fused_fn(
        params["static"], params["temp"], batch["origins"], batch["directions"], depth_values,
        batch["phases"], batch["pixels"], batch["weights"], batch["initial_intensities"],
        cfgs["static"], cfgs["temp"], windows["static"], windows["temp"], lw, hp, hull=hull)
    metrics = {
        "train_pixel_loss_coarse": terms["pixel_loss"],
        "train_blendw": terms["blendw"],
        "train_sigma_s_max": terms["sigma_s_max"],
        "train_sigma_d_max": terms["sigma_d_max"],
        "train_favor_s_loss": terms["favor_s"],
        "train_s_entropy_loss": terms["s_entropy"],
        "train_d_entropy_loss": terms["d_entropy"],
        "train_s_entropy_sum": terms["s_entropy_sum"],
        "train_d_entropy_sum": terms["d_entropy_sum"],
        "train_d_occl_loss": terms["occl"],
        "train_s_l1": terms["l1"],
        "train_s_l2": terms["l2"],
        "train_hull_s_l1": terms["hull_s_l1"],
        "favor_s_weight": weights["favor_s"],
        "dynamic_entro_weight": weights["dynamic_entro"],
        "occl_weight": weights["occl"],
        "l1_weight": weights["l1"],
        "hull_static_l1_weight": weights["hull_static_l1"],
        "train_static_windowed": window_alpha(cfgs["static"], step),
        "train_temp_windowed": window_alpha(cfgs["temp"], step),
        "train_loss": loss,
        "train_psnr": -10.0 * torch.log10(loss),
    }
    grads = [g for _, g in param_items({"static": g_s, "temp": g_t})]
    return loss, metrics, grads


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """optax.adam(linear_schedule(lr, lr*end_factor, decay_steps), 0.9, 0.999, 1e-8);
    with ``weight_decay`` optax.adamw with the same schedule and moments,
    the decay masked to the ``w`` leaves (``nerfca_tpu/train/step.py:906-935``)."""

    lr: float
    lr_end_factor: float
    lr_decay_steps: int
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule at the pre-increment count, in float32."""
        f = np.float32
        init, end = f(self.lr), f(self.lr * self.lr_end_factor)
        c = f(min(max(count, 0), self.lr_decay_steps))
        frac = f(1) - c / f(self.lr_decay_steps)
        return float((init - end) * frac + end)


def make_optimizer(lr: float, lr_end_factor: float, lr_decay_steps: int,
                   weight_decay: float = 0.0) -> AdamConfig:
    """Adam with linear LR decay; ``weight_decay`` > 0 adds the decoupled
    (AdamW) decay on the MLP weight matrices (the ``w`` leaves: biases,
    latents and fourier projections are exempt), as JAX's optax.adamw."""
    return AdamConfig(lr, lr_end_factor, lr_decay_steps, weight_decay=float(weight_decay))


def is_decayed(name: str) -> bool:
    """A leaf AdamW decays: a weight matrix (the JAX mask: a ``w`` key)."""
    return name.rsplit("/", 1)[-1] == "w"


def init_opt_state(params) -> dict:
    leaves = [t for _, t in param_items(params)]
    return {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves]}


def opt_state_from_jax(adam_state, device=None) -> dict:
    """optax's Adam state -> the port's ``opt_state``. ``adam_state`` is a
    ``ScaleByAdamState`` (``count``, ``mu``, ``nu`` over the JAX param
    tree) or the whole ``optax.adam`` chain state that holds one."""
    if not hasattr(adam_state, "mu"):
        adam_state = next(s for s in adam_state if hasattr(s, "mu"))

    def flat(tree):
        return [t for _, t in param_items({k: params_from_jax(v, device)
                                           for k, v in tree.items()})]

    return {"count": int(np.asarray(adam_state.count)), "mu": flat(adam_state.mu),
            "nu": flat(adam_state.nu)}


def opt_state_to_jax(opt_state: dict, params) -> dict:
    """Inverse of :func:`opt_state_from_jax`: ``count`` (int32) and ``mu``/
    ``nu`` as JAX-layout numpy trees, the fields of optax's
    ``ScaleByAdamState``. ``params`` gives the tree's shape."""
    def tree(leaves):
        return {k: params_to_jax(v) for k, v in params_from_leaves(params, leaves).items()}

    return {"count": np.int32(opt_state["count"]), "mu": tree(opt_state["mu"]),
            "nu": tree(opt_state["nu"])}


@torch.no_grad()
def adam_update(params, opt_state: dict, grads, tx: AdamConfig, step: int,
                hp: CompositeHParams) -> None:
    """One functional Adam step in place, as optax computes it: moments of
    EVERY leaf are updated, bias correction uses the incremented count, the
    LR is the schedule at the pre-increment count, and ``eps`` sits outside
    the square root; AdamW adds ``weight_decay * p`` to the update of each
    ``w`` leaf before the LR scales it (optax's ``add_decayed_weights``).
    Past ``static_freeze_step`` the static updates are multiplied by 0
    after the moments moved (``step.py:700-714``)."""
    count = opt_state["count"]
    lr = tx.learning_rate(count)
    c = count + 1
    bc1 = float(1 - np.float32(tx.b1) ** np.float32(c))
    bc2 = float(1 - np.float32(tx.b2) ** np.float32(c))
    freeze = hp.static_freeze_step
    static_gate = 0.0 if (freeze > 0 and step >= freeze) else 1.0
    for (name, p), g, mu, nu in zip(param_items(params), grads, opt_state["mu"],
                                    opt_state["nu"]):
        mu.mul_(tx.b1).add_(g, alpha=1 - tx.b1)
        nu.mul_(tx.b2).add_(g * g, alpha=1 - tx.b2)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + tx.eps)
        if tx.weight_decay and is_decayed(name):
            upd = upd + tx.weight_decay * p
        gate = static_gate if name.startswith("static") else 1.0
        p.add_(upd * (-lr * gate))
    opt_state["count"] = c


@dataclasses.dataclass
class TrainState:
    """Params, Adam state, step and the ``ops/prng.py`` key (``uint32[2]``)
    the next step draws from."""

    params: dict
    opt_state: dict
    step: int
    rng: np.ndarray


def make_composite_train_step(cfgs: dict, hp: CompositeHParams, tx: AdamConfig,
                              depth_values_base: torch.Tensor, initial_intensity: float,
                              mesh=None):
    """Build ``train_step(state, rays, phases, var_ids, non_var_ids, hull=None)
    -> metrics``; it updates ``state`` in place. With ``use_pallas`` and
    ``use_fused_loss`` the step takes the fused-loss kernel K3; a config
    outside K3's envelope takes the two-kernel path, with a warning.

    ``mesh``: a ``DeviceMesh`` with a ``'data'`` axis (``parallel/mesh.py``)
    for data parallelism, as JAX's ``batch_sharding`` (``step.py:620-718``):
    every rank draws the same global batch, jitter, depths and fine
    uniforms from the same key and takes its slice of the rays. With K3 and
    a batch that splits evenly over the shards, K3 runs on the slice and
    all-reduces (:func:`fused_train_loss_and_grads_sharded`; JAX also asks
    for whole Pallas tiles of rays, which the port's K3 does not have);
    otherwise, as JAX's branch rule (``:638-656``), the autograd path (K1/K2
    or plain, the fine pass included) takes the slice, the first
    ``R % world`` ranks one ray more (:func:`composite_grads`), and one
    all-reduce joins the gradients. Every rank applies the same Adam update
    and freeze gate, so the parameters stay equal bit for bit.

    With ``depth_samples_fine`` > 0 each step also draws the fine pass's
    uniforms (:func:`fine_uniforms`) and takes the K1/K2 or plain path, as
    K3 has no fine pass (``nerfca_tpu/ops/pallas/fused_train.py:80``)."""
    fused = hp.use_pallas and hp.use_fused_loss
    if fused and not fused_train_supported(cfgs["static"], cfgs["temp"], hp):
        warnings.warn("config outside the fused-loss kernel's envelope (coarse pass, no "
                      "static TV, field-kernel fields, softplus/sigmoid/clamp, <= 1024 "
                      "samples); taking the two-kernel path")
        fused = False
    fused_fn = None
    if mesh is not None:
        check_mesh(mesh, hp.img_sample_size)
        n_shards = axis_size(mesh, DATA_AXIS)
        if fused and hp.img_sample_size % n_shards:
            warnings.warn(f"{hp.img_sample_size} rays do not split evenly over {n_shards} "
                          f"shards for the sharded fused-loss kernel; taking the two-kernel "
                          f"path")
            fused = False
        if fused:
            fused_fn = functools.partial(fused_train_loss_and_grads_sharded, mesh, DATA_AXIS)

    def train_step(state: TrainState, rays, phases, var_ids, non_var_ids, hull=None):
        with span("nerfca.step.draws"):
            u_fine = fine_uniforms(state.rng, hp) if hp.depth_samples_fine > 0 else None
            state.rng, positions, u, t = step_draws(
                state.rng, hp, var_ids.shape[0], non_var_ids.shape[0], rays.shape[0],
                depth_values_base.shape[0])
        with span("nerfca.step.upload"):
            positions, t, u, u_fine = to_device(rays.device, positions, t, u, u_fine)
        with span("nerfca.step.batch"):
            batch = sample_ray_batch(rays, phases, var_ids, non_var_ids, positions, hp)
            if u is not None:
                batch["directions"] = jitter_directions(batch["directions"], hp.ray_jitter, u)
            batch["initial_intensities"] = torch.full(
                (hp.img_sample_size,), initial_intensity, device=rays.device)
            z = stratify_depths(depth_values_base, t_rand=t)
        with span("nerfca.step.loss_grads"):
            if fused:
                _, metrics, grads = _fused_loss_metrics_grads(
                    state.params, batch, z, state.step, cfgs, hp, hull=hull, fused_fn=fused_fn)
            else:
                _, metrics, grads = composite_grads(state.params, batch, z, state.step, cfgs,
                                                    hp, hull=hull, u_fine=u_fine, mesh=mesh)
        with span("nerfca.step.adam"):
            adam_update(state.params, state.opt_state, grads, tx, state.step, hp)
        state.step += 1
        return metrics

    return train_step


def check_mesh(mesh, n_rays: int) -> None:
    """Raise ``ValueError`` unless ``mesh`` has a ``'data'`` axis over which
    a batch of ``n_rays`` leaves no shard empty."""
    axis_group(mesh, DATA_AXIS)
    batch_sharding(mesh, DATA_AXIS).uneven_slice(n_rays)


# ---------------------------------------------------------------------------
# The static (3-D, run_nerf) method


@dataclasses.dataclass(frozen=True)
class StaticHParams:
    """Hyperparameters of the static single-field method (the JAX fields)."""

    img_sample_size: int = 1024
    nb_var_rays: int = 0
    depth_samples_coarse: int = 500
    output_activation: str = "softplus"
    occl_weight_start: float = 1e-4
    occl_reg_perc: float = 0.1
    occl_front_only: bool = False
    compute_dtype: str = "float32"
    use_pallas: bool = False

    @property
    def dtype(self) -> torch.dtype:
        """The plain field's matmul dtype (``compute_dtype`` as a torch dtype)."""
        return torch_dtype(self.compute_dtype)


def static_loss_fn(params, batch, depth_values, step: int, cfg: FieldConfig,
                   hp: StaticHParams, mesh=None):
    """Pixel + occlusion loss of the static method and its metrics
    (``nerfca_tpu/train/step.py:830-863``). The field runs on the batch's
    points through the one-field kernels with ``use_pallas`` (their twin on
    CPU tensors), in f32 as JAX's kernel branch runs whatever
    ``compute_dtype`` says; otherwise (or outside the envelope) the plain
    field under ``compute_dtype``. The occlusion term takes the UNSCALED
    sigma of the single-field renderer, as the reference does. ``mesh``:
    the global batch, sliced and joined as :func:`composite_loss_fn` does."""
    n = None
    if mesh is not None:
        n, batch = shard_rays(mesh, batch)
    window = field_window(cfg, step, batch["origins"].device)
    pts = (batch["origins"][:, None, :]
           + batch["directions"][:, None, :] * depth_values[:, None])
    if hp.use_pallas and kernel_supported(cfg):
        raw = fused_static_field(params["static"], pts, cfg, window)
    else:
        raw = plain_static_field(params["static"], pts, cfg, window, hp.dtype)
    pix, sigma, dists = render_transmission(raw, batch["initial_intensities"], depth_values,
                                            hp.output_activation)
    pixel_loss = ray_mean(weighted_mse(pix, batch["pixels"], batch["weights"]), n)
    occl = occlusion_loss(sigma, dists, hp.occl_reg_perc, front_only=hp.occl_front_only,
                          total_rays=n)
    loss = pixel_loss + hp.occl_weight_start * occl
    terms = {"train_pixel_loss": pixel_loss.detach(), "train_occl_loss": occl.detach()}
    if mesh is not None:
        loss = sum_partials(loss, mesh, DATA_AXIS)
        terms = reduce_metrics(terms, mesh, DATA_AXIS)
    metrics = {
        "train_loss": loss.detach(),
        "train_psnr": -10.0 * torch.log10(loss.detach()),
        **terms,
        "train_static_windowed": window_alpha(cfg, step),
    }
    return loss, metrics


def static_grads(params, batch, depth_values, step: int, cfg: FieldConfig, hp: StaticHParams,
                 mesh=None):
    """Loss, metrics and the gradient of every leaf (``param_items`` order)
    for an injected batch and depths; under ``mesh`` the global batch's."""
    _require_grads(params)
    loss, metrics = static_loss_fn(params, batch, depth_values, step, cfg, hp, mesh=mesh)
    return loss.detach(), metrics, _global_grads(loss, params, mesh)


def make_static_train_step(cfg: FieldConfig, hp: StaticHParams, tx: AdamConfig,
                           depth_values_base: torch.Tensor, initial_intensity: float,
                           mesh=None):
    """Build ``train_step(state, rays, phases, var_ids, non_var_ids, hull=None)
    -> metrics`` for the static method (``nerfca_tpu/train/step.py:866-902``);
    it updates ``state`` in place. The batch is drawn under a composite
    hyperparameter set that carries only the batch size and the
    high-variance share; the method has no hull, no schedule of loss
    weights and no freeze gate (``hull`` is accepted and ignored).
    ``mesh``: data parallelism as JAX's ``batch_sharding``: every rank
    draws the same batch and depths, computes its slice's share
    (:func:`static_grads`) and applies the same update."""
    comp_hp = CompositeHParams(img_sample_size=hp.img_sample_size, nb_var_rays=hp.nb_var_rays)
    if mesh is not None:
        check_mesh(mesh, hp.img_sample_size)

    def train_step(state: TrainState, rays, phases, var_ids, non_var_ids, hull=None):
        del hull
        with span("nerfca.step.draws"):
            state.rng, positions, t = static_step_draws(
                state.rng, comp_hp, var_ids.shape[0], non_var_ids.shape[0], rays.shape[0],
                depth_values_base.shape[0])
        with span("nerfca.step.upload"):
            positions, t = to_device(rays.device, positions, t)
        with span("nerfca.step.batch"):
            batch = sample_ray_batch(rays, phases, var_ids, non_var_ids, positions, comp_hp)
            batch["initial_intensities"] = torch.full(
                (hp.img_sample_size,), initial_intensity, device=rays.device)
            z = stratify_depths(depth_values_base, t_rand=t)
        with span("nerfca.step.loss_grads"):
            _, metrics, grads = static_grads(state.params, batch, z, state.step, cfg, hp,
                                             mesh=mesh)
        with span("nerfca.step.adam"):
            adam_update(state.params, state.opt_state, grads, tx, state.step, comp_hp)
        state.step += 1
        return metrics

    return train_step
