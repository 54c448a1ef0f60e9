"""End-to-end trainers: the composite driver and the static (3-D) driver
(port of ``nerfca_tpu/train/trainer.py``).

The dataset is built when absent, loaded once and moved to the device; the
train loop runs in chunks of steps whose metrics stay on the device and are
read back once per chunk; the selection view is rendered at
``display_every`` boundaries and feeds checkpoint-best selection and the
patience stop; checkpoints go under the run's log dir every
``save_every`` steps, at a stop and at the end (``train/checkpoint.py``),
and ``--resume_from`` restores the full state. With ``--use_motion_hull``
the hull is carved from the training views' variance maps after the
dataset is loaded and gates every train step and eval render.

:func:`train_static` (the ``run_nerf`` method) trains one static field on a
single-phase dataset through the same loop, scoring the first test view.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed

from nerfca_tpu_torch.data.dataset import build_dataset, dataset_paths, parse_selection_views
from nerfca_tpu_torch.data.loader import denormalize_image, load_dataset
from nerfca_tpu_torch.geometry.rays import detector_rays
from nerfca_tpu_torch.models.fields import FieldConfig, init_static_field, init_temporal_field
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.hull import hull_args_record, hull_from_args
from nerfca_tpu_torch.ops.cuda.fused_field import kernel_supported
from nerfca_tpu_torch.ops.cuda.hash_field import kernel_supported as hash_kernel_supported
from nerfca_tpu_torch.ops.sampling import linspace_depths, stratify_depths
from nerfca_tpu_torch.train import evaluation
from nerfca_tpu_torch.train.checkpoint import CheckpointManager, load_checkpoint
from nerfca_tpu_torch.train.config import parse_args
from nerfca_tpu_torch.train.logging import MetricsLogger, make_log_dir
from nerfca_tpu_torch.utils.profiling import span, trace
from nerfca_tpu_torch.train.step import (
    CompositeHParams, StaticHParams, TrainState, init_opt_state, make_composite_train_step,
    make_optimizer, make_static_train_step,
)

EARLY_STOP_EPS = 1e-15


def resolve_device(platform: str) -> torch.device:
    """``cuda`` (the default) or ``cpu``; no silent fallback."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--platform cuda: no CUDA device is available "
                               "(pass --platform cpu to run on the CPU)")
        return torch.device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {platform!r}")


def static_config_from_args(args) -> FieldConfig:
    return FieldConfig(
        num_early_layers=args.static_num_early_layers,
        num_late_layers=args.static_num_late_layers,
        num_filters=args.static_num_filters,
        num_input_channels=args.num_input_channels,
        num_output_channels=args.num_output_channels,
        pos_enc=args.static_pos_enc,
        pos_enc_basis=args.static_pos_enc_basis,
        pos_enc_window_start=args.static_pos_enc_window_start,
        pos_enc_window_decay_steps=args.static_pos_enc_window_decay_steps,
        pos_enc_window_max=args.static_pos_enc_window_max,
        fourier_sigma=args.static_pos_enc_fourier_sigma,
        hidden_activation=args.static_hidden_activation,
    )


def volume_half_extent(info: dict) -> float:
    """The half extent of the cube at the origin that holds the dataset's
    volume (scaled units), the box a ``hashgrid`` field encodes over."""
    half = 0.5 * np.asarray(info["nVoxel"], np.float64) * np.asarray(info["dVoxel"], np.float64)
    return float(np.max(np.abs(np.asarray(info["offOrigin"], np.float64)) + half))


def field_configs_from_args(args) -> dict:
    static = static_config_from_args(args)
    temp = FieldConfig(
        num_early_layers=args.temp_num_early_layers,
        num_late_layers=args.temp_num_late_layers,
        num_filters=args.temp_num_filters,
        num_input_channels=args.num_input_channels,
        num_output_channels=args.num_output_channels,
        pos_enc=args.temp_pos_enc,
        pos_enc_basis=args.temp_pos_enc_basis,
        pos_enc_window_start=args.temp_pos_enc_window_start,
        pos_enc_window_decay_steps=args.temp_pos_enc_window_decay_steps,
        pos_enc_window_max=args.temp_pos_enc_window_max,
        fourier_sigma=args.temp_pos_enc_fourier_sigma,
        use_time_latents=args.use_time_latents,
        num_time_dim=args.num_time_dim,
    )
    cfgs = {"static": static, "temp": temp}
    if args.depth_samples_per_ray_fine > 0:
        # the fine pass's own pair: the coarse configs at the fine widths
        cfgs["static_fine"] = dataclasses.replace(static, num_filters=args.static_num_filters_fine)
        cfgs["temp_fine"] = dataclasses.replace(temp, num_filters=args.temp_num_filters_fine)
    return cfgs


def composite_hparams_from_args(args) -> CompositeHParams:
    nb_var = 0
    if args.var_sample_perc > 0:
        nb_var = int((args.var_sample_perc / 100.0) * args.img_sample_size)
    return CompositeHParams(
        img_sample_size=args.img_sample_size,
        nb_var_rays=nb_var,
        depth_samples_coarse=args.depth_samples_per_ray_coarse,
        depth_samples_fine=args.depth_samples_per_ray_fine,
        output_activation=args.output_activation,
        favor_s_weight_start=args.favor_s_weight_start,
        favor_s_weight_end=args.favor_s_weight_end,
        favor_s_weight_delay_steps=args.favor_s_weight_delay_steps,
        dynamic_entro_weight_start=args.dynamic_entro_weight_start,
        dynamic_entro_weight_end=args.dynamic_entro_weight_end,
        occl_weight_start=args.occl_weight_start,
        occl_weight_end=args.occl_weight_end,
        l1_weight_start=args.l1_weight_start,
        l1_weight_end=args.l1_weight_end,
        hull_static_l1_weight_start=args.hull_static_l1_weight_start,
        hull_static_l1_weight_end=args.hull_static_l1_weight_end,
        static_tv_weight_start=args.static_tv_weight_start,
        static_tv_weight_end=args.static_tv_weight_end,
        hyperparam_decay_steps=args.hyperparam_decay_steps,
        static_freeze_step=args.static_freeze_step,
        skewness_val=args.skewness_val,
        entro_mask_thre=args.entro_mask_thre,
        entro_use_weighting=args.entro_use_weighting,
        entro_weighted_thresh=args.entro_weighted_thresh,
        entro_clip_threshold=args.entro_clip_threshold,
        occl_reg_perc=args.occl_reg_perc,
        occl_front_only=args.occl_front_only,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
        use_fused_loss=args.use_fused_loss,
        pallas_bf16_residuals=args.pallas_bf16_residuals,
    )


def static_hparams_from_args(args) -> StaticHParams:
    nb_var = 0
    if args.var_sample_perc > 0:
        nb_var = int((args.var_sample_perc / 100.0) * args.img_sample_size)
    return StaticHParams(
        img_sample_size=args.img_sample_size,
        nb_var_rays=nb_var,
        depth_samples_coarse=args.depth_samples_per_ray_coarse,
        output_activation=args.output_activation,
        occl_weight_start=args.occl_weight_start,
        occl_reg_perc=args.occl_reg_perc,
        occl_front_only=args.occl_front_only,
        compute_dtype=args.compute_dtype,
        use_pallas=args.use_pallas,
    )


def resolve_pallas_support(hp, cfgs):
    """Downgrade ``use_pallas`` (and ``use_fused_loss``) to the plain torch
    path, with a warning, when a field config the coarse pass evaluates
    falls outside the CUDA kernels' envelope (JAX's rule,
    ``nerfca_tpu/train/trainer.py:153-196``). ``cfgs``: the composite's
    dict of configs, or the static trainer's single ``FieldConfig``. Only
    the coarse pair decides: a fine pair outside the envelope only warns,
    and its pass runs plain (``composite_forward`` gates each pass on its
    own pair) while the coarse pass keeps the kernels. The static trainer's
    ``hashgrid`` field in the hash-field kernel's envelope keeps
    ``use_pallas``, with a warning: it trains plain, and its eval views take
    that kernel."""
    if not hp.use_pallas:
        return hp
    if not isinstance(cfgs, dict) and hash_kernel_supported(cfgs):
        warnings.warn("a hashgrid field trains on the plain torch path (no kernel computes "
                      "the hash grid's backward); its eval views take the hash-field kernel")
        return hp
    coarse = [cfgs[k] for k in ("static", "temp") if k in cfgs] if isinstance(cfgs, dict) \
        else [cfgs]
    if all(kernel_supported(c) for c in coarse):
        if isinstance(cfgs, dict) and not all(kernel_supported(c) for c in cfgs.values()):
            warnings.warn("fine-field config outside the CUDA field-kernel envelope; the fine "
                          "pass runs on the plain torch path (the coarse pass keeps the "
                          "kernels)")
        return hp
    warnings.warn("field config outside the CUDA field-kernel envelope (width 128, no "
                  "late layers, 128 encoded features at most); falling back to the plain "
                  "torch path (use_pallas=False)")
    kw = {"use_pallas": False}
    if hasattr(hp, "use_fused_loss"):
        kw["use_fused_loss"] = False
    return dataclasses.replace(hp, **kw)


def eval_depths(info: dict, n_samples: int, seed: int, device) -> torch.Tensor:
    """The eval's fixed jittered depth grid as the JAX trainer draws it:
    ``stratify_depths(PRNGKey(seed), linspace(near, far, n_samples))``."""
    return stratify_depths(
        linspace_depths(info["near_thresh"], info["far_thresh"], n_samples, device=device),
        t_rand=torch.from_numpy(prng.uniform(prng.key(seed), (n_samples,))).to(device))


def _variance_ray_split(rays: np.ndarray, var_sample_thre: float):
    var_ids = np.argwhere(rays[:, -1, 0] > 1.0 + var_sample_thre / 100.0).flatten()
    non_var_ids = np.setxor1d(var_ids, np.arange(rays.shape[0]))
    return var_ids.astype(np.int64), non_var_ids.astype(np.int64)


def _view_tensors(frame, info, device) -> dict:
    w, h = (int(v) for v in info["nDetector"])
    origins, dirs = detector_rays(frame["theta"], frame["phi"], frame["larm"], info,
                                  device=device)
    img = denormalize_image(np.load(frame["file_path"]), w, h, frame["img_min_max"])
    view = {
        "origins": origins.reshape(-1, 3).contiguous(),
        "directions": dirs.reshape(-1, 3).contiguous(),
        "phases": torch.full((w * h,), frame["heart_phase"], dtype=torch.int32, device=device),
        "image": torch.as_tensor(img.reshape(-1).astype(np.float32), device=device),
        "shape": (w, h),
    }
    dyn_path = frame["file_path"].replace(".npy", "-dyn.npy")
    if os.path.isfile(dyn_path):
        view["dyn_gt"] = np.load(dyn_path).reshape((w, h)).T.astype(np.float32)
    return view


def _chunk_size(args) -> int:
    chunk = args.steps_per_chunk or 100
    chunk = max(1, min(chunk, args.display_every))
    while args.display_every % chunk != 0:
        chunk -= 1
    return chunk


def _init_composite_state(args, cfgs, tx, device) -> TrainState:
    """A fresh state, drawn as the JAX trainer draws it from ``--seed``
    (``ops/prng.py``): the coarse params from the first two of eight keys,
    the fine pair's (with the fine pass) from the next two, the step's key
    the last, zero Adam moments. ``tx`` is the optimizer the
    state is for; the port's Adam state does not depend on its settings."""
    keys = prng.split(prng.key(args.seed), 8)
    params = {"static": init_static_field(keys[0], cfgs["static"], device),
              "temp": init_temporal_field(keys[1], cfgs["temp"], device)}
    if "static_fine" in cfgs:
        params["static_fine"] = init_static_field(keys[2], cfgs["static_fine"], device)
        params["temp_fine"] = init_temporal_field(keys[3], cfgs["temp_fine"], device)
    return TrainState(params=params, opt_state=init_opt_state(params), step=0, rng=keys[7])


def prepare_composite(args, device: torch.device, mesh=None) -> dict:
    """Dataset, device arrays, state (restored with ``--resume_from``) and
    the step function. ``mesh``: a ``DeviceMesh`` with a ``'data'`` axis
    for data-parallel training (``parallel/mesh.py``), as JAX's
    ``prepare_composite(args, mesh)``: every rank runs this with the same
    arguments (the dataset is built once, by the first rank), draws the same
    state from ``--seed`` and trains with the mesh-aware step, on every
    branch (K3's sharded entry, or K1/K2 or the plain fields with the fine
    pass, ``make_composite_train_step``)."""
    paths = dataset_paths(args, args.data_root)
    first = mesh is None or torch.distributed.get_rank() == int(mesh.mesh.flatten()[0])
    if first and (not os.path.isfile(paths.general) or not os.path.isfile(paths.train)
                  or args.regenerate_data or args.only_prepare_data):
        build_dataset(args, args.data_root, device=device)
    if mesh is not None:
        torch.distributed.barrier()
    sel = parse_selection_views(args.selection_view)
    data = load_dataset(paths, args.weighted_loss_max, use_weighting=True,
                        n_test_frames=len(sel) if sel else 1)
    info = data.info
    max_pixel_value = info["max_pixel_value"]

    var_ids, non_var_ids = _variance_ray_split(data.rays, args.var_sample_thre)
    hp = composite_hparams_from_args(args)
    if hp.nb_var_rays > 0 and len(var_ids) == 0:
        hp = dataclasses.replace(hp, nb_var_rays=0)
    if args.ray_jitter_perc > 0:
        pix_angle = float(info["dDetector"][0]) / float(info["DSD"])
        hp = dataclasses.replace(hp, ray_jitter=float(args.ray_jitter_perc) * pix_angle)
    cfgs = field_configs_from_args(args)
    hp = resolve_pallas_support(hp, cfgs)
    tx = make_optimizer(args.lr, args.lr_end_factor, args.lr_decay_steps,
                        weight_decay=args.weight_decay)
    state = _init_composite_state(args, cfgs, tx, device)
    if args.resume_from:
        state = load_checkpoint(args.resume_from, state)
    depth_values = linspace_depths(info["near_thresh"], info["far_thresh"],
                                   args.depth_samples_per_ray_coarse, device=device)
    train_step = make_composite_train_step(cfgs, hp, tx, depth_values, max_pixel_value,
                                           mesh=mesh)

    hull = hull_from_args(args, data.train_frames, info, device=device)
    if args.use_motion_hull:
        if hull is None:
            print("use_motion_hull: no variance maps on disk — training ungated "
                  "(partial cardiac cycles ship unit weights)")
        else:
            frac = float((hull.grid > 0.5).float().mean())
            print(f"motion hull carved: res={hull.grid.shape[0]} occupied={frac:.4f}")

    device_data = _device_data(data, var_ids, non_var_ids, device)
    test_views = [_view_tensors(f, info, device) for f in data.test_frames]
    return {"device_data": device_data, "state": state, "cfgs": cfgs, "hp": hp, "tx": tx,
            "train_step": train_step, "depth_values": depth_values, "hull": hull,
            "max_pixel_value": max_pixel_value, "test_views": test_views,
            "chunk_size": _chunk_size(args), "info": info}


def _device_data(data, var_ids, non_var_ids, device) -> dict:
    """The ray table, phases and the two id sets on ``device`` (an empty id
    set as one zero id, as the JAX trainer passes it)."""
    def ids(a):
        return torch.as_tensor(a if len(a) else np.zeros(1, np.int64), device=device)

    return {"rays": torch.as_tensor(data.rays, device=device),
            "phases": torch.as_tensor(data.phases, device=device),
            "var_ids": ids(var_ids), "non_var_ids": ids(non_var_ids)}


def _run_chunk(train_step, state, dd, n_now: int, hull=None) -> dict:
    """``n_now`` steps; per-step metrics come back to the host once."""
    per_step = [train_step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"],
                           hull=hull)
                for _ in range(n_now)]
    keys = list(per_step[0])
    tensor_keys = [k for k in keys if isinstance(per_step[0][k], torch.Tensor)]
    out = {k: np.asarray([m[k] for m in per_step], dtype=np.float64)
           for k in keys if k not in tensor_keys}
    if tensor_keys:
        with span("nerfca.train.readback"):
            stacked = torch.stack([torch.stack([m[k].float() for m in per_step])
                                   for k in tensor_keys]).cpu().numpy()
        out.update({k: stacked[i] for i, k in enumerate(tensor_keys)})
    return out


def selection_metric(last_eval: dict, best_metric: str, sep_corr_threshold: float):
    """The scalar checkpoint-best retention keys on (and the patience stop
    watches): the selection-view image PSNR, with checkpoints whose
    selection-view ``dyn_corr`` is below ``sep_corr_threshold`` docked 1000
    under ``best_metric == "separated_psnr"`` (PSNRs live in [0, ~50], so
    the two tiers never interleave). None before the first eval."""
    metric = last_eval.get("test_image_psnr")
    if metric is not None and best_metric == "separated_psnr":
        corr = last_eval.get("test_dyn_corr")
        if corr is not None and corr < sep_corr_threshold:
            metric = metric - 1000.0
    return metric


def _chunked_train_loop(args, logger, log_dir, state, dd, train_step, chunk: int,
                        n_total: int, *, eval_fn=None, save_fn=None, early_stop_fn=None,
                        hull=None):
    """Run chunks of steps to ``n_total``: per-step logging at ``log_every``
    granularity, the optional early stop, the non-finite abort, the eval at
    ``display_every`` boundaries (an ``eval_fn`` returning True stops the
    run), checkpoints at ``save_every`` boundaries, at a stop and at the
    end, and the ``--profile_steps`` window of ``torch.profiler`` from the
    first chunk (``utils/profiling.py::trace``), its trace under
    ``<log_dir>/profile``. ``train_time``
    excludes the eval and the save (the JAX loop's includes them)."""
    start_step = state.step
    stop = False
    loop_info = {"diverged_at": None, "diverged_terms": None}
    profile_left = args.profile_steps
    window = contextlib.ExitStack()
    prof = None
    if profile_left > 0:
        prof = window.enter_context(trace(os.path.join(log_dir, "profile")))
    t_start = time.time()
    step = start_step
    while step < n_total and not stop:
        n_now = min(chunk, n_total - step)
        metrics = _run_chunk(train_step, state, dd, n_now, hull=hull)
        chunk_time = time.time() - t_start
        for i in range(n_now):
            if (step + i) % args.log_every == 0:
                rec = {k: v[i] for k, v in metrics.items()}
                rec["train_time"] = chunk_time / n_now
                logger.log(rec, step=step + i)
        if early_stop_fn is not None:
            stop = early_stop_fn(metrics, step, n_now)
        # non-finite abort: a diverged run never recovers
        if not np.isfinite(metrics["train_loss"]).all():
            first_bad = int(np.argmax(~np.isfinite(metrics["train_loss"])))
            loop_info["diverged_at"] = step + first_bad
            loop_info["diverged_terms"] = sorted(k for k, v in metrics.items()
                                                 if not np.isfinite(v[first_bad]))
            print(f"ABORT at step {step + first_bad}: non-finite train_loss "
                  f"(non-finite terms: {loop_info['diverged_terms']})")
            stop = True
        step += n_now
        if prof is not None and step - start_step >= profile_left:
            _close_trace(window, prof, start_step, step)
            prof = None
        if eval_fn is not None and (step % args.display_every == 0 or stop):
            # an eval_fn may request a stop (metric-patience early stop); the
            # save below then still fires, capturing the final state
            if eval_fn(state, step) and not stop:
                print(f"Early stop at step {step}: eval patience exhausted")
                stop = True
        if save_fn is not None and (step % args.save_every == 0 or stop or step >= n_total):
            save_fn(state, step)
        t_start = time.time()
    if prof is not None:  # the run ended inside the window
        _close_trace(window, prof, start_step, step)
    loop_info["final_step"] = step
    return state, loop_info


def _close_trace(window: contextlib.ExitStack, prof, start: int, end: int) -> None:
    """Close the ``--profile_steps`` window: its trace is written as
    ``steps-<start>-<end>.json``."""
    prof.name = f"steps-{start}-{end}.json"
    window.close()


def train_composite(args=None, argv=None, max_steps: Optional[int] = None) -> dict:
    """The ``run_composite`` entry point. Returns the final state + summary."""
    if args is None:
        args = parse_args(argv)
    device = resolve_device(args.platform)
    log_dir = make_log_dir(args.log_dir_root, args.data_name, "-composite")
    logger = MetricsLogger(log_dir, use_wandb=args.use_wandb, config=vars(args))
    setup = prepare_composite(args, device)
    hp, cfgs = setup["hp"], setup["cfgs"]
    test_views = setup["test_views"]
    # the reference jitters the eval depths once before the loop, the fine
    # pair's grid too when the hierarchy is on
    info = setup["info"]
    test_depths = eval_depths(info, args.depth_samples_per_ray_coarse, args.seed + 1, device)
    test_depths_fine = None
    if args.depth_samples_per_ray_fine > 0:
        test_depths_fine = eval_depths(info, args.depth_samples_per_ray_fine, args.seed + 2,
                                       device)
    n_total = (max_steps if max_steps is not None else args.n_iters) + 1

    def early_stop_fn(metrics, step, n_now):
        # early stop (run_composite.py:310-312)
        hit = (((metrics["train_d_entropy_loss"] < EARLY_STOP_EPS)
                | (metrics["train_favor_s_loss"] < EARLY_STOP_EPS))
               & (np.arange(step, step + n_now) >= args.static_pos_enc_window_decay_steps))
        if hit.any():
            print(f"Early stop at step {step + int(np.argmax(hit))}")
            return True
        return False

    last_eval: dict = {}  # feeds best-by-metric checkpoint retention
    best_seen = [float("-inf"), 0]  # [best selection metric, stale evals]

    def _selection_metric():
        return selection_metric(last_eval, args.best_metric, args.sep_corr_threshold)

    def eval_view(state, view, step):
        render = evaluation.render_test_view(
            state.params, view["origins"], view["directions"], view["phases"], test_depths,
            step, cfgs, hp, setup["max_pixel_value"], depth_values_fine=test_depths_fine,
            hull=setup["hull"])
        tm = evaluation.test_metrics(render, view["image"], step, hp, img_shape=view["shape"])
        if "dyn_gt" in view:
            wv, hv = view["shape"]
            pred_dyn = setup["max_pixel_value"] - render["pix_temp"].cpu().numpy().reshape(wv, hv)
            tm["test_dyn_psnr"] = evaluation.image_psnr(pred_dyn, view["dyn_gt"])
            tm["test_dyn_corr"] = evaluation.pearson_corr(pred_dyn, view["dyn_gt"])
        return render, tm

    def eval_fn(state, step):
        render, tm = eval_view(state, test_views[0], step)
        if len(test_views) > 1:
            tms = [tm] + [eval_view(state, v, step)[1] for v in test_views[1:]]
            tm = {k: float(np.mean([t[k] for t in tms])) for k in tms[0]
                  if all(k in t for t in tms)}
            tm["step"] = step  # as nerfca_tpu/train/trainer.py records it
            for i, t in enumerate(tms):
                for key in ("test_image_psnr", "test_dyn_corr"):
                    if key in t:
                        tm[f"{key}_sel{i}"] = t[key]
        last_eval.update(tm)
        logger.log(tm, step=step)
        view = test_views[0]
        w, h = view["shape"]
        norm = evaluation.normalize01
        gt = view["image"].cpu().numpy().reshape(w, h)
        pred = render["pix"].cpu().numpy().reshape(w, h)
        logger.log_images({
            "prediction_coarse": norm(pred), "original_coarse": norm(gt),
            "difference_coarse": np.abs(norm(pred) - norm(gt)),
            "dynamic_coarse": norm(render["pix_temp"].cpu().numpy().reshape(w, h)),
            "static_coarse": norm(render["pix_static"].cpu().numpy().reshape(w, h)),
        }, step)
        print(f"step {step}: test_loss={tm['test_loss']:.6f} "
              f"test_psnr={tm['test_psnr']:.3f} image_psnr={tm['test_image_psnr']:.3f}")
        if args.early_stop_patience > 0:
            metric = _selection_metric()
            if metric is not None and metric > best_seen[0]:
                best_seen[0], best_seen[1] = metric, 0
            else:
                best_seen[1] += 1
            # under checkpoint-best retention, post-peak steps are waste at
            # the 4-view operating point (memorization collapse)
            return best_seen[1] >= args.early_stop_patience
        return False

    ckpt_mgr = CheckpointManager(log_dir, keep_last_n=args.keep_last_n_checkpoints)

    def save_fn(state, step):
        ckpt_mgr.save(state, cfgs, run_metadata={
            "data_name": args.data_name,
            "step": int(state.step),
            # the hull gate is part of the model: offline eval rebuilds it
            # from this record, not from its own CLI defaults
            "hull": hull_args_record(args),
        }, metric=_selection_metric())

    state, loop_info = _chunked_train_loop(
        args, logger, log_dir, setup["state"], setup["device_data"], setup["train_step"],
        setup["chunk_size"], n_total, eval_fn=eval_fn if test_views else None,
        save_fn=save_fn, early_stop_fn=early_stop_fn, hull=setup["hull"])
    logger.close()
    return {"state": state, "log_dir": log_dir, "setup": setup,
            "diverged_at": loop_info["diverged_at"],
            "diverged_terms": loop_info["diverged_terms"],
            "final_step": loop_info["final_step"], "last_eval": last_eval}


def train_static(args=None, argv=None, max_steps: Optional[int] = None) -> dict:
    """The ``run_nerf`` entry point: one static field on one cardiac phase
    (``nerfca_tpu/train/trainer.py:720-847``). Returns the final state and
    a summary, with the run's ``setup``."""
    if args is None:
        args = parse_args(argv)
    device = resolve_device(args.platform)
    # the static method forces a single phase (run_nerf.py:61)
    args.data_time_range_end = args.data_time_range_start + 1
    log_dir = make_log_dir(args.log_dir_root, args.data_name, "-static")
    logger = MetricsLogger(log_dir, use_wandb=args.use_wandb, config=vars(args))

    paths = dataset_paths(args, args.data_root)
    if (not os.path.isfile(paths.general) or not os.path.isfile(paths.train)
            or args.regenerate_data):
        build_dataset(args, args.data_root, device=device)
    data = load_dataset(paths, args.weighted_loss_max, use_weighting=args.var_sample_perc > 0)
    info = data.info
    max_pixel_value = info["max_pixel_value"]

    var_ids, non_var_ids = _variance_ray_split(data.rays, args.var_sample_thre)
    hp = static_hparams_from_args(args)
    if hp.nb_var_rays > 0 and len(var_ids) == 0:
        hp = dataclasses.replace(hp, nb_var_rays=0)
    cfg = static_config_from_args(args)
    if cfg.pos_enc == "hashgrid":
        cfg = dataclasses.replace(cfg, hash_bound=volume_half_extent(info))
    hp = resolve_pallas_support(hp, cfg)
    tx = make_optimizer(args.lr, args.lr_end_factor, args.lr_decay_steps,
                        weight_decay=args.weight_decay)
    # the params are drawn from the seed's key itself, and that key is the
    # first step's (the composite trainer splits it first)
    key = prng.key(args.seed)
    params = {"static": init_static_field(key, cfg, device)}
    state = TrainState(params=params, opt_state=init_opt_state(params), step=0, rng=key)
    if args.resume_from:
        state = load_checkpoint(args.resume_from, state)
    depth_values = linspace_depths(info["near_thresh"], info["far_thresh"],
                                   args.depth_samples_per_ray_coarse, device=device)
    train_step = make_static_train_step(cfg, hp, tx, depth_values, max_pixel_value)

    device_data = _device_data(data, var_ids, non_var_ids, device)
    # key selection on the first test frame only (reference behavior)
    test_view = _view_tensors(data.test_frames[0], info, device) if data.test_frames else None
    test_depths = eval_depths(info, args.depth_samples_per_ray_coarse, args.seed + 1, device)
    n_total = (max_steps if max_steps is not None else args.n_iters) + 1
    last_eval: dict = {}  # feeds best-by-metric checkpoint retention

    def eval_fn(state, step):
        # in-loop test render (run_nerf.py:254-287), through the eval's
        # renderer with the static field alone
        render = evaluation.render_test_view(
            state.params, test_view["origins"], test_view["directions"], None, test_depths,
            step, {"static": cfg}, hp, max_pixel_value)
        w, h = test_view["shape"]
        gt = test_view["image"].cpu().numpy()
        pred = render["pix_static"].cpu().numpy()
        pixel_loss = float(np.mean((pred - gt) ** 2))
        tm = {"test_pixel_loss": pixel_loss,
              "test_psnr": float(-10 * np.log10(pixel_loss)) if pixel_loss > 0 else float("inf"),
              "test_image_psnr": evaluation.image_psnr(pred.reshape(w, h), gt.reshape(w, h))}
        last_eval.update(tm)
        logger.log(tm, step=step)
        norm = evaluation.normalize01
        logger.log_images({
            "prediction": norm(pred.reshape(w, h)), "original": norm(gt.reshape(w, h)),
            "difference": np.abs(norm(pred.reshape(w, h)) - norm(gt.reshape(w, h))),
        }, step)
        print(f"step {step}: test_psnr={tm['test_psnr']:.3f}")

    ckpt_mgr = CheckpointManager(log_dir, keep_last_n=args.keep_last_n_checkpoints)

    def save_fn(state, step):
        ckpt_mgr.save(state, {"static": cfg},
                      run_metadata={"data_name": args.data_name, "step": int(state.step)},
                      metric=last_eval.get("test_image_psnr"))

    state, loop_info = _chunked_train_loop(
        args, logger, log_dir, state, device_data, train_step, _chunk_size(args), n_total,
        eval_fn=eval_fn if test_view is not None else None, save_fn=save_fn)
    logger.close()
    setup = {"device_data": device_data, "cfg": cfg, "hp": hp, "tx": tx,
             "depth_values": depth_values, "test_depths": test_depths,
             "max_pixel_value": max_pixel_value, "test_view": test_view}
    return {"state": state, "log_dir": log_dir, "setup": setup,
            "diverged_at": loop_info["diverged_at"],
            "diverged_terms": loop_info["diverged_terms"],
            "final_step": loop_info["final_step"], "last_eval": last_eval}
