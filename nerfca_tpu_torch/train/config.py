"""Config/flag surface (port of ``nerfca_tpu/train/config.py``): the same
flags, so every ``configs/*.txt`` parses unchanged.

Reference parity: ``train/data_helpers.py:10-127`` (``config_parser``). The
flag NAMES and the ``.txt`` config-file format are preserved verbatim so
existing reference configs (``train/composite.txt``, ``train/3d.txt``) drive
this framework unchanged. configargparse is not available in this image, so
a small compatible layer reads ``key = value`` txt files and feeds them as
argparse defaults; CLI flags still override file values, and ``--config``
picks the file — the same precedence configargparse implements.

Booleans accept any case of true/false (the reference's
``lambda x: str(x).lower() == 'true'`` idiom).
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Optional, Sequence


# flags the JAX package's parser lacks, with their defaults
PORT_ONLY_FLAGS = {"static_hidden_activation": "relu"}


def _bool(x) -> bool:
    return str(x).lower() == "true"


def _maybe(type_fn):
    """Typed parser that maps the literal strings 'none'/'null'/'' to None."""

    def parse(x):
        if isinstance(x, str) and x.strip().lower() in ("none", "null", ""):
            return None
        return type_fn(x)

    return parse


def read_config_file(path: str) -> dict[str, str]:
    """Parse a configargparse-style ``key = value`` txt file."""
    values: dict[str, str] = {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            values[key.strip()] = val.strip().strip("'\"")
    return values


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="nerfca_tpu_torch — NeRF-CA training on PyTorch/CUDA",
        fromfile_prefix_chars=None,
    )
    p.add_argument("--config", type=str, default=None, help="config txt file path")
    p.add_argument("--wandb_sweep_yaml", type=str, default=None)
    p.add_argument("--use_wandb", type=_bool, default=False)

    # general run info
    p.add_argument("--data_name", type=str, default="SYNTH")
    p.add_argument("--x_ray_type", type=str, default="roadmap")
    p.add_argument("--take_mask", type=_bool, default=False)
    p.add_argument("--data_size", type=int, default=50)

    # data args
    p.add_argument("--use_experiment_name", type=_bool, default=False)
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--data_limited_range", type=float, default=60.0)
    p.add_argument("--data_step_size", type=float, default=120.0)
    p.add_argument("--data_numb_angles", type=_maybe(int), default=None)
    p.add_argument("--data_time_range_start", type=int, default=0)
    p.add_argument("--data_time_range_end", type=int, default=10)
    p.add_argument("--data_limited_range_test", type=_maybe(float), default=None)
    p.add_argument("--data_step_size_test", type=_maybe(float), default=None)
    p.add_argument(
        "--selection_view", type=_maybe(str), default=None,
        help="'theta,phi' (or 't1,p1;t2,p2;...' for multi-view selection) "
        "of dedicated model-selection test view(s); they are placed FIRST "
        "in test-*.json (the in-loop metric / checkpoint-best selection is "
        "their MEAN) and excluded from evaluate.json so reported held-out "
        "means stay disjoint from model selection (no reference analog). "
        "For a negative theta use the = form (--selection_view=-30,0): "
        "argparse treats a leading '-' in a separate token as an option "
        "string",
    )

    p.add_argument("--only_prepare_data", type=_bool, default=False)
    p.add_argument("--debug_mode", type=_bool, default=False)
    p.add_argument("--visualize_geometry", type=_bool, default=False)

    # run info
    p.add_argument("--n_iters", type=int, default=200000)
    p.add_argument("--display_every", type=int, default=500)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--batch_size", type=int, default=32768)

    # models
    p.add_argument("--num_input_channels", type=int, default=3)
    p.add_argument("--num_output_channels", type=int, default=1)
    p.add_argument("--temp_num_early_layers", type=int, default=4)
    p.add_argument("--temp_num_late_layers", type=int, default=0)
    p.add_argument("--temp_num_filters", type=int, default=32)
    p.add_argument("--temp_num_filters_fine", type=int, default=32)
    p.add_argument("--static_num_early_layers", type=int, default=4)
    p.add_argument("--static_num_late_layers", type=int, default=0)
    p.add_argument("--static_num_filters", type=int, default=32)
    p.add_argument("--static_num_filters_fine", type=int, default=32)
    p.add_argument("--output_activation", type=str, default="Softplus")

    # nerf parameters
    p.add_argument("--depth_samples_per_ray_coarse", type=int, default=500)
    p.add_argument("--depth_samples_per_ray_fine", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_end_factor", type=float, default=0.1)
    p.add_argument("--lr_decay_steps", type=int, default=100000)
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="decoupled AdamW decay on MLP weight matrices "
                        "only (the w leaves; biases and latents exempt), "
                        "as optax.adamw with the JAX package's mask "
                        "(framework extension, default off = exact "
                        "reference Adam); counters 4-view memorization "
                        "once the encoding window opens")

    p.add_argument("--sample_mode", type=str, default="pixel")
    p.add_argument("--sample_weights_name", type=str, default=None)
    p.add_argument("--img_sample_size", type=int, default=64**2)
    p.add_argument("--var_sample_perc", type=float, default=0.0)
    p.add_argument("--var_sample_thre", type=float, default=0.0)
    p.add_argument("--raw_noise_std", type=float, default=0.0)

    # positional encoding (temporal field)
    p.add_argument("--temp_pos_enc", type=str, default="free_windowed")
    p.add_argument("--temp_pos_enc_basis", type=int, default=12)
    p.add_argument("--temp_pos_enc_fourier_sigma", type=float, default=0.0)
    p.add_argument("--temp_pos_enc_window_start", type=int, default=0)
    p.add_argument("--temp_pos_enc_window_decay_steps", type=int, default=150000)
    # cap the annealing pointer at this band count (0 = reference behavior,
    # fully open after decay); anti-memorization control for sparse views
    p.add_argument("--temp_pos_enc_window_max", type=float, default=0.0)

    # positional encoding (static field)
    p.add_argument("--static_pos_enc", type=str, default="free_windowed")
    p.add_argument("--static_pos_enc_basis", type=int, default=12)
    p.add_argument("--static_pos_enc_fourier_sigma", type=float, default=0.0)
    p.add_argument("--static_pos_enc_window_start", type=int, default=0)
    p.add_argument("--static_pos_enc_window_decay_steps", type=int, default=150000)
    p.add_argument("--static_pos_enc_window_max", type=float, default=0.0)
    # the port's own (the JAX package has neither): 'relu' or 'leaky_relu'
    # (NAF's field, with --static_pos_enc hashgrid; configs/naf.txt)
    p.add_argument("--static_hidden_activation", type=str, default="relu")

    # positional encoding windowing
    p.add_argument("--window_weight_start", type=int, default=0)
    p.add_argument("--window_weight_end", type=int, default=10)
    p.add_argument("--window_decay_steps", type=int, default=100000)

    # time latents
    p.add_argument("--use_time_latents", type=_bool, default=True)
    p.add_argument("--num_time_dim", type=int, default=8)

    # D2NeRF-style separation parameters
    p.add_argument("--skewness_val", type=float, default=1.0)
    p.add_argument("--favor_s_weight_start", type=float, default=0.0)
    p.add_argument("--favor_s_weight_end", type=float, default=0.0)
    p.add_argument("--favor_s_weight_delay_steps", type=int, default=0)
    p.add_argument("--dynamic_entro_weight_start", type=float, default=0.0)
    p.add_argument("--dynamic_entro_weight_end", type=float, default=0.0)
    p.add_argument("--occl_weight_start", type=float, default=0.0)
    p.add_argument("--occl_weight_end", type=float, default=0.0)
    p.add_argument("--l1_weight_start", type=float, default=0.0)
    p.add_argument("--l1_weight_end", type=float, default=0.0)
    p.add_argument("--hull_static_l1_weight_start", type=float, default=0.0,
                   help="hull-gated static L1 schedule start (framework "
                        "extension; penalizes static density inside the "
                        "motion hull so low-contrast vessel mass lands in "
                        "the dynamic field; requires --use_motion_hull)")
    p.add_argument("--hull_static_l1_weight_end", type=float, default=0.0)
    p.add_argument("--static_tv_weight_start", type=float, default=0.0,
                   help="along-ray total-variation schedule start on the "
                        "static field (framework extension; the sparse-"
                        "view-CT smoothness prior against 4-view "
                        "memorization speckle). Non-zero weights run on "
                        "the XLA path (fused kernel falls back).")
    p.add_argument("--static_tv_weight_end", type=float, default=0.0)
    p.add_argument("--hyperparam_decay_steps", type=int, default=100000)

    p.add_argument("--entro_mask_thre", type=float, default=1e-4)
    p.add_argument("--entro_clip_threshold", type=float, default=1e-19,
                   help="floor of the entropy normalization sum; raise to "
                        "~1e-6 when sweeping real entropy weights (the "
                        "reference default explodes, see ops/losses.py)")
    p.add_argument("--entro_use_weighting", type=_bool, default=False)
    p.add_argument("--entro_weighted_thresh", type=float, default=0.0)
    p.add_argument("--occl_reg_perc", type=float, default=0.1)
    p.add_argument("--occl_front_only", type=_bool, default=False,
                   help="apply the occlusion loss to the near-camera "
                        "occl_reg_perc of each ray only (the reference "
                        "comment's intent); default keeps the reference "
                        "code's use_back=False FULL-RAY quirk, which "
                        "taxes all dynamic density (see ops/losses.py)")

    p.add_argument("--weighted_loss_max", type=float, default=1.0)
    p.add_argument("--weighted_loss", type=str, default="None")
    p.add_argument("--favor_s_opt", type=str, default=None)
    p.add_argument("--favor_s_opt_weight", type=float, default=0.0)

    # --- framework extensions (absent in the reference) ---
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="matmul dtype for field MLPs: float32 | bfloat16 "
                        "(bf16 operands, f32 sums; the kernels' bf16 "
                        "mma.sync with --use_pallas, except the static "
                        "method's kernel branch, which stays f32 as in JAX)")
    p.add_argument("--mesh_shape", type=str, default=None,
                   help="accepted for config compatibility: the CLIs train on one card "
                        "and the port ignores it, as the JAX package does; data "
                        "parallelism is prepare_composite(args, device, mesh) with a "
                        "parallel.make_mesh mesh")
    p.add_argument("--use_pallas", type=_bool, default=False,
                   help="run both fields through the CUDA field kernels "
                        "(K1 forward, K2 backward)")
    p.add_argument("--pallas_tile", type=int, default=1024,
                   help="accepted for config compatibility; the CUDA "
                        "kernels use a fixed tile")
    p.add_argument("--use_fused_loss", type=_bool, default=False,
                   help="monolithic Pallas train-gradient kernel (render + "
                        "losses + backprop in one pass; coarse path only)")
    p.add_argument("--static_freeze_step", type=int, default=0,
                   help="freeze the static field's parameters from this "
                        "step on (0 = never); the dynamic field keeps "
                        "training — two-timescale sparse-view control")
    p.add_argument("--early_stop_patience", type=int, default=0,
                   help="stop when the selection metric (best_metric) has "
                        "not improved for this many in-loop evals (0 = "
                        "off); a final checkpoint is still saved")
    p.add_argument("--ray_jitter_perc", type=float, default=0.0,
                   help="sub-pixel ray jitter as a fraction of the pixel "
                        "footprint (1.0 = full pixel cone); anti-"
                        "memorization control for extreme-sparse views")
    p.add_argument("--pallas_vmem_mb", type=int, default=0,
                   help="accepted for config compatibility (TPU knob)")
    p.add_argument("--pallas_bf16_residuals", type=_bool, default=False,
                   help="bf16 residual storage in the fused-loss step: K2 "
                        "stores the post-ReLU activations as bf16 (half the "
                        "scratch) while the forward and the loss stay f32; "
                        "no effect under --compute_dtype bfloat16")
    p.add_argument("--steps_per_chunk", type=int, default=None,
                   help="train steps between metric read-backs "
                        "(default 100, clamped to divide display_every)")
    p.add_argument("--resume_from", type=str, default=None,
                   help="checkpoint directory to resume training from")
    p.add_argument("--keep_last_n_checkpoints", type=int, default=3,
                   help="rolling checkpoint history size (the best-by-"
                        "metric checkpoint is always retained)")
    p.add_argument("--volume_root", type=str, default=None,
                   help="directory with <phase>/full_volume_tigre.npy volumes (and "
                        "<phase>/dyn_volume_tigre.npy artery-only volumes), each read "
                        "ahead of the SYNTH phantom when it exists")
    p.add_argument("--synth_vol_size", type=int, default=64)
    p.add_argument("--synth_lca_val", type=float, default=1.2,
                   help="SYNTH phantom vessel attenuation (contrast agent)")
    p.add_argument("--synth_vessel_radius", type=float, default=0.045,
                   help="SYNTH phantom vessel radius in [-1,1] volume units")
    p.add_argument("--synth_motion_scale", type=float, default=1.0,
                   help="SYNTH phantom cardiac-motion amplitude multiplier")
    p.add_argument("--synth_vessel_extent", type=float, default=1.0,
                   help="SYNTH vessel centerline scale toward the "
                        "isocenter; <= ~0.22 keeps the full moving vessel "
                        "inside every view's frustum (at 1.0 the imaged "
                        "FOV covers only the central fraction and one "
                        "grid view sees no vessel — see data/phantom.py)")
    p.add_argument("--synth_rib_scale", type=float, default=1.0,
                   help="SYNTH phantom rib/sternum amplitude multiplier "
                        "(<1 softens the thin high-frequency background "
                        "bone that caps 4-view reconstruction)")
    p.add_argument("--synth_smooth_sigma", type=float, default=1.0,
                   help="SYNTH phantom Gaussian smoothing sigma (voxels)")
    p.add_argument("--use_motion_hull", type=_bool, default=False,
                   help="gate the dynamic field's density with a 3-D "
                        "occupancy grid space-carved from the training "
                        "views' temporal-variance maps (ops/hull.py): "
                        "dynamic mass can only live where every training "
                        "view sees motion")
    p.add_argument("--hull_res", type=int, default=96,
                   help="motion-hull grid resolution per axis")
    p.add_argument("--hull_thresh", type=float, default=0.02,
                   help="normalized-variance threshold for hull carving")
    p.add_argument("--hull_dilate", type=int, default=3,
                   help="binary-dilation iterations on the carved hull")
    p.add_argument("--hull_sigma", type=float, default=1.0,
                   help="Gaussian smoothing sigma (hull voxels) on the gate")
    p.add_argument("--best_metric", type=str, default="image_psnr",
                   choices=["image_psnr", "separated_psnr"],
                   help="checkpoint-best selection metric: image_psnr = "
                        "selection-view PSNR; separated_psnr = same, but "
                        "checkpoints whose selection-view dyn_corr >= "
                        "--sep_corr_threshold always dominate ones below it")
    p.add_argument("--sep_corr_threshold", type=float, default=0.5,
                   help="dyn_corr gate for --best_metric separated_psnr")
    p.add_argument("--log_dir_root", type=str, default="cases")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace for the first N steps "
                        "(under <log_dir>/profile)")
    p.add_argument("--render_views", type=str, default="",
                   help="semicolon-separated theta,phi,phase triplets (run_render)")
    p.add_argument("--render_spin", type=int, default=0,
                   help="render N cine views sweeping theta (run_render)")
    p.add_argument("--regenerate_data", type=_bool, default=False,
                   help="rebuild the dataset even when artifacts exist "
                        "(the reference regenerates unconditionally)")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="torch device: 'cuda' (default; raises when no GPU "
                        "is present) or 'cpu' (only when asked for)")
    return p


def parse_args(
    argv: Optional[Sequence[str]] = None, default_config: Optional[str] = None
):
    """Parse CLI args with config-file defaults (configargparse semantics)."""
    parser = build_parser()

    # first pass: find --config (without triggering required-arg errors)
    pre, _ = parser.parse_known_args(argv)
    config_path = pre.config or default_config
    if config_path and os.path.isfile(config_path):
        file_values = read_config_file(config_path)
        known = {a.dest: a for a in parser._actions}
        defaults = {}
        for key, val in file_values.items():
            if key in known and known[key].type is not None:
                defaults[key] = known[key].type(val)
            elif key in known:
                defaults[key] = val
        parser.set_defaults(**defaults)

    args = parser.parse_args(argv)
    if config_path:
        args.config = config_path
    return args


def overwrite_args(run_args, overrides: dict):
    """A copy of ``run_args`` with sweep overrides applied
    (``nerfca_tpu/train/config.py:347-370``). A string value is converted
    to the numeric type of the attribute it replaces (YAML reads ``1e-10``
    as a string unless written ``1.0e-10``); a fractional value for an
    int-typed attribute raises ``ValueError`` rather than being truncated."""
    new_args = copy.deepcopy(run_args)
    for key, val in overrides.items():
        cur = getattr(new_args, key, None)
        if isinstance(val, str) and isinstance(cur, (int, float)) and not isinstance(cur, bool):
            try:
                num = float(val)
            except ValueError:
                pass  # a non-numeric string passes through as it is
            else:
                if isinstance(cur, int) and not num.is_integer():
                    raise ValueError(f"override {key}={val!r} is fractional but the attribute "
                                     f"is int-typed (current value {cur!r}); refusing lossy "
                                     f"truncation")
                val = type(cur)(num)
        setattr(new_args, key, val)
    return new_args
