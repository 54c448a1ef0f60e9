#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It runs what only the card can run end to end and what no other file
checks, and holds the kernels against their plain versions at the flagship
shapes through ``tests/test_torch_gpu.py``'s comparisons. Kernel times come
from ``scripts/k1_variants.py`` and ``scripts/k2_variants.py``, end-to-end
numbers from ``portbench/``. This script times nothing. It

1. prints the environment (torch, CUDA, the card and its power limit);
2. builds the CUDA kernels from ``nerfca_tpu_torch/csrc`` (one nvcc per
   source, started together) and prints ptxas's registers and spills and
   the kernels' shared memory;
   o. holds every kernel against its plain version or bf16 twin at the
      flagship shapes, 1024 rays of the flagship view with every band open
      (:func:`kernel_checks`): ``tests/test_torch_gpu.py``'s ``check``,
      ``check_bf16``, ``check_k3``, ``check_k3_bf16``, ``check_res_loss``
      and ``check_res_k2_change`` at 500 shared depths and, for K1/K2, at
      the fine pass's 628 per-ray depths from ``sample_pdf``; the eval's
      Beer-Lambert kernel (``check_composite_view``, ``check_composite``);
      the static method's eval (``check_static_rays``, free_windowed and
      fourier, ``check_static_view`` on its cell's 40000 x 500 view,
      ``check_eval_static`` at per-ray depths);
      prints a ``kernels`` line, each case with its shape and the launches
      it made;
3. drives the main paths through ``nerfca_tpu_torch.train.run_composite.main``
   (``run_nerf.main`` for the static method), each with the launch counts
   set to 0 just before and read just after:
   a. the two-kernel step (``configs/composite.txt --use_pallas true``):
      builds the flagship SYNTH dataset on the card, 6 train steps, one eval
      view; K1 and K2 must run in training and K1 in the eval render;
   b. the fused-loss step (``--use_fused_loss true``) on that dataset: 6
      steps and one eval view; K1, the loss kernel and K2 must run once on
      every step, K1 in the eval;
   e. the fourier composite (``configs/composite.txt`` with both fields on
      the fourier encoding, sigma 2, ``--use_fused_loss true``) on the
      flagship dataset: 6 steps and one eval, K3 once a step;
   h. bf16 compute (``--compute_dtype bfloat16``) and i. bf16 residual
      storage (``--pallas_bf16_residuals true``) through K3 on the flagship
      dataset, 6 steps and one eval view each: one K3 a step with the bf16
      K1 and K2 (10 bf16 K1 in the eval), or with K2 over bf16 residuals;
   j. the fine pass: ``configs/composite.txt`` with 128 fine samples a ray
      and a 128-wide fine pair, ``--use_fused_loss true``, on the flagship
      dataset, 10 steps and an eval: no K3 (it has no fine pass), K1 and
      K2 twice a step (the coarse pair, then the fine pair at per-ray
      depths); the step-0 loss and the step-10 PSNRs (coarse and fine)
      held against the JAX record (``JAX_FINE``) under phase d's gates;
   j'. the shipped 64-wide fine pair: 6 steps and an eval; the trainer warns
      that the fine pair lies outside the envelope, the coarse pair keeps
      K1/K2 and the fine pass runs plain;
   c. the clean-protocol reconstruction, ``configs/synth-4view-best.txt``
      (SYNTH-FOVHC at 96^3, 4 views, the motion hull, K3, ray jitter,
      selection view 0,0, ``best_metric separated_psnr``) for 1000 steps:
      finite steps with K3 on each, the in-loop evals' first view captured
      as a CUDA graph and the later ones replayed, a non-empty hull, K3 and K1 against
      their plain versions at the trained state, checkpoints 500, 1000 and
      1001 with checkpoint-best at the highest selection metric; a resume
      from checkpoint-500 whose checkpoint-1000 equals the first run's
      bitwise; ``run_eval`` of checkpoints 500 and 1000 over the 40 views of
      evaluate.json and ``run_render`` of two views of checkpoint-best;
      checkpoint-1000 must pass the quality gate (``GATE_PSNR``,
      ``GATE_DYN_CORR``), printed beside the JAX record;
   c'. after phase c, the same clean protocol once with
      ``--pallas_bf16_residuals true`` and once with ``--compute_dtype
      bfloat16`` (1000 steps each on phase c's dataset, ``run_eval`` of
      checkpoint-1000 beside the f32 run's; gated on finite values and on
      the selection view's PSNR rising from step 0);
   k. after phase c, a hyperband sweep (``configs/sweep-4view-data.yaml``'s
      grid, max_iter 9) through ``run_composite.main --wandb_sweep_yaml`` on
      ``configs/synth-4view-best.txt`` and phase c's dataset: the rung
      budgets, K3 on every step of every run, and the promoted configs
      resumed from their checkpoints;
   l. non-SYNTH data, the volumes built in the background since the first
      main path (``VolumeBuilds``): MAGIX-SURR, 10 phases of the port's
      ``write_surrogate_case`` (256 x 256 x 160 HU -> 256^3 attenuation)
      in 5 processes, its dataset built on the card with the CCTA preset,
      and ``scripts/tpu_ccta_surrogate.py::build(6000)``'s recipe at the
      flagship widths: (a) 10 K3 steps without the hull, the step-0 loss
      and step-10 PSNR held against ``JAX_MAGIX`` under phase d's gates;
      (b) 1000 K3 + hull steps, ``run_eval`` of checkpoint-1000 over the 40
      views held to ``GATE_MAGIX_PSNR`` / ``GATE_MAGIX_DYN_CORR`` and
      printed beside the JAX round-5 record; (c) the native C++ projector
      against the card's on one view (``NATIVE_ATOL``);
   l'. ``--use_experiment_name true --experiment_name one-frame-resp`` on
      those volumes: 6 K3 steps and one eval;
   m. XCAT-SURR: the XCAT driver contract at 512 x 512 x 401 through the
      port's stand-in ``dxcat1_bin`` for 2 phases (in the background), the
      XCAT preset's dataset, 6 K3 steps and one eval;
   d. the static 3-D method through ``run_nerf.main`` on ``configs/3d.txt``
      (its own one-phase 128^3 dataset, ``STATIC_STEPS`` steps): the
      one-field K1 and K2 once a step and nothing else, each eval view one
      one-field K1 on rays and one ``eval_static`` a tile, the first eval
      captured as a CUDA graph and the later ones replayed; the train loss and
      ``test_image_psnr`` at steps 0, 100, 200 beside the JAX record
      (``JAX_STATIC``), gated (``GATE_STATIC_LOSS0_REL``,
      ``GATE_STATIC_PSNR_DB``); the entries against their plain versions at
      the trained state;
   f. ``configs/3d.txt --static_pos_enc fourier`` through ``run_nerf.main``
      on phase d's dataset, ``FOURIER_STATIC_STEPS`` steps (evals at 50 and
      100, the second a replay), under phase d's gates against its own JAX
      record (``JAX_STATIC_FOURIER``);
   g. data parallelism at the flagship widths: world 1 over NCCL in this
      process (the sharded K3 entry equals K3 bitwise), then ``DP_WORLD``
      ranks over gloo on the one card in spawned processes (the sharded K3
      within K3's gate of the whole batch's and of the plain version's,
      ``DP_STEPS`` data-parallel steps with the ranks' parameters bitwise
      equal and the losses within ``LOSS_REL`` of the single-card steps);
   n. data parallelism on the autograd paths at full width, after g: world
      1 over NCCL in this process (``DP_STEPS`` mesh steps of the
      two-kernel step and of ``configs/3d.txt``'s static step equal the
      unsharded steps bitwise), then ``DP_WORLD`` ranks over gloo on the
      one card, ``DP_STEPS`` steps each of the flagship two-kernel step,
      phase j's fine pass (the batch's arg-max of the fine weights on rank
      1, global ray 0 on rank 0), the static step on its one-field kernels,
      and one step on 1023 rays, which do not split evenly: the ranks'
      parameters bitwise equal, the losses within ``LOSS_REL`` and the
      first step's gradients and the parameters after the steps within
      K2's gate of the single-card steps (the fine pass's also within the
      single card's own floor, one ulp on every parameter), K1/K2 launched
      per rank as the single-card step launches them;
4. prints the card's name and power limit, and last the result line.

It also holds the flagship inputs that ``scripts/k1_variants.py`` and
``scripts/k2_variants.py`` import (:func:`flagship_cfgs`,
:func:`flagship_params`, :func:`flagship_rays`, :func:`fine_rays`,
:func:`static_cfg`, :func:`packs`, :func:`card_line`, :func:`cuda_time_ms`,
``K1_ATOL``).

Exits non-zero, printing no result, when no CUDA device is present, when
the repository's package is not next to this script, or when any phase
fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, stated with their reasons
K1_ATOL = 2e-4   # f32 raw densities; only the matmul summation order differs
K2_REL = 2e-2    # per-leaf grads vs max(leaf scale, 1e-2 x global max), bench.py:93-116
LOSS_REL = 1e-3  # loss and each K3 term: f32 sums over rays in another order (bench.py rule)
RENDER_REL = 1e-4  # rendered intensities, of I0: integrals of K1's raw densities (each K1_ATOL)


# the clean-protocol run (phase 4c): configs/synth-4view-best.txt as
# written (SYNTH-FOVHC at 96^3, 4 views, hull, K3, ray jitter, selection
# view 0,0, best_metric separated_psnr, save_every 500), cut to 1000 steps
CLEAN_CONFIG = os.path.join(REPO, "configs", "synth-4view-best.txt")
CLEAN_STEPS = 1000
# Quality gate on checkpoint-1000's 40-view eval, set before the first run
# on the card and not moved after it: a floor for "reconstructs and
# separates", not a parity tolerance. The JAX record at step 1000 is 20.14
# dB and dyn_corr 0.973 and never falls below 16.98 dB or 0.973 from step
# 1000 to 6000 (artifacts/round5/clean_protocol_multisel.json); the two
# packages' random streams differ, and BENCH.md's seed probe moves the
# early peak by ~2 dB between seeds.
GATE_PSNR = 16.5
GATE_DYN_CORR = 0.90
# the JAX records printed beside the port's
JAX_40VIEW = os.path.join(REPO, "artifacts", "round5", "clean_protocol_multisel.json")
JAX_SELECTION = os.path.join(REPO, "artifacts", "round4", "clean_protocol", "metrics.jsonl")

# the static 3-D method (phase 4d): configs/3d.txt as written, cut to
# STATIC_STEPS steps, held against the JAX record of the same command
# (scripts/static_3d_jax_record.py: JAX's run_nerf on the CPU, plain field)
STATIC_CONFIG = os.path.join(REPO, "configs", "3d.txt")
STATIC_STEPS, STATIC_EVERY = 200, 100
JAX_STATIC = os.path.join(REPO, "artifacts", "port", "static_3d_jax-200.json")
# phase 4f: the same method with --static_pos_enc fourier (configs/3d.txt's
# sigma 2, basis 12), FOURIER_STATIC_STEPS steps, against its own JAX record
# (scripts/static_3d_jax_record.py --static_pos_enc fourier --n_iters 100),
# under phase 4d's gates; two evals, so that the second replays the
# first's CUDA graph after 50 Adam steps
FOURIER_STATIC_STEPS, FOURIER_STATIC_EVERY = 100, 50
JAX_STATIC_FOURIER = os.path.join(REPO, "artifacts", "port", "static_3d_fourier_jax-100.json")
# the fourier composite (phase 4e) and the fourier kernel checks: both
# fields of configs/composite.txt on the fourier encoding at sigma 2
FOURIER_SIGMA = 2.0
FOURIER_ARGV = ["--static_pos_enc", "fourier", "--temp_pos_enc", "fourier",
                "--static_pos_enc_fourier_sigma", "2", "--temp_pos_enc_fourier_sigma", "2"]
# data parallelism (phase 4g): two ranks over gloo on the one card, DP_STEPS
# train steps of the flagship batch and fields
DP_WORLD, DP_STEPS = 2, 3
# Gates against that record, set before the first run on the card and not
# moved after it: the step-0 train loss (same params, batch and depths;
# only K1's f32 sums differ; the composite's agreed to 1.3e-5) and the
# step-200 test_image_psnr of the first test view (200 Adam steps of f32
# rounding apart).
GATE_STATIC_LOSS0_REL = 1e-4
GATE_STATIC_PSNR_DB = 1.0
# the fine pass (phase 4j): configs/composite.txt with FINE_SAMPLES fine
# samples a ray (the classic coarse-to-fine NeRF count; the flagship sets 0)
# and a 128-wide fine pair, which takes the ray form of K1/K2 with per-ray
# depths; FINE_STEPS steps and an eval at steps 0 and FINE_STEPS, held
# against the JAX record of the same command and seed
# (scripts/composite_fine_jax_record.py, JAX's plain fields on the CPU)
# under phase 4d's gates, set before the first card run: the step-0 train
# loss and the step-FINE_STEPS test_image_psnr and test_image_psnr_fine
FINE_SAMPLES = 128
FINE_ARGV = ["--depth_samples_per_ray_fine", str(FINE_SAMPLES),
             "--static_num_filters_fine", "128", "--temp_num_filters_fine", "128"]
FINE_STEPS = 10
JAX_FINE = os.path.join(REPO, "artifacts", "port", "composite_fine_jax-10.json")
# phase 4k: configs/sweep-4view-data.yaml's 4-config grid under hyperband
# (max_iter SWEEP_MAX_ITER: rungs 1, 3, 9) on configs/synth-4view-best.txt
SWEEP_YAML = os.path.join(REPO, "configs", "sweep-4view-data.yaml")
SWEEP_MAX_ITER = 9
# phase 4l: the MAGIX (CCTA) surrogate at its native scale, MAGIX_PHASES
# phases of ccta_surrogate.write_surrogate_case (256 x 256 x 160 HU at
# (1.0, 1.0, 1.6) mm -> 256^3 attenuation) built in MAGIX_WORKERS processes
# in the background while the earlier phases run, and
# scripts/tpu_ccta_surrogate.py::build(6000)'s recipe on configs/composite.txt
# (surrogate_argv): (a) MAGIX_PARITY_STEPS steps without the hull against
# the JAX record of the same command and seed (JAX_MAGIX, made on the CPU by
# scripts/surrogate_jax_record.py) under phase 4d's gates; (b) the recipe as
# written cut to MAGIX_STEPS steps, checkpoint-1000 scored over the 40 views
# and held to a floor set before the first card run (the JAX round-5 run of
# the same recipe, JAX_MAGIX_RUN, scores 12.64 dB / dyn_corr 0.594 there);
# (c) the native C++ projector against the card's on one view, within the
# 1e-4 of tests/test_native.py
MAGIX_PHASES, MAGIX_WORKERS = 10, 5
MAGIX_SHAPE = (256, 256, 160)
MAGIX_PARITY_STEPS = 10
MAGIX_STEPS = 1000
JAX_MAGIX = os.path.join(REPO, "artifacts", "port", "magix_surrogate_jax-10.json")
JAX_MAGIX_RUN = os.path.join(REPO, "artifacts", "round5", "magix_surrogate_run-6000.json")
GATE_MAGIX_PSNR = 11.0
GATE_MAGIX_DYN_CORR = 0.50
NATIVE_ATOL = 1e-4
# phase 4l': the experiment view list configs/experiments/EXPERIMENT.json on
# phase 4l's volumes; phase 4m: XCAT-SURR through the XCAT driver contract
# (the port's stand-in generator installed as dxcat1_bin) at the real
# 512 x 512 x 401 for XCAT_PHASES phases (all ten are ~17 GB on disk), in
# the background with the MAGIX volumes
EXPERIMENT = "one-frame-resp"
XCAT_PHASES = 2
XCAT_DIMS = (512, 512, 401)
XCAT_PAR = ("0.0\thrt_start_phase_index (cardiac phase at sim start)\n"
            "0.0\tresp_start_phase_index (respiratory phase at sim start)\n"
            "1\tout_frames (number of output frames)\n")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship_cfgs(fourier: bool = False):
    """The flagship pair; with ``fourier`` both fields on the fourier
    encoding at basis 12 and sigma 2 (``FOURIER_ARGV``)."""
    from nerfca_tpu_torch.models.fields import FieldConfig

    kw = dict(num_early_layers=4, num_filters=128, pos_enc="free_windowed",
              pos_enc_basis=12, pos_enc_window_start=1, pos_enc_window_decay_steps=150000)
    if fourier:
        kw.update(pos_enc="fourier", fourier_sigma=FOURIER_SIGMA)
    return FieldConfig(**kw), FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def flagship_geometry():
    from nerfca_tpu_torch.geometry.cone import (
        SCALE_FACTOR, ConeGeometry, get_near_far, synth_geometry,
    )

    geo = ConeGeometry.from_dict(synth_geometry(200, [128, 128, 128]), SCALE_FACTOR)
    return geo.to_info_dict(), get_near_far(geo)


def flagship_rays(n_rays: int, n_samples: int, seed: int, device):
    """``n_rays`` random detector pixels of a flagship view (200x200
    detector, 128^3 SYNTH volume) with stratified depths in [near, far]."""
    import torch

    from nerfca_tpu_torch.geometry.rays import detector_rays
    from nerfca_tpu_torch.ops.sampling import linspace_depths, stratify_depths

    info, (near, far) = flagship_geometry()
    gen = torch.Generator(device=device).manual_seed(seed)
    o, d = detector_rays(-30.0, 30.0, 0.0, info, device=device)
    idx = torch.randint(0, o.shape[0] * o.shape[1], (n_rays,), generator=gen, device=device)
    origins = o.reshape(-1, 3)[idx].contiguous()
    dirs = d.reshape(-1, 3)[idx].contiguous()
    z = stratify_depths(linspace_depths(near, far, n_samples, device=device), gen)
    phases = torch.randint(0, 10, (n_rays,), generator=gen, device=device)
    return origins, dirs, z, phases


def flagship_params(seed: int, device, fourier: bool = False):
    from nerfca_tpu_torch.models.fields import init_static_field, init_temporal_field
    from nerfca_tpu_torch.ops import prng

    cfg_s, cfg_t = flagship_cfgs(fourier)
    keys = prng.split(prng.key(seed))
    return {"static": init_static_field(keys[0], cfg_s, device),
            "temp": init_temporal_field(keys[1], cfg_t, device)}


def cuda_time_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    """CUDA-event ms per call of ``fn`` over ``iters`` calls after
    ``warmup``: the variant scripts' clock (this script times nothing)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_counts() -> dict:
    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    return {**ff.LAUNCHES, **ft.LAUNCHES}


def reset_launch_counts() -> None:
    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    ff.reset_launch_counts()
    ft.reset_launch_counts()


def leaf_errors(names, got, want) -> tuple[float, float, str]:
    """Max abs error over leaves, and the worst error as a share of
    max(leaf scale, 1e-2 x global max); raises beyond K2_REL."""
    global_max = max(float(b.abs().max()) for b in want)
    err_max, norm_max, worst = 0.0, 0.0, ""
    for name, a, b in zip(names, got, want):
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-2 * global_max)
        if not math.isfinite(err) or err / scale > K2_REL:
            raise AssertionError(f"gradient {name} disagrees: {err:.3e} vs scale {scale:.3e}")
        err_max = max(err_max, err)
        if err / scale >= norm_max:
            norm_max, worst = err / scale, name
    return err_max, norm_max, worst


def trained_leaves(params) -> tuple:
    """Names and tensors of the leaves that take a gradient (a fourier
    projection is a buffer), each set to require one."""
    from nerfca_tpu_torch.train.step import is_buffer, param_items

    names, leaves = zip(*[(n, t) for n, t in param_items(params) if not is_buffer(n)])
    for t in leaves:
        t.requires_grad_(True)
    return names, leaves


def fine_rays(params, n_rays: int, n_coarse: int, n_fine: int, seed: int, device):
    """The fine pass's inputs at its shapes: :func:`flagship_rays` with
    their stratified coarse depths, the plain coarse pair's sigmas there
    (every band open), and the sorted per-ray union ``[R, n_coarse +
    n_fine]`` of the coarse depths and ``sample_pdf``'s draws from them
    (``train/step.py::fine_depths``, seeded uniforms)."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.ops.render import render_transmission_composite
    from nerfca_tpu_torch.train.step import fine_depths

    cfg_s, cfg_t = flagship_cfgs()
    origins, dirs, z, phases = flagship_rays(n_rays, n_coarse, seed, device)
    window = torch.ones(12, device=device)
    with torch.no_grad():
        s_raw, t_raw = ff.plain_composite_fields_rays(
            params["static"], params["temp"], origins, dirs, z, phases, cfg_s, cfg_t, window,
            window)
        i0 = torch.full((n_rays,), 2.16, device=device)
        _, s_sig, t_sig, _ = render_transmission_composite(s_raw, t_raw, i0, z)
        u = torch.rand((n_rays, n_fine), generator=torch.Generator(device=device).manual_seed(
            seed + 7), device=device)
        return origins, dirs, fine_depths(s_sig, t_sig, z, n_fine, u), phases


def packs(params, cfgs, window, dev) -> tuple:
    """Both fields' packed weights for the launch functions."""
    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    return tuple(ff._Pack(c, ff._leaves(params[k]), ff.enc_table(params[k], c, window), dev)
                 for k, c in zip(("static", "temp"), cfgs))


def flagship_hull(device):
    """A random gate grid in [0, 1] over a quarter of the flagship volume's
    extent: rays that miss it are empty (gate exactly 0 on every sample)."""
    import numpy as np
    import torch

    from nerfca_tpu_torch.ops.hull import MotionHull

    info, _ = flagship_geometry()
    res = 32
    extent = np.asarray(info["nVoxel"], np.float64) * np.asarray(info["dVoxel"], np.float64)
    grid = torch.rand(res, res, res, generator=torch.Generator().manual_seed(5))
    return MotionHull(grid.to(device),
                      torch.tensor(extent / 4 / res, dtype=torch.float32, device=device),
                      torch.tensor(np.asarray(info["offOrigin"])[::-1].copy(),
                                   dtype=torch.float32, device=device))


def k3_args(device, n_rays: int = 1024, n_samples: int = 500, seed: int = 0,
            fourier: bool = False, hull: bool = False) -> tuple:
    """K3's argument tuple at the flagship shapes (the pair on the fourier
    encoding with ``fourier``): params, rays of the flagship view, pixels,
    weights, every band open, and the flagship's regularizers at weights
    large enough to move the grads, the hull's among them with ``hull``."""
    import torch

    from nerfca_tpu_torch.train.step import CompositeHParams

    cfg_s, cfg_t = flagship_cfgs(fourier)
    params = flagship_params(seed + 7, device, fourier)
    origins, dirs, z, phases = flagship_rays(n_rays, n_samples, seed + 8, device)
    g = torch.Generator(device=device).manual_seed(seed + 9)
    pixels = 2.16 - 0.5 * torch.rand(n_rays, generator=g, device=device)
    weights = 1.0 + torch.rand(n_rays, generator=g, device=device)
    i0 = torch.full((n_rays,), 2.16, device=device)
    window = None if fourier else torch.ones(12, device=device)
    hp = CompositeHParams(entro_mask_thre=1e-4, entro_use_weighting=True,
                          entro_weighted_thresh=0.03, occl_reg_perc=0.2, use_pallas=True,
                          use_fused_loss=True)
    lw = [1e-3, 1e-3, 1e-3, 1e-4] + ([1e-3] if hull else [])
    return (params["static"], params["temp"], origins, dirs, z, phases, pixels, weights, i0,
            cfg_s, cfg_t, window, window, lw, hp)


def kernel_checks(seed: int = 0) -> list:
    """The kernels against their plain versions and bf16 twins at the
    flagship shapes, on the flagship view's rays with every band open,
    through ``tests/test_torch_gpu.py``'s comparisons (one implementation
    each; each raises on a disagreement): K1/K2 in f32, fourier and bf16 at
    1024 x 500 and in f32 at the fine pass's 1024 x 628 per-ray depths
    (:func:`fine_rays`); K3 in f32 and fourier, without and with a hull;
    K3 in bf16; K3 over bf16 residuals against its twin and against the f32
    K3, and K2's change under them; the eval's Beer-Lambert kernel against
    the torch composite on the benchmark cell's view (40000 rays x 500) and
    at the fine pair's per-ray depths under a hull gate; the static
    method's eval: the one-field K1 on rays against the point form and the
    plain field (free_windowed and fourier, 1024 x 500 of ``make``'s rays),
    its view on ``static3d-k1-render``'s 40000 x 500 (the launches of each
    route counted) and the one-field Beer-Lambert kernel at 628 per-ray
    depths. Returns each case with its shape and the launches it made."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))  # as scripts/gpu_check_seeds.py imports it
    import test_torch_gpu as gpu

    dev = torch.device("cuda")

    def fields(fourier=False, fine=False):
        cfg_s, cfg_t = flagship_cfgs(fourier)
        params = flagship_params(seed, dev, fourier)
        rays = (fine_rays(params, 1024, 500, FINE_SAMPLES, seed, dev) if fine
                else flagship_rays(1024, 500, seed, dev))
        w = None if fourier else torch.ones(12, device=dev)
        return (params["static"], params["temp"], *rays, cfg_s, cfg_t, w, w), \
            trained_leaves(params)[1]

    def k3(hull=False, **kw):
        return k3_args(dev, seed=seed, hull=hull, **kw), flagship_hull(dev) if hull else None

    def residuals_vs_twin():
        args, h = gpu.k3_bf16(*k3(), pallas_bf16_residuals=True)
        gpu.check_k3(args, h, k2="fused_field_bwd_res_bf16")

    cases = [("K1/K2", 1024, 500, lambda: gpu.check(*fields())),
             ("K1/K2 fourier", 1024, 500, lambda: gpu.check(*fields(fourier=True))),
             ("K1/K2 fine", 1024, 500 + FINE_SAMPLES, lambda: gpu.check(*fields(fine=True))),
             ("K1/K2 bf16", 1024, 500, lambda: gpu.check_bf16(*fields())),
             ("K1/K2 bf16 fourier", 1024, 500, lambda: gpu.check_bf16(*fields(fourier=True))),
             ("K3", 1024, 500, lambda: gpu.check_k3(*k3())),
             ("K3 hull", 1024, 500, lambda: gpu.check_k3(*k3(hull=True))),
             ("K3 fourier", 1024, 500, lambda: gpu.check_k3(*k3(fourier=True))),
             ("K3 fourier hull", 1024, 500, lambda: gpu.check_k3(*k3(hull=True, fourier=True))),
             ("K3 bf16", 1024, 500, lambda: gpu.check_k3_bf16(*k3())),
             ("K3 bf16 residuals vs twin", 1024, 500, residuals_vs_twin),
             ("K3 bf16 residuals vs f32 K3", 1024, 500, lambda: gpu.check_res_loss(*k3())),
             ("K2 bf16 residuals' change", 1024, 500, lambda: gpu.check_res_k2_change(fields()[0])),
             ("eval composite, the cell's view", 40000, 500, lambda: gpu.check_composite_view(dev)),
             ("eval composite fine hull", 777, 628,
              lambda: gpu.check_composite(dev, gated=True, per_ray=True, images=False)),
             ("static K1 rays", 1024, 500, lambda: gpu.check_static_rays(dev, 1024, 500, True)),
             ("static K1 rays fourier", 1024, 500,
              lambda: gpu.check_static_rays(dev, 1024, 500, True, enc="fourier")),
             ("eval static, the cell's view", 40000, 500, lambda: gpu.check_static_view(dev)),
             ("eval static per-ray", 777, 628,
              lambda: gpu.check_eval_static(dev, "softplus", per_ray=True))]
    done = []
    for name, rays, samples, run in cases:
        before = launch_counts()
        run()
        torch.cuda.synchronize()
        made = {k: v - before.get(k, 0) for k, v in launch_counts().items()
                if v != before.get(k, 0)}
        done.append({"case": name, "rays": rays, "samples": samples, "launches": made})
    return done


def k3_errors(tag: str, got, want) -> dict:
    """K3 results against a reference's: loss and every term within
    LOSS_REL, grads by K2's rule. Raises on a disagreement."""
    from nerfca_tpu_torch.train.step import param_items

    k_loss, k_terms, k_gs, k_gt = got
    p_loss, p_terms, p_gs, p_gt = want
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    if not (math.isfinite(loss_rel) and loss_rel <= LOSS_REL):
        raise AssertionError(f"K3{tag} loss {float(k_loss)} vs {float(p_loss)}")
    term_rel = 0.0
    for k in p_terms:
        a, b = float(k_terms[k]), float(p_terms[k])
        if not (math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b)):
            raise AssertionError(f"K3{tag} term {k}: {a} vs {b}")
        term_rel = max(term_rel, abs(a - b) / abs(b) if b else 0.0)
    names, k_leaves = zip(*param_items({"static": k_gs, "temp": k_gt}))
    _, p_leaves = zip(*param_items({"static": p_gs, "temp": p_gt}))
    err, norm, worst = leaf_errors(names, k_leaves, p_leaves)
    return {f"loss_rel{tag}": loss_rel, f"term_rel{tag}": term_rel, f"err{tag}": err,
            f"norm{tag}": norm, f"worst{tag}": worst}


def counted_run(argv: list, static: bool = False) -> dict:
    """``run_composite.main(argv)`` (``run_nerf.main`` with ``static``) with
    the launch counts set to 0 just before and read just after, the eval
    renders' launches and views apart."""
    from nerfca_tpu_torch.train import evaluation, run_composite, run_nerf

    info = {"eval_launches": {}, "eval_views": 0}
    render = evaluation.render_test_view  # the static method's eval renders through it too

    def counted_render(*a, **k):
        before = launch_counts()
        info["eval_views"] += 1
        out = render(*a, **k)
        for key, v in launch_counts().items():
            info["eval_launches"][key] = info["eval_launches"].get(key, 0) + v - before[key]
        return out

    evaluation.render_test_view = counted_render
    try:
        reset_launch_counts()
        out = (run_nerf if static else run_composite).main(argv)
        total = launch_counts()
    finally:
        evaluation.render_test_view = render
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    info.update(run=out, launches=total, train=[r for r in records if "train_loss" in r],
                evals=[r for r in records if "test_image_psnr" in r],
                train_launches={k: total[k] - info["eval_launches"].get(k, 0) for k in total})
    return info


def check_eval_graphs(what: str, res: dict) -> None:
    """The in-loop evals of a ``counted_run`` as the eval renderer's CUDA
    graphs run them: the first view captured, every later view (after
    Adam's in-place steps and at a new window) replayed, none eager."""
    el, n = res["eval_launches"], res["eval_views"]
    got = tuple(el.get("eval_view." + k, 0) for k in ("capture", "replay", "eager"))
    if n < 2 or got != (1, n - 1, 0):
        raise AssertionError(f"{what}: {n} eval views ran as (capture, replay, eager) {got}, "
                             f"expected (1, {n - 1}, 0)")


def drive_main_path(workdir: str, extra_argv: list, n_steps: int,
                    k1_key: str = "fused_field_fwd") -> dict:
    """``run_composite.main`` at flagship width: ``n_steps`` train steps and
    one eval render on the dataset under ``workdir`` (built if absent), in
    which the K1 instantiation counted under ``k1_key`` must run."""
    # each run logs under its own root: two runs that start in the same
    # second would otherwise share a timestamped log dir
    argv = ["--config", os.path.join(REPO, "configs", "composite.txt"), "--use_pallas", "true",
            "--platform", "cuda", "--n_iters", str(n_steps - 1), "--display_every", str(n_steps),
            "--data_root", os.path.join(workdir, "data"),
            "--log_dir_root", tempfile.mkdtemp(prefix="cases-", dir=workdir), *extra_argv]
    res = counted_run(argv)
    train, evals = res["train"], res["evals"]
    if len(train) != n_steps or not all(math.isfinite(r["train_loss"]) for r in train):
        raise AssertionError(f"expected {n_steps} finite train steps, "
                             f"got {[r.get('train_loss') for r in train]}")
    if len(evals) != 1 or not math.isfinite(evals[0]["test_image_psnr"]):
        raise AssertionError(f"expected one finite eval, got {evals}")
    if res["eval_launches"].get(k1_key, 0) < 1:
        raise AssertionError(f"{k1_key} not launched during the eval render: {res}")
    res["eval"] = evals[0]
    return res


def fine_phase(workdir: str, extra_argv: tuple = ()) -> dict:
    """Phase 4j: the fine pass on the kernels through ``run_composite.main``
    (``configs/composite.txt``, ``FINE_ARGV``, ``--use_pallas true
    --use_fused_loss true``) on the flagship dataset, ``FINE_STEPS`` steps
    and an eval at step ``FINE_STEPS``, the counts set to 0 just before:
    no K3 (it has no fine pass), K1 and K2 twice a step (the coarse pair,
    then the fine pair at per-ray depths), K1 twice per eval tile. Then the
    step-0 eval of the seed's initial params. Raises on a failure; the
    gates against the JAX record are :func:`report_fine`'s. ``extra_argv``
    is appended to the command line (a smaller rehearsal)."""
    from nerfca_tpu_torch.train import evaluation, trainer
    from nerfca_tpu_torch.train.config import parse_args

    argv = ["--config", os.path.join(REPO, "configs", "composite.txt"), "--use_pallas", "true",
            "--use_fused_loss", "true", *FINE_ARGV, "--platform", "cuda", "--n_iters",
            str(FINE_STEPS), "--display_every", str(FINE_STEPS), "--seed", "0", "--log_every",
            "1", "--data_root", os.path.join(workdir, "data"),
            "--log_dir_root", tempfile.mkdtemp(prefix="cases-", dir=workdir), *extra_argv]
    res = counted_run(argv)
    out, tl, el = res["run"], res["train_launches"], res["eval_launches"]
    n_total = FINE_STEPS + 1
    if len(res["train"]) != n_total or not all(math.isfinite(r["train_loss"])
                                               for r in res["train"]):
        raise AssertionError(f"fine pass: {len(res['train'])} logged steps, not all finite")
    if [r["step"] for r in res["evals"]] != [FINE_STEPS] or not all(
            math.isfinite(res["evals"][0][k]) for k in ("test_image_psnr",
                                                        "test_image_psnr_fine")):
        raise AssertionError(f"fine pass: evals {res['evals']}")
    tiles = -(-len(out["setup"]["test_views"][0]["phases"]) // 4096)
    if (tl["fused_train_loss"] or tl["fused_field_fwd"] != 2 * n_total
            or tl["fused_field_bwd"] != 2 * n_total or el.get("fused_field_fwd") != 2 * tiles):
        raise AssertionError(f"fine pass: expected no K3, K1 and K2 twice a step and K1 twice "
                             f"per eval tile: training {tl}, eval {el}")

    setup = out["setup"]
    args = parse_args(argv)
    dev = setup["device_data"]["rays"].device
    view = setup["test_views"][0]
    info = setup["info"]
    depths = {"coarse": trainer.eval_depths(info, args.depth_samples_per_ray_coarse,
                                            args.seed + 1, dev),
              "fine": trainer.eval_depths(info, FINE_SAMPLES, args.seed + 2, dev)}

    def eval_view(params, step):
        render = evaluation.render_test_view(
            params, view["origins"], view["directions"], view["phases"], depths["coarse"], step,
            setup["cfgs"], setup["hp"], setup["max_pixel_value"],
            depth_values_fine=depths["fine"], hull=setup["hull"])
        return evaluation.test_metrics(render, view["image"], step, setup["hp"],
                                       img_shape=view["shape"])

    init = trainer._init_composite_state(args, setup["cfgs"], None, dev)
    evals = {0: eval_view(init.params, 0), FINE_STEPS: res["evals"][0]}
    return {"res": res, "loss": {r["step"]: r["train_loss"] for r in res["train"]},
            "evals": evals, "tiles": tiles}


def report_fine(fp: dict, card: str) -> bool:
    """Print phase 4j beside the JAX record; True when its gates pass."""
    with open(JAX_FINE) as f:
        rec = json.load(f)
    res, loss, evals = fp["res"], fp["loss"], fp["evals"]
    log(f"fine pass (configs/composite.txt {' '.join(FINE_ARGV)}, K1/K2, {FINE_STEPS} steps; "
        f"{card})")
    log(f"  launches: training {res['train_launches']}, in-loop eval {res['eval_launches']} "
        f"({fp['tiles']} tiles a pass)")
    for s in sorted(int(k) for k in rec["train_loss"]):
        log(f"  step {s}: train_loss {loss[s]:.7g} (JAX {rec['train_loss'][str(s)]:.7g})")
    for s in sorted(int(k) for k in rec["evals"]):
        log(f"  eval at step {s}: test_image_psnr {evals[s]['test_image_psnr']:.4f} dB (JAX "
            f"{rec['evals'][str(s)]['test_image_psnr']:.4f}), test_image_psnr_fine "
            f"{evals[s]['test_image_psnr_fine']:.4f} dB (JAX "
            f"{rec['evals'][str(s)]['test_image_psnr_fine']:.4f})")
    loss0_rel = abs(loss[0] - rec["train_loss"]["0"]) / abs(rec["train_loss"]["0"])
    last = rec["evals"][str(FINE_STEPS)]
    gaps = {k: abs(evals[FINE_STEPS][k] - last[k])
            for k in ("test_image_psnr", "test_image_psnr_fine")}
    passed = loss0_rel <= GATE_STATIC_LOSS0_REL and max(gaps.values()) <= GATE_STATIC_PSNR_DB
    log(f"  gates against the JAX record: step-0 train_loss rel {loss0_rel:.3e} <= "
        f"{GATE_STATIC_LOSS0_REL}, step-{FINE_STEPS} PSNR gaps "
        f"{json.dumps({k: round(v, 4) for k, v in gaps.items()})} dB <= {GATE_STATIC_PSNR_DB}: "
        f"{'passed' if passed else 'FAILED'}")
    fp.update(loss0_rel=loss0_rel, psnr_gaps=gaps)
    return passed


def shipped_fine_phase(workdir: str, extra_argv: tuple = ()) -> dict:
    """Phase 4j': the shipped 64-wide fine pair (``configs/composite.txt``'s
    ``*_num_filters_fine``) with FINE_SAMPLES fine samples, ``--use_pallas
    true --use_fused_loss true``: 6 steps and one eval. The fine pair lies
    outside the kernels' envelope, so the trainer warns and its pass runs
    plain while the coarse pair keeps K1/K2 (one each a step, K1 once per
    eval tile); every step and the fine PSNR are finite."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = drive_main_path(workdir, ["--use_fused_loss", "true", "--depth_samples_per_ray_fine",
                                        str(FINE_SAMPLES), *extra_argv], 6)
    said = [str(w.message) for w in caught if "fine-field config outside" in str(w.message)]
    tl, el = res["train_launches"], res["eval_launches"]
    tiles = -(-len(res["run"]["setup"]["test_views"][0]["phases"]) // 4096)
    if not said:
        raise AssertionError(f"shipped fine pair: no envelope warning in "
                             f"{[str(w.message) for w in caught]}")
    if (tl["fused_train_loss"] or tl["fused_field_fwd"] != 6 or tl["fused_field_bwd"] != 6
            or el.get("fused_field_fwd") != tiles):
        raise AssertionError(f"shipped fine pair: expected the coarse pair alone on K1/K2: "
                             f"training {tl}, eval {el}")
    if not math.isfinite(res["eval"]["test_image_psnr_fine"]):
        raise AssertionError(f"shipped fine pair: eval {res['eval']}")
    res["warning"] = said[0]
    return res


def sweep_phase(workdir: str, extra_argv: tuple = ()) -> dict:
    """Phase 4k: a sweep on the card through ``run_composite.main
    --wandb_sweep_yaml``: ``SWEEP_YAML``'s grid under ``early_terminate:
    {type: hyperband, max_iter: SWEEP_MAX_ITER}`` on
    ``configs/synth-4view-best.txt`` (K3 + hull), on phase 4c's dataset,
    an eval every step (the selection metric). Each run's launches are
    counted apart. Checks the rung budgets, that every run launched K3 on
    each of its steps, and that each promoted config resumed from its last
    checkpoint (its logged steps continue where the last run stopped).
    ``extra_argv`` is appended to the command line (a smaller rehearsal)."""
    import yaml

    from nerfca_tpu_torch.train import run_composite
    from nerfca_tpu_torch.train.sweep import hyperband_rungs, load_sweep_config

    cfg = load_sweep_config(SWEEP_YAML)
    cfg["early_terminate"] = {"type": "hyperband", "max_iter": SWEEP_MAX_ITER}
    path = os.path.join(workdir, "sweep.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    root = os.path.join(workdir, "cases-sweep")
    argv = ["--config", CLEAN_CONFIG, "--platform", "cuda", "--wandb_sweep_yaml", path,
            "--data_root", os.path.join(workdir, "data"), "--log_dir_root", root,
            "--display_every", "1", "--steps_per_chunk", "1", "--log_every", "1", *extra_argv]
    runs, train = [], run_composite.train_composite

    def counted_train(args, max_steps=None):
        before = launch_counts()
        out = train(args, max_steps=max_steps)
        with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
            steps = [json.loads(line)["step"] for line in f if '"train_loss"' in line]
        runs.append({"log_dir": out["log_dir"], "resume_from": args.resume_from, "steps": steps,
                     "launches": {k: v - before[k] for k, v in launch_counts().items()},
                     "final_step": out["final_step"]})
        return out

    run_composite.train_composite = counted_train
    try:
        reset_launch_counts()
        ranked = run_composite.main(argv)
    finally:
        run_composite.train_composite = train
    with open(os.path.join(root, "SYNTH-FOVHC", "sweep_results.json")) as f:
        results = json.load(f)
    hb = results["hyperband"]
    grid = len(results["results"])
    if hb["rung_iters"] != hyperband_rungs(SWEEP_MAX_ITER) or grid != 4:
        raise AssertionError(f"sweep: rungs {hb['rung_iters']}, {grid} configs")
    if [len(r["scores"]) for r in hb["rungs"]] != [4, 2, 1] or len(runs) != 7:
        raise AssertionError(f"sweep: rungs {hb['rungs']}, {len(runs)} runs")
    ends = {}
    for r in runs:
        n = len(r["steps"])
        if r["launches"]["fused_train_loss"] != n or not n:
            raise AssertionError(f"sweep: a run did not launch K3 on each of its steps: {r}")
        start = 0
        if r["resume_from"]:
            start = ends[os.path.realpath(os.path.dirname(r["resume_from"]))]
        if r["steps"] != list(range(start, r["final_step"])):
            raise AssertionError(f"sweep: a run's steps do not continue its checkpoint's: {r}")
        ends[os.path.realpath(r["log_dir"])] = r["final_step"]
    if sum(1 for r in runs if r["resume_from"]) != 3:
        raise AssertionError(f"sweep: expected 3 resumed runs: {runs}")
    return {"results": results, "runs": runs, "ranked": ranked}


class Background:
    """``fn(*args)`` in a thread, started at once: :meth:`result` joins it
    and returns its value (raising its error)."""

    def __init__(self, fn, *args):
        import threading

        self.value, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.value = fn(*args)
        except BaseException as e:  # re-raised in the main thread by result()
            self.error = e

    def result(self):
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.value


def magix_volumes(vols: str) -> None:
    from nerfca_tpu_torch.data.ccta_surrogate import write_surrogate_case

    write_surrogate_case(vols, phases=MAGIX_PHASES, shape=MAGIX_SHAPE, workers=MAGIX_WORKERS,
                         verbose=False)


def xcat_volumes(xcat_path: str) -> list:
    """The XCAT driver contract at the real dims for XCAT_PHASES phases:
    the port's stand-in installed as ``dxcat1_bin``, ``prepare_and_run_xcat``
    per phase, the raw bins deleted after extraction (as
    scripts/tpu_xcat_surrogate.py does). Per phase: its registry entry and
    the artery voxels of its ``dyn_volume_tigre.npy``."""
    import numpy as np

    from nerfca_tpu_torch.data import dxcat_surrogate_bin, xcat

    dxcat_surrogate_bin.install(xcat_path)
    for name in ("volume", "noarteries"):
        with open(os.path.join(xcat_path, f"{name}.samp.par"), "w") as f:
            f.write(XCAT_PAR)
    out = []
    for p in range(XCAT_PHASES):
        obj = xcat.prepare_and_run_xcat(p / 10.0, 0.0, xcat_path, dimensions=XCAT_DIMS)
        run_dir = os.path.join(xcat_path, str(obj["id"]))
        for name in ("volume", "noarteries"):
            os.remove(os.path.join(run_dir, f"{name}_atn_1.bin"))
        dyn = np.load(os.path.join(run_dir, "dyn_volume_tigre.npy"))
        out.append({**obj, "dyn_voxels": int((dyn > 0).sum()), "shape": list(dyn.shape)})
    return out


class VolumeBuilds:
    """Phases 4l and 4m's volumes, built in the background while the
    earlier phases use the card, each family in its own thread (the MAGIX
    phases in MAGIX_WORKERS spawned processes, the XCAT generator in
    subprocesses) under ``workdir``. As a context manager it waits for both
    on leaving, so that no build outlives its directory."""

    def __init__(self, workdir: str):
        os.environ["NERFCA_REPO"] = REPO  # where the installed stand-in finds the port
        self.magix_vols = os.path.join(workdir, "magix-vols")
        self.xcat_path = os.path.join(workdir, "xcat")
        os.makedirs(self.xcat_path, exist_ok=True)
        self.magix = Background(magix_volumes, self.magix_vols)
        self.xcat = Background(xcat_volumes, self.xcat_path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for b in (self.magix, self.xcat):
            b.thread.join()
        return False


def surrogate_argv(data_name: str, volume_root: str, workdir: str, n_phases: int = 10,
                   n: int = 6000) -> list:
    """scripts/tpu_ccta_surrogate.py::build(n)'s argv less its eval, save,
    log and chunk cadence and its step count: its data_argv() with
    ``data_name``, phases 0 to ``n_phases``, the schedules of ``n`` steps,
    the motion hull, ray jitter, K3, on the card, seed 0. It follows
    ``--config configs/composite.txt``."""
    return ["--data_name", data_name, "--x_ray_type", "rotation", "--data_size", "200",
            "--volume_root", volume_root, "--data_limited_range", "60", "--data_step_size", "120",
            "--data_numb_angles", "4", "--data_time_range_start", "0",
            "--data_time_range_end", str(n_phases), "--selection_view", "0,0",
            "--data_root", os.path.join(workdir, "data"),
            "--keep_last_n_checkpoints", "50", "--best_metric", "separated_psnr",
            "--lr_decay_steps", str(int(n * 0.75)),
            "--static_pos_enc_window_decay_steps", str(int(n * 0.75)),
            "--temp_pos_enc_window_decay_steps", str(int(n * 0.75)),
            "--hyperparam_decay_steps", str(int(n * 0.5)),
            "--favor_s_weight_delay_steps", str(int(n * 0.2)),
            "--entro_clip_threshold", "1e-6", "--use_motion_hull", "true",
            "--ray_jitter_perc", "1.0", "--use_pallas", "true", "--use_fused_loss", "true",
            "--use_wandb", "false", "--platform", "cuda", "--seed", "0"]


def k3_each_step(res: dict, n: int, what: str) -> None:
    tl = res["train_launches"]
    if (tl["fused_train_loss"] != n or tl["fused_field_fwd"] != n
            or tl["fused_field_bwd"] != n):
        raise AssertionError(f"{what}: expected one K3 (K1, the loss kernel, K2) on each of "
                             f"{n} steps: {tl}")
    if len(res["train"]) < 1 or not all(math.isfinite(r["train_loss"]) for r in res["train"]):
        raise AssertionError(f"{what}: non-finite logged loss {res['train']}")


def magix_phase(workdir: str, vb: VolumeBuilds, extra_argv: tuple = ()) -> dict:
    """Phase 4l: MAGIX-SURR on the card. Waits for the background volumes,
    then (a) MAGIX_PARITY_STEPS K3 steps of the recipe without the hull,
    the dataset built on the card by the first run, with an eval at the
    end and one of the initial parameters; (b) the recipe as written for
    MAGIX_STEPS steps (K3 + hull, checkpoints 500 and 1000), ``run_eval``
    of checkpoint-1000 over the 40 views of evaluate.json; (c) the native
    projector against the card's on the first train view of phase 0. Raises on a failure other
    than the gates against the JAX records, which :func:`report_magix`
    applies. ``extra_argv`` is appended to every command line."""
    import numpy as np

    from nerfca_tpu_torch.data import native
    from nerfca_tpu_torch.data.dataset import dataset_paths
    from nerfca_tpu_torch.ops.projector import project_view
    from nerfca_tpu_torch.train import evaluation, run_eval, trainer
    from nerfca_tpu_torch.train.config import parse_args

    vb.magix.result()
    vols = vb.magix_vols
    argv = ["--config", os.path.join(REPO, "configs", "composite.txt"),
            *surrogate_argv("MAGIX-SURR", vols, workdir),
            # build(6000)'s cadence
            "--display_every", "250", "--save_every", "500", "--log_every", "250",
            "--steps_per_chunk", "250", *extra_argv]

    # (a) parity: no hull (a voxel on the carve threshold can flip under
    # the projectors' rounding), the JAX record's cadence
    parity = counted_run([*argv, "--use_motion_hull", "false", "--n_iters",
                          str(MAGIX_PARITY_STEPS), "--display_every", str(MAGIX_PARITY_STEPS),
                          "--log_every", "1", "--log_dir_root",
                          tempfile.mkdtemp(prefix="cases-", dir=workdir)])
    n_total = MAGIX_PARITY_STEPS + 1
    k3_each_step(parity, n_total, "MAGIX-SURR parity")
    if len(parity["train"]) != n_total or [r["step"] for r in parity["evals"]] != [
            MAGIX_PARITY_STEPS]:
        raise AssertionError(f"MAGIX-SURR parity: {len(parity['train'])} logged steps, evals "
                             f"{parity['evals']}")
    out = parity["run"]
    setup, pargs = out["setup"], parse_args(argv)
    view, dev = setup["test_views"][0], setup["depth_values"].device
    init = trainer._init_composite_state(pargs, setup["cfgs"], None, dev)
    render = evaluation.render_test_view(
        init.params, view["origins"], view["directions"], view["phases"],
        trainer.eval_depths(setup["info"], pargs.depth_samples_per_ray_coarse, pargs.seed + 1,
                            dev), 0, setup["cfgs"], setup["hp"], setup["max_pixel_value"])
    psnr = {0: evaluation.test_metrics(render, view["image"], 0, setup["hp"],
                                       img_shape=view["shape"])["test_image_psnr"],
            MAGIX_PARITY_STEPS: parity["evals"][0]["test_image_psnr"]}

    # (b) the recipe as written, with the hull, cut to MAGIX_STEPS steps
    res = counted_run([*argv, "--n_iters", str(MAGIX_STEPS), "--log_dir_root",
                       os.path.join(workdir, "cases-magix")])
    out = res["run"]
    k3_each_step(res, MAGIX_STEPS + 1, "MAGIX-SURR recipe")
    if out["diverged_at"] is not None or out["final_step"] != MAGIX_STEPS + 1:
        raise AssertionError(f"MAGIX-SURR recipe: diverged at {out['diverged_at']}, final step "
                             f"{out['final_step']}")
    hull = out["setup"]["hull"]
    occupied = float((hull.grid > 0.5).float().mean()) if hull is not None else 0.0
    if not occupied > 0:
        raise AssertionError("MAGIX-SURR recipe: the carved hull has no voxel above 0.5")
    ckpts = sorted(int(n[11:]) for n in os.listdir(out["log_dir"])
                   if n.startswith("checkpoint-") and n[11:].isdigit())
    if not {500, 1000} <= set(ckpts):
        raise AssertionError(f"MAGIX-SURR recipe: checkpoints on disk {ckpts}")
    args = parse_args([*argv, "--resume_from", os.path.join(out["log_dir"], "checkpoint-1000")])
    before = launch_counts()
    result = run_eval.evaluate_checkpoint(args, write_images=False)
    keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
    score = {"views": len(result["per_view"]),
             "k1_launches": launch_counts()["fused_field_fwd"] - before["fused_field_fwd"],
             **{k: result[k] for k in keys}}
    if (score["views"] != 40 or result["step"] != 1000 or score["k1_launches"] < 40
            or not all(math.isfinite(score[k]) for k in keys)):
        raise AssertionError(f"MAGIX-SURR: run_eval of checkpoint-1000 {score}")

    # (c) the native projector on the host against the card's, one view
    vol = np.load(os.path.join(vols, "0", "full_volume_tigre.npy"))
    with open(dataset_paths(pargs, pargs.data_root).general) as f:
        info = json.load(f)
    theta, phi = -30.0, 30.0  # the first of the four train views
    card = project_view(vol, info, theta, phi, device=dev).cpu().numpy()
    if not native.is_available():
        raise AssertionError(f"native projector: {native._error}")
    host = native.native_project_view(vol, info, theta, phi)
    native_err = float(np.abs(host - card).max())
    if not native_err <= NATIVE_ATOL:
        raise AssertionError(f"native projector vs the card's: max abs {native_err:.3e}")
    return {"parity": parity, "psnr": psnr, "res": res, "hull": hull, "occupied": occupied,
            "checkpoints": ckpts, "score": score,
            "native": {"err": native_err, "max": float(np.abs(card).max()), "view": (theta, phi),
                       "threads": native._load().cone_projector_num_threads()}}


def report_magix(mg: dict, card: str) -> bool:
    """Print phase 4l beside the JAX records; True when its gates pass."""
    with open(JAX_MAGIX) as f:
        rec = json.load(f)
    with open(JAX_MAGIX_RUN) as f:
        jrun = {r["step"]: r for r in json.load(f)["per_checkpoint_40view"]}
    pr, res, sc = mg["parity"], mg["res"], mg["score"]
    log(f"MAGIX-SURR ({card}): {MAGIX_PHASES} phases of write_surrogate_case in "
        f"{MAGIX_WORKERS} processes, in the background; the dataset built on the card")
    log(f"  (a) parity, {MAGIX_PARITY_STEPS} K3 steps without the hull; launches: training "
        f"{pr['train_launches']}, eval {pr['eval_launches']}")
    loss = {r["step"]: r["train_loss"] for r in pr["train"]}
    for s in sorted(int(k) for k in rec["train_loss"]):
        log(f"  step {s}: train_loss {loss[s]:.7g} (JAX {rec['train_loss'][str(s)]:.7g})")
    for s in sorted(int(k) for k in rec["evals"]):
        log(f"  eval at step {s}: test_image_psnr {mg['psnr'][s]:.4f} dB (JAX "
            f"{rec['evals'][str(s)]['test_image_psnr']:.4f})")
    loss0_rel = abs(loss[0] - rec["train_loss"]["0"]) / abs(rec["train_loss"]["0"])
    gap = abs(mg["psnr"][MAGIX_PARITY_STEPS]
              - rec["evals"][str(MAGIX_PARITY_STEPS)]["test_image_psnr"])
    parity_ok = loss0_rel <= GATE_STATIC_LOSS0_REL and gap <= GATE_STATIC_PSNR_DB
    log(f"  gates against the JAX record: step-0 train_loss rel {loss0_rel:.3e} <= "
        f"{GATE_STATIC_LOSS0_REL}, step-{MAGIX_PARITY_STEPS} PSNR gap {gap:.4f} dB <= "
        f"{GATE_STATIC_PSNR_DB}: {'passed' if parity_ok else 'FAILED'}")
    log(f"  (b) the recipe with the hull, {MAGIX_STEPS} steps; launches: training "
        f"{res['train_launches']}, in-loop evals "
        f"{res['eval_launches']}; hull res {mg['hull'].grid.shape[0]}, occupied share "
        f"{mg['occupied']:.6f}; checkpoints {mg['checkpoints']}")
    log(f"  selection view: {[(r['step'], round(r['test_image_psnr'], 3), round(r.get('test_dyn_corr', float('nan')), 4)) for r in res['evals']]}")
    j = jrun.get(1000, {})
    log(f"  run_eval checkpoint-1000 over {sc['views']} views ({sc['k1_launches']} K1 "
        f"launches): PSNR {sc['mean_psnr']:.3f} dB, SSIM "
        f"{sc['mean_ssim']:.4f}, dyn_psnr_masked {sc['mean_dyn_psnr_masked']:.3f}, dyn_corr "
        f"{sc['mean_dyn_corr']:.4f} (the JAX round-5 record of the recipe at step 1000: "
        f"{j.get('mean_psnr', float('nan')):.2f} dB, SSIM {j.get('mean_ssim', float('nan')):.3f}, "
        f"dyn_corr {j.get('mean_dyn_corr', float('nan')):.3f})")
    quality_ok = sc["mean_psnr"] >= GATE_MAGIX_PSNR and sc["mean_dyn_corr"] >= GATE_MAGIX_DYN_CORR
    log(f"  quality floor at checkpoint-1000: PSNR {sc['mean_psnr']:.3f} >= {GATE_MAGIX_PSNR} "
        f"and dyn_corr {sc['mean_dyn_corr']:.4f} >= {GATE_MAGIX_DYN_CORR}: "
        f"{'passed' if quality_ok else 'FAILED'}")
    nt = mg["native"]
    log(f"  (c) native C++ projector ({nt['threads']} threads) vs the card's, view "
        f"{nt['view']} of phase 0: max abs {nt['err']:.3e} (limit {NATIVE_ATOL}; line integrals up to {nt['max']:.4f})")
    mg.update(loss0_rel=loss0_rel, psnr_gap=gap)
    return parity_ok and quality_ok


def experiment_phase(workdir: str, vb: VolumeBuilds, extra_argv: tuple = ()) -> dict:
    """Phase 4l': ``--use_experiment_name true --experiment_name
    EXPERIMENT`` on phase 4l's volumes (its own data root), without the
    hull: 6 K3 steps and one eval, finite, one K3 a step."""
    argv = [*surrogate_argv("MAGIX-SURR", vb.magix_vols, workdir), "--use_experiment_name",
            "true", "--experiment_name", EXPERIMENT, "--use_motion_hull", "false",
            "--data_root", os.path.join(workdir, "data-experiment"), *extra_argv]
    res = drive_main_path(workdir, argv, 6)
    k3_each_step(res, 6, f"experiment {EXPERIMENT}")
    return res


def xcat_phase(workdir: str, vb: VolumeBuilds, extra_argv: tuple = ()) -> dict:
    """Phase 4m: XCAT-SURR from the background driver run (XCAT_PHASES
    phases at 512 x 512 x 401, each with a non-empty artery volume), the
    XCAT preset's dataset on the card, 6 K3 steps and one eval without the
    hull (fewer than 10 phases write no variance maps); the XCAT workdir is
    deleted after. Raises on a failure."""
    phases = vb.xcat.result()
    if len(phases) != XCAT_PHASES or not all(p["dyn_voxels"] > 0
                                             and p["shape"] == list(XCAT_DIMS) for p in phases):
        raise AssertionError(f"XCAT-SURR: the driver's phases {phases}")
    argv = [*surrogate_argv("XCAT-SURR", vb.xcat_path, workdir, n_phases=XCAT_PHASES),
            "--use_motion_hull", "false", *extra_argv]
    res = drive_main_path(workdir, argv, 6)
    k3_each_step(res, 6, "XCAT-SURR")
    shutil.rmtree(vb.xcat_path)
    res["phases"] = phases
    return res


def non_synth_phases(workdir: str, vb: VolumeBuilds, card: str) -> dict:
    """Phases 4l, 4l' and 4m on ``vb``'s volumes, printed; raises when a
    gate fails."""
    mg = magix_phase(workdir, vb)
    if not report_magix(mg, card):
        raise AssertionError("MAGIX-SURR: the run is outside its gates")
    ex = experiment_phase(workdir, vb)
    log(f"experiment view list (--use_experiment_name true --experiment_name {EXPERIMENT}, "
        f"MAGIX-SURR volumes, K3; {card}): train_loss "
        f"{[round(r['train_loss'], 6) for r in ex['train']]}")
    log(f"  launches: training {ex['train_launches']}, eval {ex['eval_launches']}; "
        f"test_image_psnr {ex['eval']['test_image_psnr']:.3f}")
    shutil.rmtree(vb.magix_vols)
    xc = xcat_phase(workdir, vb)
    log(f"XCAT-SURR ({card}): the driver contract at {' x '.join(map(str, XCAT_DIMS))} through "
        f"the port's stand-in dxcat1_bin, {XCAT_PHASES} phases in the background: artery "
        f"voxels {[p['dyn_voxels'] for p in xc['phases']]}, LCA box centers "
        f"{[[round(v, 1) for v in p['bounding_box_center']] for p in xc['phases']]}; "
        f"train_loss {[round(r['train_loss'], 6) for r in xc['train']]}")
    log(f"  launches: training {xc['train_launches']}, eval {xc['eval_launches']}; "
        f"test_image_psnr {xc['eval']['test_image_psnr']:.3f}")
    return {"magix": mg, "experiment": ex, "xcat": xc}


def load_state_file(ckpt: str) -> dict:
    import torch

    return torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu", weights_only=True)


def states_equal(a: dict, b: dict) -> list:
    """Names of the entries of two ``state.pt`` dicts that differ bitwise."""
    import torch

    diff = [k for k in ("count", "step") if a[k] != b[k]]
    if not torch.equal(a["rng"], b["rng"]):
        diff.append("rng")
    for group in ("params", "mu", "nu"):
        if sorted(a[group]) != sorted(b[group]):
            diff.append(group)
            continue
        diff += [f"{group}/{n}" for n in a[group] if not torch.equal(a[group][n], b[group][n])]
    return diff


def check_trained_state(run: dict) -> dict:
    """K3 and K1 against their plain versions at a run's trained state: K3
    on a batch drawn as a train step draws it (the loss and each term
    within LOSS_REL, grads within K2_REL of their scale), K1 through the
    gated render of the selection view (intensities within RENDER_REL of
    the initial intensity: the render integrates K1's raw densities, each
    within K1_ATOL). Raises on a disagreement."""
    import torch

    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import hull_gate_rays
    from nerfca_tpu_torch.ops.sampling import stratify_depths
    from nerfca_tpu_torch.train import evaluation
    from nerfca_tpu_torch.train.step import (
        field_windows, jitter_directions, loss_weights, param_items, sample_ray_batch,
        step_draws, to_device,
    )

    setup, state = run["setup"], run["state"]
    dd, cfgs, hp, hull = setup["device_data"], setup["cfgs"], setup["hp"], setup["hull"]
    dev = dd["rays"].device
    _, pos, u, t = step_draws(prng.key(123), hp, dd["var_ids"].shape[0],
                              dd["non_var_ids"].shape[0], dd["rays"].shape[0],
                              setup["depth_values"].shape[0])
    pos, t, *u = to_device(dev, pos, t, *([] if u is None else [u]))
    batch = sample_ray_batch(dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"], pos, hp)
    dirs = jitter_directions(batch["directions"], hp.ray_jitter, u[0]) if u else batch["directions"]
    z = stratify_depths(setup["depth_values"], t_rand=t)
    win = field_windows(cfgs, state.step, dev)
    w = loss_weights(state.step, hp)
    i0 = torch.full((hp.img_sample_size,), setup["max_pixel_value"], device=dev)
    args = (state.params["static"], state.params["temp"], batch["origins"], dirs, z,
            batch["phases"], batch["pixels"], batch["weights"], i0, cfgs["static"], cfgs["temp"],
            win["static"], win["temp"],
            [w["favor_s"], w["dynamic_entro"], w["occl"], w["l1"], w["hull_static_l1"]], hp)
    k_loss, k_terms, k_gs, k_gt = ft.fused_train_loss_and_grads(*args, hull=hull)
    p_loss, p_terms, p_gs, p_gt = ft.plain_train_loss_and_grads(*args, hull=hull)
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    term_rel = max(abs(float(k_terms[k]) - float(p_terms[k])) / abs(float(p_terms[k]))
                   for k in p_terms if float(p_terms[k]))
    if not (math.isfinite(loss_rel) and loss_rel <= LOSS_REL and term_rel <= LOSS_REL):
        raise AssertionError(f"trained state: K3 loss {float(k_loss)} vs plain "
                             f"{float(p_loss)}, worst term rel {term_rel:.3e}")
    names, k_leaves = zip(*param_items({"static": k_gs, "temp": k_gt}))
    _, p_leaves = zip(*param_items({"static": p_gs, "temp": p_gt}))
    err, norm, worst = leaf_errors(names, k_leaves, p_leaves)
    view = setup["test_views"][0]
    renders = [evaluation.render_test_view(
        state.params, view["origins"], view["directions"], view["phases"],
        setup["depth_values"], state.step, cfgs, dataclasses.replace(hp, use_pallas=k1),
        setup["max_pixel_value"], hull=hull) for k1 in (True, False)]
    render_err = max(float((renders[0][k] - renders[1][k]).abs().max())
                     for k in ("pix", "pix_static", "pix_temp"))
    if not render_err <= RENDER_REL * setup["max_pixel_value"]:
        raise AssertionError(f"trained state: K1 render differs from plain by {render_err:.3e}")
    return {"step": state.step, "loss_rel": loss_rel, "term_rel": term_rel, "grad_err": err,
            "grad_norm": norm, "worst": worst, "render_err": render_err,
            "empty_rays": int((hull_gate_rays(hull, batch["origins"], dirs, z).sum(-1) == 0).sum())}


def clean_protocol_phase(workdir: str, extra_argv: tuple = ()) -> dict:
    """Phase 4c: the clean-protocol reconstruction trained and scored on the
    card. Trains ``CLEAN_STEPS`` K3 + hull steps with checkpoints at 500,
    1000 and 1001, resumes a second run from checkpoint-500 to the same end
    and holds its checkpoint-1000 bitwise against the first, scores
    checkpoint-500 and checkpoint-1000 over the 40 views of evaluate.json
    with ``run_eval`` (K1 launches counted), renders two views of
    checkpoint-best with ``run_render``, and applies the quality gate.
    ``extra_argv`` is appended to every command line (a smaller rehearsal).
    Raises on any failure."""
    import numpy as np

    from nerfca_tpu_torch.train import run_eval, run_render
    from nerfca_tpu_torch.train.config import parse_args

    argv = ["--config", CLEAN_CONFIG, "--n_iters", str(CLEAN_STEPS), "--platform", "cuda",
            "--data_root", os.path.join(workdir, "data"), *extra_argv]
    res = counted_run(argv + ["--log_dir_root", os.path.join(workdir, "cases")])
    out, tl = res["run"], res["train_launches"]
    n_total = CLEAN_STEPS + 1
    if out["diverged_at"] is not None or out["final_step"] != n_total:
        raise AssertionError(f"clean protocol: diverged at {out['diverged_at']} "
                             f"({out['diverged_terms']}), final step {out['final_step']}")
    if not all(math.isfinite(r["train_loss"]) for r in res["train"]):
        raise AssertionError(f"clean protocol: non-finite logged loss {res['train']}")
    if min(tl["fused_train_loss"], tl["fused_field_fwd"], tl["fused_field_bwd"]) < CLEAN_STEPS:
        raise AssertionError(f"clean protocol: K3 did not run on every step: {tl}")
    if res["eval_launches"].get("fused_field_fwd", 0) < 1:
        raise AssertionError(f"clean protocol: K1 not launched in the evals: {res}")
    check_eval_graphs("clean protocol", res)
    hull = out["setup"]["hull"]
    occupied = float((hull.grid > 0.5).float().mean()) if hull is not None else 0.0
    if not occupied > 0:
        raise AssertionError("clean protocol: the carved hull has no voxel above 0.5")
    trained = check_trained_state(out)

    log_dir = out["log_dir"]
    ckpts = {}
    for name in os.listdir(log_dir):
        if name.startswith("checkpoint-") and name[11:].isdigit():
            with open(os.path.join(log_dir, name, "metadata.json")) as f:
                ckpts[int(name[11:])] = json.load(f)["run"].get("selection_metric")
    if not {500, 1000, 1001} <= set(ckpts):
        raise AssertionError(f"clean protocol: checkpoints on disk {sorted(ckpts)}")
    best_step = max(sorted(ckpts), key=lambda k: ckpts[k])  # first of equals, as saved
    best_link = os.readlink(os.path.join(log_dir, "checkpoint-best"))
    if best_link != f"checkpoint-{best_step}":
        raise AssertionError(f"clean protocol: checkpoint-best -> {best_link}, the highest "
                             f"selection metric is at step {best_step}: {ckpts}")

    # the resume: the same argv from checkpoint-500 in a new log dir
    resumed = counted_run(argv + ["--log_dir_root", os.path.join(workdir, "cases-resumed"),
                                  "--resume_from", os.path.join(log_dir, "checkpoint-500")])
    rt = resumed["train_launches"]
    if resumed["run"]["final_step"] != n_total or rt["fused_train_loss"] != n_total - 500:
        raise AssertionError(f"resume: final step {resumed['run']['final_step']}, "
                             f"launches {rt}")
    diff = states_equal(load_state_file(os.path.join(log_dir, "checkpoint-1000")),
                        load_state_file(os.path.join(resumed["run"]["log_dir"],
                                                     "checkpoint-1000")))
    if diff:
        raise AssertionError(f"resume: checkpoint-1000 differs from the first run's in {diff}")

    # offline eval of two checkpoints and a render of the best
    scores = {}
    for step in (500, 1000):
        args = parse_args(argv + ["--resume_from", os.path.join(log_dir, f"checkpoint-{step}")])
        before = launch_counts()
        result = run_eval.evaluate_checkpoint(args, write_images=False)
        k1 = launch_counts()["fused_field_fwd"] - before["fused_field_fwd"]
        n = len(result["per_view"])
        if n != 40 or result["step"] != step or k1 < n:
            raise AssertionError(f"run_eval of checkpoint-{step}: {n} views, step "
                                 f"{result['step']}, {k1} K1 launches")
        keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
        if not all(math.isfinite(result[k]) for k in keys):
            raise AssertionError(f"run_eval of checkpoint-{step}: {[result[k] for k in keys]}")
        scores[step] = {"k1_launches": k1, "views": n,
                        **{k: result[k] for k in keys}}
    views = [(-30.0, 30.0, 0), (60.0, -30.0, 5)]
    best = os.path.join(log_dir, "checkpoint-best")
    args = parse_args(argv + ["--resume_from", best])
    before = launch_counts()
    rendered = run_render.render_views(args, views)
    render = {"k1_launches": launch_counts()["fused_field_fwd"] - before["fused_field_fwd"]}
    for r in rendered:
        for part in ("composite", "static", "dynamic"):
            img = np.load(os.path.join(best, "renders", f"{r['tag']}-{part}.npy"))
            if img.shape != (args.data_size,) * 2 or not np.isfinite(img).all():
                raise AssertionError(f"run_render {r['tag']}-{part}: {img.shape}")
    if len(rendered) != len(views) or render["k1_launches"] < len(views):
        raise AssertionError(f"run_render: {rendered}, {render}")

    gate = scores[1000]
    passed = gate["mean_psnr"] >= GATE_PSNR and gate["mean_dyn_corr"] >= GATE_DYN_CORR
    return {"res": res, "resumed": resumed, "hull": hull, "occupied": occupied,
            "trained": trained,
            "checkpoints": ckpts, "best_step": best_step, "scores": scores, "render": render,
            "gate_passed": passed}


def clean_leg(workdir: str, extra_argv: list, tag: str, kernel_key: str) -> dict:
    """A bf16 leg of the clean protocol: ``configs/synth-4view-best.txt``
    with ``extra_argv`` for ``CLEAN_STEPS`` steps on phase 4c's dataset,
    the launch counts set to 0 just before and read just after
    (``kernel_key`` must run on every step); ``run_eval`` of checkpoint-1000
    over the 40 views of evaluate.json; the selection view's image PSNR of
    the initial state (step 0), rendered as the trainer's eval renders it.
    Gated on finite values and on the selection view's PSNR rising from
    step 0 (the 4-view problem is bistable across perturbations, so the f32
    leg's ``GATE_PSNR`` floor is not imposed). Raises on a failure."""
    import torch

    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.sampling import stratify_depths
    from nerfca_tpu_torch.train import evaluation, run_eval
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.trainer import _init_composite_state

    argv = ["--config", CLEAN_CONFIG, "--n_iters", str(CLEAN_STEPS), "--platform", "cuda",
            "--data_root", os.path.join(workdir, "data"), *extra_argv]
    res = counted_run(argv + ["--log_dir_root", os.path.join(workdir, f"cases-{tag}")])
    out, tl = res["run"], res["train_launches"]
    if out["diverged_at"] is not None or out["final_step"] != CLEAN_STEPS + 1:
        raise AssertionError(f"clean protocol {tag}: diverged at {out['diverged_at']}, final "
                             f"step {out['final_step']}")
    if not all(math.isfinite(r["train_loss"]) for r in res["train"]):
        raise AssertionError(f"clean protocol {tag}: non-finite logged loss {res['train']}")
    if min(tl["fused_train_loss"], tl[kernel_key]) < CLEAN_STEPS:
        raise AssertionError(f"clean protocol {tag}: {kernel_key} did not run on every step: {tl}")
    args = parse_args(argv + ["--resume_from", os.path.join(out["log_dir"], "checkpoint-1000")])
    result = run_eval.evaluate_checkpoint(args, write_images=False)
    keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
    score = {"views": len(result["per_view"]),
             **{k: result[k] for k in keys}}
    if score["views"] != 40 or not all(math.isfinite(score[k]) for k in keys):
        raise AssertionError(f"clean protocol {tag}: run_eval of checkpoint-1000 {score}")
    setup = out["setup"]
    dev = setup["depth_values"].device
    n = setup["depth_values"].shape[0]
    test_depths = stratify_depths(setup["depth_values"], t_rand=torch.from_numpy(
        prng.uniform(prng.key(args.seed + 1), (n,))).to(dev))
    init = _init_composite_state(args, setup["cfgs"], setup["tx"], dev)
    view = setup["test_views"][0]
    render = evaluation.render_test_view(init.params, view["origins"], view["directions"],
                                         view["phases"], test_depths, 0, setup["cfgs"],
                                         setup["hp"], setup["max_pixel_value"],
                                         hull=setup["hull"])
    psnr0 = evaluation.test_metrics(render, view["image"], 0, setup["hp"],
                                    img_shape=view["shape"])["test_image_psnr"]
    sel = {r["step"]: r["test_image_psnr"] for r in res["evals"]}
    if not (math.isfinite(psnr0) and math.isfinite(sel.get(CLEAN_STEPS, float("nan")))
            and sel[CLEAN_STEPS] > psnr0):
        raise AssertionError(f"clean protocol {tag}: selection-view PSNR {psnr0} at step 0, "
                             f"{sel} after")
    return {"res": res, "score": score, "psnr0": psnr0, "selection": sel,
            "dyn_corr": {r["step"]: r.get("test_dyn_corr") for r in res["evals"]}}


def report_clean_leg(leg: dict, tag: str, f32: dict, card: str) -> None:
    res, sc = leg["res"], leg["score"]
    log(f"clean protocol, {tag} ({CLEAN_STEPS} steps on phase 4c's dataset; {card}): "
        f"launches: training {res['train_launches']}, in-loop evals {res['eval_launches']}")
    log(f"  train_loss {[(r['step'], r['train_loss']) for r in res['train']]}")
    log(f"  selection view image PSNR: step 0 {leg['psnr0']:.3f} dB, then "
        f"{leg['selection']}; dyn_corr {leg['dyn_corr']}")
    log(f"  run_eval checkpoint-1000 over {sc['views']} views: PSNR "
        f"{sc['mean_psnr']:.3f} dB, SSIM {sc['mean_ssim']:.4f}, dyn_psnr_masked "
        f"{sc['mean_dyn_psnr_masked']:.3f}, dyn_corr {sc['mean_dyn_corr']:.4f} (the f32 leg: "
        f"{f32['mean_psnr']:.3f} dB, {f32['mean_ssim']:.4f}, {f32['mean_dyn_psnr_masked']:.3f}, "
        f"{f32['mean_dyn_corr']:.4f})")


def jax_records() -> tuple:
    """The JAX clean-protocol records: 40-view means by checkpoint step,
    the selection-view trajectory and the logged train steps by step."""
    with open(JAX_40VIEW) as f:
        forty = {r["step"]: r for r in json.load(f)["per_checkpoint_40view"]}
    with open(JAX_SELECTION) as f:
        records = [json.loads(line) for line in f]
    sel = {r["step"]: r for r in records if "test_image_psnr" in r}
    train = {r["step"]: r for r in records if "train_loss" in r}
    return forty, sel, train


def report_clean_protocol(cp: dict, card: str) -> None:
    forty, sel, train = jax_records()
    res = cp["res"]
    log(f"clean protocol (configs/synth-4view-best.txt, {CLEAN_STEPS} K3 + hull steps; {card}): "
        f"{len(res['evals'])} evals; hull res {cp['hull'].grid.shape[0]}, occupied share {cp['occupied']:.6f}")
    log(f"  launches: training {res['train_launches']}, in-loop evals {res['eval_launches']}")
    for r in res["train"]:
        j = train.get(r["step"], {})
        log(f"  train_loss at step {r['step']}: {r['train_loss']:.7g} (JAX: "
            f"{j.get('train_loss', float('nan')):.7g})")
    tr = cp["trained"]
    log(f"  at the trained state (step {tr['step']}): K3 loss rel err {tr['loss_rel']:.3e}, "
        f"worst term {tr['term_rel']:.3e} (limit {LOSS_REL}); grads max abs err "
        f"{tr['grad_err']:.3e}, worst leaf {tr['worst']} at {tr['grad_norm']:.3e} of its scale "
        f"(limit {K2_REL}); {tr['empty_rays']} empty rays; K1 render vs plain max abs "
        f"{tr['render_err']:.3e} (limit {RENDER_REL} of I0)")
    for r in res["evals"]:
        j = sel.get(r["step"], {})
        log(f"  selection view at step {r['step']}: image PSNR {r['test_image_psnr']:.3f} dB, "
            f"dyn_corr {r.get('test_dyn_corr', float('nan')):.4f} (JAX: "
            f"{j.get('test_image_psnr', float('nan')):.2f} / {j.get('test_dyn_corr', float('nan')):.3f})")
    log(f"  checkpoints {sorted(cp['checkpoints'])}, selection metrics {cp['checkpoints']}; "
        f"checkpoint-best -> checkpoint-{cp['best_step']}")
    rs = cp["resumed"]
    log(f"  resume from checkpoint-500: launches {rs['train_launches']}; checkpoint-1000 equals the first run's bitwise "
        f"(params, mu, nu, count, step, key)")
    for step, sc in cp["scores"].items():
        j = forty.get(step, {})
        log(f"  run_eval checkpoint-{step} over {sc['views']} views ({sc['k1_launches']} K1 "
            f"launches): PSNR {sc['mean_psnr']:.3f} dB, SSIM "
            f"{sc['mean_ssim']:.4f}, dyn_psnr_masked {sc['mean_dyn_psnr_masked']:.3f}, dyn_corr "
            f"{sc['mean_dyn_corr']:.4f} (JAX: {j.get('mean_psnr', float('nan')):.2f}, "
            f"{j.get('mean_ssim', float('nan')):.3f}, "
            f"{j.get('mean_dyn_psnr_masked', float('nan')):.2f}, "
            f"{j.get('mean_dyn_corr', float('nan')):.3f})")
    log(f"  run_render of checkpoint-best, 2 views: {cp['render']['k1_launches']} K1 launches")
    g = cp["scores"][1000]
    log(f"  quality gate at checkpoint-1000: PSNR {g['mean_psnr']:.3f} >= {GATE_PSNR} and "
        f"dyn_corr {g['mean_dyn_corr']:.4f} >= {GATE_DYN_CORR}: "
        f"{'passed' if cp['gate_passed'] else 'FAILED'}")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_ranks(target, *args) -> None:
    """``target(rank, DP_WORLD, port, *args)`` in ``DP_WORLD`` spawned
    processes; raises unless every one exits 0 within 900 s."""
    import multiprocessing as mp

    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, DP_WORLD, port, *args))
             for r in range(DP_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{target.__name__}: the ranks exited {[p.exitcode for p in procs]}")


def dp_problem(device, n_rays: int = 1024, n_samples: int = 500) -> dict:
    """The data-parallel train problem at the flagship widths: the flagship
    pair drawn from seed 0 as the trainer draws it, a ray table of two
    flagship views (pixels and weights from a seeded generator), the K3
    step's hyperparameters and Adam; the same on every rank."""
    import torch

    from nerfca_tpu_torch.geometry.rays import detector_rays
    from nerfca_tpu_torch.models.fields import init_static_field, init_temporal_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.sampling import linspace_depths
    from nerfca_tpu_torch.train.step import (
        CompositeHParams, TrainState, init_opt_state, make_optimizer,
    )

    info, (near, far) = flagship_geometry()
    gen = torch.Generator().manual_seed(11)
    parts = []
    for angles in ((-30.0, 30.0, 0.0), (60.0, -30.0, 0.0)):
        o, d = detector_rays(*angles, info, device=torch.device("cpu"))
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        pix = (2.16 - 0.5 * torch.rand(o.shape[0], generator=gen))[:, None].expand(-1, 3)
        wts = (1.0 + torch.rand(o.shape[0], generator=gen))[:, None].expand(-1, 3)
        parts.append(torch.stack([o, d, pix, wts], 1))
    rays = torch.cat(parts).to(device)
    phases = torch.randint(0, 10, (rays.shape[0],), generator=gen).to(device)
    cfg_s, cfg_t = flagship_cfgs()
    hp = CompositeHParams(img_sample_size=n_rays, depth_samples_coarse=n_samples,
                          favor_s_weight_start=1e-3, favor_s_weight_end=1e-3,
                          dynamic_entro_weight_start=1e-4, dynamic_entro_weight_end=1e-4,
                          occl_weight_start=1e-4, occl_weight_end=1e-4, l1_weight_start=1e-6,
                          l1_weight_end=1e-6, entro_use_weighting=True,
                          entro_weighted_thresh=0.03, occl_reg_perc=0.2, use_pallas=True,
                          use_fused_loss=True)
    keys = prng.split(prng.key(0), 8)
    params = {"static": init_static_field(keys[0], cfg_s, device),
              "temp": init_temporal_field(keys[1], cfg_t, device)}
    state = TrainState(params=params, opt_state=init_opt_state(params), step=0, rng=keys[7])
    zero = torch.zeros(1, dtype=torch.long, device=device)
    return {"rays": rays, "phases": phases, "ids": (zero, zero), "cfgs": {"static": cfg_s,
            "temp": cfg_t}, "hp": hp, "tx": make_optimizer(1e-3, 0.01, 100000),
            "z": linspace_depths(near, far, n_samples, device=device), "state": state,
            "i0": 2.16}


def dp_train(pb: dict, mesh=None, n_steps: int = DP_STEPS) -> dict:
    """``n_steps`` K3 steps of :func:`dp_problem` (data-parallel over
    ``mesh``'s 'data' axis when given), the launch counts set to 0 just
    before and read just after; the losses, the launches and the final
    parameters flattened in ``param_items`` order."""
    import torch

    from nerfca_tpu_torch.train.step import make_composite_train_step, param_items

    step = make_composite_train_step(pb["cfgs"], pb["hp"], pb["tx"], pb["z"], pb["i0"],
                                     mesh=mesh)
    state = pb["state"]
    reset_launch_counts()
    losses = [float(step(state, pb["rays"], pb["phases"], *pb["ids"])["train_loss"])
              for _ in range(n_steps)]
    counts = launch_counts()
    flat = torch.cat([t.detach().reshape(-1) for _, t in param_items(state.params)]).cpu()
    return {"losses": losses, "launches": counts, "params": flat}


def dp_rank(rank: int, world: int, port: int, out_dir: str, device: str = "cuda",
            n_rays: int = 1024, n_samples: int = 500) -> None:
    """One rank of phase 4g (``DP_WORLD`` processes over gloo, one card):
    the sharded K3 on the flagship batch against K3 and against the plain
    version on the whole batch; then ``DP_STEPS`` data-parallel train
    steps. Writes ``rank<rank>.pt`` under ``out_dir``."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.parallel import make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device=device)
    dev = torch.device(device)
    res: dict = {"rank": rank}
    args = k3_args(dev, n_rays, n_samples)
    shard = ft.fused_train_loss_and_grads_sharded(mesh, "data", *args)
    full = ft.fused_train_loss_and_grads(*args)
    res.update(k3_errors("", shard, full))
    res.update(k3_errors("_vs_plain", shard, ft.plain_train_loss_and_grads(*args)))
    res.update(dp_train(dp_problem(dev, n_rays, n_samples), mesh))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def data_parallel_phase(workdir: str, device: str = "cuda", n_rays: int = 1024,
                        n_samples: int = 500) -> dict:
    """Phase 4g, data parallelism at full width: (1) world 1 over NCCL in
    this process, the sharded entry against the unsharded K3 bitwise;
    (2) ``DP_WORLD`` ranks over gloo on the one card (NCCL refuses two ranks
    on one device), spawned: the sharded K3 within K3's gate of K3 and of
    the plain version on the whole batch, then ``DP_STEPS`` data-parallel
    steps, the parameters bitwise equal across ranks and the losses within
    ``LOSS_REL`` of the single-card steps from the same state. The kernels
    are built before the ranks start. Raises on any failure."""
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.parallel import make_mesh, multihost

    dev = torch.device(device)
    res: dict = {}
    multihost.initialize(f"localhost:{free_port()}", 1, 0,
                         backend="nccl" if device == "cuda" else "gloo")
    try:
        mesh = make_mesh(device=device)
        args = k3_args(dev, n_rays, n_samples)
        one = ft.fused_train_loss_and_grads(*args)
        sharded = ft.fused_train_loss_and_grads_sharded(mesh, "data", *args)
        from nerfca_tpu_torch.train.step import param_items

        pairs = [(one[0], sharded[0])] + [(one[1][k], sharded[1][k]) for k in one[1]]
        for a, b in zip(*(param_items({"static": r[2], "temp": r[3]}) for r in (one, sharded))):
            pairs.append((a[1], b[1]))
        res["world1_bitwise"] = all(torch.equal(a, b) for a, b in pairs)
        if not res["world1_bitwise"]:
            raise AssertionError("world 1: the sharded entry differs from K3")
    finally:
        dist.destroy_process_group()
    single = dp_train(dp_problem(dev, n_rays, n_samples))
    res["single_losses"] = single["losses"]

    out_dir = os.path.join(workdir, "dp")
    os.makedirs(out_dir, exist_ok=True)
    spawn_ranks(dp_rank, out_dir, device, n_rays, n_samples)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    res["ranks"] = [{k: v for k, v in r.items() if k != "params"} for r in ranks]
    res["params_bitwise_equal"] = all(torch.equal(ranks[0]["params"], r["params"])
                                      for r in ranks[1:])
    if not res["params_bitwise_equal"]:
        raise AssertionError("data parallel: the ranks' parameters differ")
    rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], single["losses"])]
    res["loss_rel_vs_single"] = rel
    if not all(math.isfinite(x) and x <= LOSS_REL for x in rel):
        raise AssertionError(f"data parallel losses {ranks[0]['losses']} vs single-card "
                             f"{single['losses']}")
    for r in ranks:
        if device == "cuda" and r["launches"]["fused_train_loss"] != DP_STEPS:
            raise AssertionError(f"rank {r['rank']}: K3 launches {r['launches']}")
    return res


def dpa_problems(device, n_rays: int = 1024, n_samples: int = 500,
                 n_fine: int = FINE_SAMPLES) -> dict:
    """Phase 4n's problems at full width, the same on every rank: the
    flagship two-kernel step (``configs/composite.txt --use_pallas true``,
    its 50% high-variance share), phase 4j's fine pass (``n_fine`` fine
    samples, the 128-wide fine pair), ``configs/3d.txt``'s static step on
    its one-field kernels, and the two-kernel step on ``n_rays - 1`` rays,
    which do not split evenly over two ranks. Each: a step builder
    ``make(mesh)``, a fresh ``state()`` drawn from the seed as the trainers
    draw it, the step's arguments, the steps and K1/K2's launches a step.
    The ray table is :func:`dp_problem`'s two flagship views; its
    high-variance ids are the rays whose largest adjacent coarse-density
    difference (the fine weights ``w``) is in the lower three quarters at
    the initial state, so that a batch's first ``nb_var_rays`` rays (rank
    0's slice, global ray 0 among them) never hold the batch's arg-max of
    ``w`` (:func:`dpa_fine_split`)."""
    import torch

    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.sampling import linspace_depths
    from nerfca_tpu_torch.train import trainer as tr
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.step import (
        TrainState, init_opt_state, make_composite_train_step, make_static_train_step,
    )

    pb = dp_problem(device, n_rays, n_samples)
    common = ["--use_pallas", "true", "--img_sample_size", str(n_rays),
              "--depth_samples_per_ray_coarse", str(n_samples)]
    composite = os.path.join(REPO, "configs", "composite.txt")
    args = parse_args(["--config", composite, *common])
    fine_args = parse_args(["--config", composite, *common, *FINE_ARGV,
                            "--depth_samples_per_ray_fine", str(n_fine)])
    static_args = parse_args(["--config", STATIC_CONFIG, *common])
    tx = tr.make_optimizer(args.lr, args.lr_end_factor, args.lr_decay_steps)
    var_ids, non_var_ids = dpa_fine_split(pb, fine_args, device)
    ids = (var_ids, non_var_ids)
    out = {}
    for name, a, extra in (("two_kernel", args, {}), ("fine", fine_args, {}),
                           ("uneven", args, {"img_sample_size": n_rays - 1})):
        cfgs = tr.field_configs_from_args(a)
        hp = dataclasses.replace(tr.composite_hparams_from_args(a), **extra)
        hp = dataclasses.replace(hp, nb_var_rays=int(0.5 * hp.img_sample_size))
        out[name] = {"make": (lambda cfgs, hp: lambda mesh: make_composite_train_step(
                         cfgs, hp, tx, pb["z"], pb["i0"], mesh=mesh))(cfgs, hp),
                     "state": (lambda a, cfgs: lambda: tr._init_composite_state(
                         a, cfgs, tx, device))(a, cfgs),
                     "args": (pb["rays"], pb["phases"], *ids), "hp": hp, "cfgs": cfgs,
                     "z": pb["z"], "i0": pb["i0"], "k1": "fused_field_fwd",
                     "k2": "fused_field_bwd",
                     "per_step": 2 if name == "fine" else 1,
                     "n_steps": 1 if name == "uneven" else DP_STEPS}
    cfg = tr.static_config_from_args(static_args)
    shp = tr.static_hparams_from_args(static_args)
    stx = tr.make_optimizer(static_args.lr, static_args.lr_end_factor, static_args.lr_decay_steps)
    z_static = linspace_depths(*flagship_geometry()[1], n_samples, device=device)

    def static_state():
        key = prng.key(static_args.seed)
        params = {"static": init_static_field(key, cfg, device)}
        return TrainState(params=params, opt_state=init_opt_state(params), step=0, rng=key)

    zero = torch.zeros(1, dtype=torch.long, device=device)
    out["static"] = {"make": lambda mesh: make_static_train_step(cfg, shp, stx, z_static,
                                                                 pb["i0"], mesh=mesh),
                     "state": static_state, "args": (pb["rays"], pb["phases"], zero, zero),
                     "hp": shp, "k1": "fused_static_field_fwd",
                     "k2": "fused_static_field_bwd", "per_step": 1, "n_steps": DP_STEPS}
    return out


def dpa_fine_split(pb: dict, fine_args, device) -> tuple:
    """The ray table's ids split by the largest fine weight ``w`` of each
    ray (adjacent coarse-density differences at the shared depths, the
    initial coarse pair through K1): the lower three quarters, then the
    upper quarter."""
    import torch

    from nerfca_tpu_torch.ops.render import render_transmission_composite
    from nerfca_tpu_torch.train import trainer as tr
    from nerfca_tpu_torch.train.step import evaluate_fields, field_windows

    cfgs = tr.field_configs_from_args(fine_args)
    hp = tr.composite_hparams_from_args(fine_args)
    params = tr._init_composite_state(fine_args, cfgs, None, device).params
    rays, phases = pb["rays"], pb["phases"]
    windows = field_windows(cfgs, 0, device)
    top = []
    with torch.no_grad():
        for i in range(0, rays.shape[0], 8192):
            o, d = rays[i:i + 8192, 0].contiguous(), rays[i:i + 8192, 1].contiguous()
            s_raw, t_raw = evaluate_fields(params, o, d, pb["z"], phases[i:i + 8192], windows,
                                           cfgs, hp)
            i0 = torch.full((o.shape[0],), pb["i0"], device=device)
            _, s_sig, t_sig, _ = render_transmission_composite(s_raw, t_raw, i0, pb["z"])
            total = s_sig + t_sig
            top.append(torch.abs(total[:, 1:] - total[:, :-1]).amax(dim=1))
    # a stable sort: every process must draw the same split, ties included
    order = torch.argsort(torch.cat(top), stable=True)
    cut = 3 * order.numel() // 4
    return order[:cut].contiguous(), order[cut:].contiguous()


def dpa_argmax_rank(case: dict, device) -> dict:
    """Where the fine weights' arg-max of the fine case's first batch lies:
    its rank (rays ``[0, R/2)`` rank 0's, global ray 0 among them) and rank
    0's largest ``w`` over rank 1's, from the step's own draws and the
    coarse pair through K1."""
    import torch

    from nerfca_tpu_torch.ops.render import render_transmission_composite
    from nerfca_tpu_torch.ops.sampling import stratify_depths
    from nerfca_tpu_torch.train.step import (
        evaluate_fields, field_windows, sample_ray_batch, step_draws, to_device,
    )

    hp, cfgs, state = case["hp"], case["cfgs"], case["state"]()
    rays, phases, var_ids, non_var_ids = case["args"]
    z_base = case["z"]
    _, positions, _, t = step_draws(state.rng, hp, var_ids.shape[0], non_var_ids.shape[0],
                                    rays.shape[0], z_base.shape[0])
    positions, t = to_device(device, positions, t)
    batch = sample_ray_batch(rays, phases, var_ids, non_var_ids, positions, hp)
    z = stratify_depths(z_base, t_rand=t)
    windows = field_windows(cfgs, 0, device)
    with torch.no_grad():
        s_raw, t_raw = evaluate_fields(state.params, batch["origins"], batch["directions"], z,
                                       batch["phases"], windows, cfgs, hp)
        i0 = torch.full((hp.img_sample_size,), case["i0"], device=device)
        _, s_sig, t_sig, _ = render_transmission_composite(s_raw, t_raw, i0, z)
        total = s_sig + t_sig
        top = torch.abs(total[:, 1:] - total[:, :-1]).amax(dim=1)
    half = hp.img_sample_size // 2
    return {"argmax_rank": int(torch.argmax(top)) // half,
            "rank0_max_over_rank1": float(top[:half].max() / top[half:].max())}


def dpa_train(case: dict, mesh=None, nudge: int = 0) -> dict:
    """The case's steps from its fresh state, data-parallel over ``mesh``
    when given, the launch counts set to 0 just before and read just
    after: the losses, the launches, the first step's gradients and the
    final parameters flattened in ``param_items`` order, the final state.
    ``nudge`` 1 or -1: every parameter moved one ulp up or down first (the
    noise floor of a comparison between two runs)."""
    import torch

    from nerfca_tpu_torch.train import step as st

    step, state = case["make"](mesh), case["state"]()
    if nudge:
        with torch.no_grad():
            for _, t in st.param_items(state.params):
                t.copy_(torch.nextafter(t, torch.full_like(t, nudge * math.inf)))
    first, adam = [], st.adam_update

    def spy(params, opt_state, grads, *a, **k):
        if not first:
            first.append(torch.cat([g.reshape(-1) for g in grads]).cpu())
        return adam(params, opt_state, grads, *a, **k)

    st.adam_update = spy
    try:
        reset_launch_counts()
        losses = [float(step(state, *case["args"])["train_loss"])
                  for _ in range(case["n_steps"])]
        counts = launch_counts()
    finally:
        st.adam_update = adam
    flat = torch.cat([t.detach().reshape(-1) for _, t in st.param_items(state.params)]).cpu()
    return {"losses": losses, "launches": counts, "params": flat, "grads0": first[0],
            "state": state,
            "moments": [t.cpu() for t in state.opt_state["mu"] + state.opt_state["nu"]]}


def dpa_leaf_rel(state, got, want) -> dict:
    """Each leaf's max abs difference between two flat vectors in
    ``param_items`` order, over the leaf's scale (``tests/test_torch_fine.py``'s
    measure) and over K2's scale (max(leaf scale, 1e-2 x the global max),
    :func:`leaf_errors`): the worst coarse leaf under each, with its name,
    and the worst of the fine pair's."""
    from nerfca_tpu_torch.train.step import param_items

    items = param_items(state.params)
    sizes = [t.numel() for _, t in items]
    global_max = float(want.abs().max())
    out = {"coarse": 0.0, "coarse_leaf": "", "fine": 0.0, "k2": 0.0, "k2_leaf": ""}
    for (n, _), a, b in zip(items, got.split(sizes), want.split(sizes)):
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        rel, k2 = err / max(scale, 1e-30), err / max(scale, 1e-2 * global_max, 1e-30)
        if k2 >= out["k2"]:
            out["k2"], out["k2_leaf"] = k2, n
        if "_fine" in n:
            out["fine"] = max(out["fine"], rel)
        elif rel >= out["coarse"]:
            out["coarse"], out["coarse_leaf"] = rel, n
    return out


def dpa_check_launches(name: str, case: dict, launches: dict) -> None:
    """K1 and K2 launched ``per_step`` times a step, and no K3."""
    want = case["per_step"] * case["n_steps"]
    if (launches[case["k1"]] != want or launches[case["k2"]] != want
            or launches["fused_train_loss"]):
        raise AssertionError(f"{name}: expected {case['k1']}/{case['k2']} {want} times each and "
                             f"no K3, got {launches}")


def dpa_rank(rank: int, world: int, port: int, out_dir: str, device: str = "cuda",
             n_rays: int = 1024, n_samples: int = 500, n_fine: int = FINE_SAMPLES) -> None:
    """One rank of phase 4n (``DP_WORLD`` processes over gloo, one card):
    every case of :func:`dpa_problems` under the mesh. Writes
    ``dpa_rank<rank>.pt`` under ``out_dir``."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.parallel import make_mesh, multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device=device)
    dev = torch.device(device)
    cases = dpa_problems(dev, n_rays, n_samples, n_fine)
    res: dict = {"rank": rank}
    for name, case in cases.items():
        run = dpa_train(case, mesh)
        res[name] = {k: run[k] for k in ("losses", "launches", "params", "grads0")}
    torch.save(res, os.path.join(out_dir, f"dpa_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def data_parallel_autograd_phase(workdir: str, device: str = "cuda", n_rays: int = 1024,
                                 n_samples: int = 500, n_fine: int = FINE_SAMPLES) -> dict:
    """Phase 4n, the autograd train paths under data parallelism at full
    width (K1/K2, no K3): (1) world 1 over NCCL in this process, DP_STEPS
    mesh steps of the two-kernel and the static step against the same
    steps without a mesh, bit for bit (losses, parameters, Adam moments,
    key); (2) ``DP_WORLD`` ranks over gloo on the one card, spawned, every
    case of :func:`dpa_problems`: the ranks' parameters bitwise equal, the
    losses within ``LOSS_REL`` of the single-card steps from the same
    state, the first step's gradients and the parameters after the steps
    within K2's gate of theirs, and each rank launching K1/K2 as the
    single-card step does. The fine case's first batch holds its arg-max
    of ``w`` on rank 1, global ray 0 on rank 0; its gradients and
    parameters (the coarse pair and the fine pair, each leaf over its
    scale) must also lie within the floor measured in the same call: the
    single card against itself with every parameter one ulp up (the fine
    depths amplify the last bits of the coarse densities, ROADMAP §3). The
    kernels are built before the ranks start. Raises on any failure."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.parallel import make_mesh, multihost

    dev = torch.device(device)
    cases = dpa_problems(dev, n_rays, n_samples, n_fine)
    res: dict = {"fine_split": dpa_argmax_rank(cases["fine"], dev),
                 "world1_backend": "nccl" if device == "cuda" else "gloo"}
    if res["fine_split"]["argmax_rank"] != 1:
        raise AssertionError(f"phase 4n: the fine batch's arg-max of w is not on rank 1: "
                             f"{res['fine_split']}")
    single = {}
    for name, case in cases.items():
        run = dpa_train(case)
        if device == "cuda":
            dpa_check_launches(name, case, run["launches"])
        single[name] = run
    res["single_losses"] = {k: v["losses"] for k, v in single.items()}
    # the fine pass's floors: the single card against itself, run again and
    # with every parameter one ulp up (sample_pdf's weights are differences
    # of nearly equal coarse densities, ROADMAP §3)
    res["fine_floor"] = {}
    for tag, nudge in (("again", 0), ("ulp_up", 1), ("ulp_down", -1)):
        run = dpa_train(cases["fine"], nudge=nudge)
        res["fine_floor"][tag] = {
            "grads0": dpa_leaf_rel(run["state"], run["grads0"], single["fine"]["grads0"]),
            "params": dpa_leaf_rel(run["state"], run["params"], single["fine"]["params"])}
    res["fine_floor"]["one_ulp"] = {
        what: {part: max(res["fine_floor"][t][what][part] for t in ("ulp_up", "ulp_down"))
               for part in ("coarse", "fine")} for what in ("grads0", "params")}
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend=res["world1_backend"])
    try:
        mesh = make_mesh(device=device)
        res["world1_bitwise"] = {}
        for name in ("two_kernel", "static"):
            one, ref = dpa_train(cases[name], mesh), single[name]
            res["world1_bitwise"][name] = (
                one["losses"] == ref["losses"] and torch.equal(one["params"], ref["params"])
                and all(torch.equal(a, b) for a, b in zip(one["moments"], ref["moments"]))
                and np.array_equal(one["state"].rng, ref["state"].rng))
            if not res["world1_bitwise"][name]:
                raise AssertionError(f"phase 4n world 1: the {name} mesh step differs from the "
                                     f"unsharded step ({one['losses']} vs {ref['losses']})")
    finally:
        dist.destroy_process_group()

    out_dir = os.path.join(workdir, "dpa")
    os.makedirs(out_dir, exist_ok=True)
    spawn_ranks(dpa_rank, out_dir, device, n_rays, n_samples, n_fine)
    ranks = [torch.load(os.path.join(out_dir, f"dpa_rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    res["cases"], failures = {}, []
    for name, case in cases.items():
        ref = single[name]
        got = ranks[0][name]
        if not all(torch.equal(got["params"], r[name]["params"]) for r in ranks[1:]):
            failures.append(f"{name}: the ranks' parameters differ")
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
        entry = {"loss_rel": rel, "grads0": dpa_leaf_rel(ref["state"], got["grads0"],
                                                         ref["grads0"]),
                 "params": dpa_leaf_rel(ref["state"], got["params"], ref["params"]),
                 "launches": [r[name]["launches"] for r in ranks]}
        res["cases"][name] = entry
        if not all(math.isfinite(x) and x <= LOSS_REL for x in rel):
            failures.append(f"{name}: losses {got['losses']} vs single-card {ref['losses']}")
        # the first step's gradients (same state, same batch) and the
        # parameters after the steps under K2's gate; the fine pass's also
        # within what one ulp on every parameter moves the single card's run
        # (its fine depths amplify the last bits of the coarse densities)
        g0, pr = entry["grads0"], entry["params"]
        if max(g0["k2"], pr["k2"]) > K2_REL:
            failures.append(f"{name}: gradients or parameters off the single-card ones")
        if name == "fine":
            floor = res["fine_floor"]["one_ulp"]
            over = [f"{what} {part}" for what in ("grads0", "params") for part in ("coarse", "fine")
                    if entry[what][part] > floor[what][part]]
            if over:
                failures.append(f"{name}: beyond the one-ulp floor: {over}")
        if device == "cuda":
            for r in ranks:
                dpa_check_launches(f"{name} rank {r['rank']}", case, r[name]["launches"])
    if failures:
        raise AssertionError(f"phase 4n: {failures}; {json.dumps(res, default=str)}")
    return res


def report_dpa(dpa: dict, card: str) -> None:
    """Print phase 4n."""
    split = dpa["fine_split"]
    log(f"data parallel, autograd paths ({card}): world 1 over {dpa['world1_backend']}, "
        f"bitwise the unsharded steps {dpa['world1_bitwise']}; world {DP_WORLD} over gloo on "
        f"the one card; the fine batch's arg-max "
        f"of w on rank {split['argmax_rank']} (rank 0's max {split['rank0_max_over_rank1']:.3e} "
        f"of it)")

    def rel(r):
        return (f"{r['coarse']:.3e} of leaf scale ({r['coarse_leaf']}), fine pair "
                f"{r['fine']:.3e}, {r['k2']:.3e} of K2's scale ({r['k2_leaf']})")

    for name, c in dpa["cases"].items():
        log(f"  {name}: loss rel vs single card {[f'{x:.2e}' for x in c['loss_rel']]} (limit "
            f"{LOSS_REL}); first-step gradients {rel(c['grads0'])}; parameters after the steps "
            f"{rel(c['params'])}; ranks' parameters bitwise equal; launches per rank "
            f"{[{k: v for k, v in l.items() if v} for l in c['launches']]}")
    for tag, what in (("again", "run again"), ("ulp_up", "every parameter one ulp up"),
                      ("ulp_down", "every parameter one ulp down")):
        fl = dpa["fine_floor"][tag]
        log(f"  fine floor, the single card against itself, {what}: first-step gradients "
            f"{rel(fl['grads0'])}; parameters after {DP_STEPS} steps {rel(fl['params'])}")


def static_cfg(fourier: bool = False):
    """The static field of ``configs/3d.txt`` (``--static_pos_enc fourier``
    with ``fourier``: its sigma 2, basis 12)."""
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.trainer import static_config_from_args

    extra = ["--static_pos_enc", "fourier"] if fourier else []
    return static_config_from_args(parse_args(["--config", STATIC_CONFIG, *extra]))


def check_static_entries(params_static, window, fourier: bool = False, n_rays: int = 1024,
                         n_samples: int = 500, seed: int = 0) -> dict:
    """The static method's entries against their plain twins at the full
    shapes of ``configs/3d.txt`` (``n_rays`` x ``n_samples`` points of the
    flagship view): ``fused_static_field`` (the one-field K1/K2) on
    ``params_static`` under ``window``, and the two-field point form
    ``fused_composite_fields`` (the flagship pair, every band open) against
    ``plain_composite_fields``. Forward within K1_ATOL, gradients by K2's
    rule. With ``fourier`` the fields take the fourier encoding
    (``configs/3d.txt --static_pos_enc fourier``, the flagship pair at sigma
    2). Raises on a disagreement."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    dev = torch.device("cuda")
    cfg = static_cfg(fourier)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    params_static = {"early": [{k: leaf(v) for k, v in layer.items()}
                               for layer in params_static["early"]],
                     "out": {k: leaf(v) for k, v in params_static["out"].items()},
                     **{k: v.detach() for k, v in params_static.items() if k == "fourier"}}
    names, leaves = trained_leaves({"static": params_static})
    origins, dirs, z, phases = flagship_rays(n_rays, n_samples, seed + 4, dev)
    with torch.no_grad():
        pts = ff._points(origins, dirs, z).contiguous()
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    cot = torch.randn(n_rays, n_samples, 1, generator=g, device=dev)

    def fwd_bwd(fn, *args):
        out = fn(*args)
        return out, torch.autograd.grad((out * cot).sum(), leaves)

    k_out, k_g = fwd_bwd(ff.fused_static_field, params_static, pts, cfg, window)
    p_out, p_g = fwd_bwd(ff.plain_static_field, params_static, pts, cfg, window)
    torch.cuda.synchronize()
    k1_err = float((k_out - p_out).detach().abs().max())
    if not (math.isfinite(k1_err) and k1_err <= K1_ATOL):
        raise AssertionError(f"fused_static_field disagrees: {k1_err:.3e} > {K1_ATOL}")
    k2_err, k2_norm, worst = leaf_errors(names, k_g, p_g)
    res = {"k1_err": k1_err, "k2_err": k2_err, "k2_norm": k2_norm, "k2_worst": worst}

    # the point form with both flagship fields on the same points
    cfg_s, cfg_t = flagship_cfgs(fourier)
    fp = flagship_params(seed + 6, dev, fourier)
    f_names, f_leaves = trained_leaves(fp)
    pph = phases[:, None].expand(n_rays, n_samples)
    w12 = None if fourier else torch.ones(12, device=dev)
    pargs = (fp["static"], fp["temp"], pts, pph, cfg_s, cfg_t, w12, w12)
    cot2 = torch.randn(2, n_rays, n_samples, 1, generator=g, device=dev)

    def fwd_bwd2(fn):
        out = fn(*pargs)
        return out, torch.autograd.grad((out[0] * cot2[0]).sum() + (out[1] * cot2[1]).sum(),
                                        f_leaves)

    kp_out, kp_g = fwd_bwd2(ff.fused_composite_fields)
    pp_out, pp_g = fwd_bwd2(ff.plain_composite_fields)
    torch.cuda.synchronize()
    res["point_k1_err"] = max(float((a - b).detach().abs().max())
                              for a, b in zip(kp_out, pp_out))
    if not (math.isfinite(res["point_k1_err"]) and res["point_k1_err"] <= K1_ATOL):
        raise AssertionError(f"point form disagrees: {res['point_k1_err']:.3e} > {K1_ATOL}")
    res["point_k2_err"], res["point_k2_norm"], res["point_k2_worst"] = leaf_errors(
        f_names, kp_g, pp_g)
    return res


def static_phase(workdir: str, fourier: bool = False) -> dict:
    """Phase 4d: the static 3-D method through ``run_nerf.main`` on
    ``configs/3d.txt`` at full width with ``--use_pallas true`` (its own
    one-phase 128^3 dataset, ``STATIC_STEPS`` steps, an eval every
    ``STATIC_EVERY``), launch counts set to 0 just before and read just
    after: the one-field K1 and K2 once a step, no composite launch and no
    K3; each eval view one one-field K1 on rays and one ``eval_static`` a
    4096-ray tile, no torch composite, the first eval view captured as a
    CUDA graph and each later one replayed. Then the step-0 eval (the seed's initial field, as the trainer's
    eval scores it) and the entries against their plain versions at the
    trained state. With ``fourier`` (phase 4f): ``configs/3d.txt
    --static_pos_enc fourier`` on the same dataset, ``FOURIER_STATIC_STEPS``
    steps, an eval every ``FOURIER_STATIC_EVERY``, held against its own JAX
    record. Raises on any failure."""
    import torch

    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.train import evaluation
    from nerfca_tpu_torch.train.step import field_window

    steps, every = ((FOURIER_STATIC_STEPS, FOURIER_STATIC_EVERY) if fourier
                    else (STATIC_STEPS, STATIC_EVERY))
    argv = ["--config", STATIC_CONFIG, "--use_pallas", "true", "--platform", "cuda",
            "--n_iters", str(steps), "--display_every", str(every), "--seed", "0",
            "--log_every", "1", "--data_root", os.path.join(workdir, "data-static"),
            "--log_dir_root", os.path.join(workdir, "cases-static" + ("-fourier" * fourier)),
            *(["--static_pos_enc", "fourier"] if fourier else [])]
    res = counted_run(argv, static=True)
    out, tl = res["run"], res["train_launches"]
    n_total = steps + 1
    if out["diverged_at"] is not None or out["final_step"] != n_total:
        raise AssertionError(f"static: diverged at {out['diverged_at']}, final step "
                             f"{out['final_step']}")
    if len(res["train"]) != n_total or not all(math.isfinite(r["train_loss"])
                                               for r in res["train"]):
        raise AssertionError(f"static: {len(res['train'])} logged steps, not all finite")
    if (tl["fused_static_field_fwd"] != n_total or tl["fused_static_field_bwd"] != n_total
            or tl["fused_field_fwd"] or tl["fused_field_bwd"] or tl["fused_train_loss"]):
        raise AssertionError(f"static: expected the one-field K1 and K2 once a step and no "
                             f"other launch: {tl}")
    if [r["step"] for r in res["evals"]] != list(range(every, n_total, every)):
        raise AssertionError(f"static: evals at {[r['step'] for r in res['evals']]}")
    # each eval view one one-field K1 on rays and one Beer-Lambert launch a
    # 4096-ray tile, no torch composite and no two-field launch
    el, view_rays = res["eval_launches"], int(out["setup"]["test_view"]["origins"].shape[0])
    n_tiles = len(res["evals"]) * -(-view_rays // 4096)
    if (el.get("fused_static_field_fwd.rays") != n_tiles
            or el.get("fused_static_field_fwd") != n_tiles
            or el.get("eval_static.kernel") != n_tiles or el.get("eval_composite.torch")
            or el.get("eval_composite.kernel") or el.get("fused_field_fwd")):
        raise AssertionError(f"static: expected {n_tiles} one-field K1 and eval_static "
                             f"launches in the evals and no other: {el}")
    check_eval_graphs("static", res)

    setup, state = out["setup"], out["state"]
    cfg, view = setup["cfg"], setup["test_view"]
    w, h = view["shape"]
    gt = view["image"].cpu().numpy()

    def eval_psnr(params, step):
        render = evaluation.render_static_test_view(
            params, view["origins"], view["directions"], setup["test_depths"], step, cfg,
            setup["hp"], setup["max_pixel_value"])
        pred = render["pix_static"].cpu().numpy()
        return evaluation.image_psnr(pred.reshape(w, h), gt.reshape(w, h))

    init = {"static": init_static_field(prng.key(0), cfg, torch.device("cuda"))}
    psnr = {0: eval_psnr(init, 0), **{r["step"]: r["test_image_psnr"] for r in res["evals"]}}
    loss = {r["step"]: r["train_loss"] for r in res["train"]}
    with open(os.path.join(out["log_dir"], "checkpoint", "metadata.json")) as f:
        meta = json.load(f)
    if list(meta["field_configs"]) != ["static"] or meta["run"]["step"] != n_total:
        raise AssertionError(f"static: checkpoint metadata {meta}")

    trained = check_static_entries(state.params["static"],
                                   field_window(cfg, state.step, torch.device("cuda")),
                                   fourier=fourier)
    return {"res": res, "loss": loss, "psnr": psnr, "trained": trained, "steps": steps,
            "fourier": fourier, "record": JAX_STATIC_FOURIER if fourier else JAX_STATIC,
            "n_total": n_total, "meta_run": meta["run"],
            "rays": int(setup["device_data"]["rays"].shape[0]), "view": [w, h]}


def report_static(sp: dict, card: str) -> bool:
    """Print phase 4d (4f) beside the JAX record; True when both gates pass."""
    with open(sp["record"]) as f:
        rec = json.load(f)
    res, loss, psnr = sp["res"], sp["loss"], sp["psnr"]
    what = "configs/3d.txt --static_pos_enc fourier" if sp["fourier"] else "configs/3d.txt"
    log(f"static 3-D method ({what}, run_nerf, {sp['steps']} steps; {card}): "
        f"{sp['rays']} rays, view {sp['view']}")
    log(f"  launches: training {res['train_launches']}, in-loop evals {res['eval_launches']}")
    for s in sorted(int(k) for k in rec["train_loss"]):
        log(f"  step {s}: train_loss {loss[s]:.7g} (JAX {rec['train_loss'][str(s)]:.7g}), "
            f"test_image_psnr {psnr[s]:.4f} dB (JAX {rec['test_image_psnr'][str(s)]:.4f})")
    loss0_rel = abs(loss[0] - rec["train_loss"]["0"]) / abs(rec["train_loss"]["0"])
    last = sp["steps"]
    psnr_gap = abs(psnr[last] - rec["test_image_psnr"][str(last)])
    passed = loss0_rel <= GATE_STATIC_LOSS0_REL and psnr_gap <= GATE_STATIC_PSNR_DB
    tr = sp["trained"]
    log(f"  at the trained state: fused_static_field max abs err {tr['k1_err']:.3e} (limit "
        f"{K1_ATOL}), grads max abs err {tr['k2_err']:.3e}, worst leaf {tr['k2_worst']} at "
        f"{tr['k2_norm']:.3e} of its scale (limit {K2_REL}); point form {tr['point_k1_err']:.3e}"
        f" / {tr['point_k2_norm']:.3e}")
    log(f"  gates against the JAX record: step-0 train_loss rel {loss0_rel:.3e} <= "
        f"{GATE_STATIC_LOSS0_REL} and step-{last} test_image_psnr gap {psnr_gap:.4f} dB <= "
        f"{GATE_STATIC_PSNR_DB}: {'passed' if passed else 'FAILED'}")
    return passed


def main() -> int:
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in a native library prints where Python was

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "nerfca_tpu_torch")):
        print("chip_smoke: the nerfca_tpu_torch package is not next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from nerfca_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")

    built = build.build(verbose=True)
    log(f"kernel build: {', '.join(built)}, in parallel")
    for name, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    ff_lib = build.load("fused_field")
    log(f"  shared memory per CTA: K1 {ff_lib.fused_field_smem_bytes(0)} bytes, K2 "
        f"{ff_lib.fused_field_smem_bytes(1)} bytes, loss kernel "
        f"{build.load('fused_train').fused_train_smem_bytes(500)} bytes at 500 samples")

    kernels = kernel_checks()
    log(f"kernels against their plain versions and twins at the flagship shapes ({card}): "
        f"{len(kernels)} of {len(kernels)} within their gates")
    print("kernels " + json.dumps(kernels), flush=True)

    with tempfile.TemporaryDirectory() as workdir, VolumeBuilds(workdir) as vb:
        mp = drive_main_path(workdir, [], 6)
        tl = mp["train_launches"]
        if tl["fused_field_fwd"] < 1 or tl["fused_field_bwd"] < 1:
            raise AssertionError(f"K1/K2 not launched during training: {tl}")
        log(f"main path, two kernels: train_loss {[round(r['train_loss'], 6) for r in mp['train']]}")
        log(f"  launches: training {tl}, eval {mp['eval_launches']}; test_image_psnr "
            f"{mp['eval']['test_image_psnr']:.3f}")

        fp = drive_main_path(workdir, ["--use_fused_loss", "true"], 6)
        tl = fp["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_bwd"] != 6
                or tl["fused_field_fwd"] != 6):
            raise AssertionError(f"the fused-loss path did not run K1, the loss kernel and K2 "
                                 f"once on every step: {tl}")
        log(f"main path, fused loss (K3): train_loss "
            f"{[round(r['train_loss'], 6) for r in fp['train']]}")
        log(f"  launches: training {tl}, eval {fp['eval_launches']}; test_image_psnr "
            f"{fp['eval']['test_image_psnr']:.3f}")

        # phase 4e: the fourier composite through K3 on the flagship dataset
        fc = drive_main_path(workdir, ["--use_fused_loss", "true", *FOURIER_ARGV], 6)
        tl = fc["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_bwd"] != 6
                or tl["fused_field_fwd"] != 6):
            raise AssertionError(f"the fourier composite did not run K3 once a step: {tl}")
        log(f"main path, fourier composite (both fields fourier, sigma 2, K3): train_loss "
            f"{[round(r['train_loss'], 6) for r in fc['train']]}")
        log(f"  launches: training {tl}, eval {fc['eval_launches']}; test_image_psnr "
            f"{fc['eval']['test_image_psnr']:.3f}")

        # phases 4h and 4i: bf16 compute, then bf16 residual storage, through
        # K3 on the flagship dataset
        bp = drive_main_path(workdir, ["--use_fused_loss", "true", "--compute_dtype",
                                       "bfloat16"], 6, k1_key="fused_field_fwd_bf16")
        tl, el = bp["train_launches"], bp["eval_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_fwd_bf16"] != 6
                or tl["fused_field_bwd_bf16"] != 6 or tl["fused_field_fwd"]
                or tl["fused_field_bwd"] or el.get("fused_field_fwd_bf16") != 10
                or el.get("fused_field_fwd")):
            raise AssertionError(f"bf16 main path: expected one bf16 K3 a step and 10 bf16 K1 "
                                 f"in the eval: {tl}, {el}")
        log(f"main path, bf16 compute (K3 bf16): train_loss "
            f"{[round(r['train_loss'], 6) for r in bp['train']]}")
        log(f"  launches: training {tl}, eval {el}; test_image_psnr "
            f"{bp['eval']['test_image_psnr']:.3f}")
        rp = drive_main_path(workdir, ["--use_fused_loss", "true", "--pallas_bf16_residuals",
                                       "true"], 6)
        tl = rp["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_fwd"] != 6
                or tl["fused_field_bwd_res_bf16"] != 6 or tl["fused_field_bwd"]):
            raise AssertionError(f"bf16 residual main path: expected K1, the loss kernel and "
                                 f"the residual K2 once a step: {tl}")
        log(f"main path, bf16 residuals (K3 over the bf16 scratch): train_loss "
            f"{[round(r['train_loss'], 6) for r in rp['train']]} (f32 K3: "
            f"{[round(r['train_loss'], 6) for r in fp['train']]})")
        log(f"  launches: training {tl}, eval {rp['eval_launches']}; test_image_psnr "
            f"{rp['eval']['test_image_psnr']:.3f}")

        # phases 4j and 4j': the fine pass, on K1/K2 with a 128-wide fine
        # pair and plain with the shipped 64-wide one
        fine = fine_phase(workdir)
        if not report_fine(fine, card):
            raise AssertionError("fine pass: the run is outside the gates against the JAX record")
        sfp = shipped_fine_phase(workdir)
        log(f"shipped 64-wide fine pair ({FINE_SAMPLES} fine samples, --use_fused_loss true): "
            f"warned: {sfp['warning']!r}; train_loss "
            f"{[round(r['train_loss'], 6) for r in sfp['train']]}")
        log(f"  launches: training {sfp['train_launches']}, eval {sfp['eval_launches']}; "
            f"test_image_psnr {sfp['eval']['test_image_psnr']:.3f}, test_image_psnr_fine "
            f"{sfp['eval']['test_image_psnr_fine']:.3f}")

        cp = clean_protocol_phase(workdir)
        report_clean_protocol(cp, card)
        if not cp["gate_passed"]:
            raise AssertionError("clean protocol: checkpoint-1000 is under the quality gate")
        legs = {"res": clean_leg(workdir, ["--pallas_bf16_residuals", "true"], "res",
                                 "fused_field_bwd_res_bf16"),
                "bf16": clean_leg(workdir, ["--compute_dtype", "bfloat16"], "bf16",
                                  "fused_field_bwd_bf16")}
        for tag, what in (("res", "--pallas_bf16_residuals true"),
                          ("bf16", "--compute_dtype bfloat16")):
            report_clean_leg(legs[tag], what, cp["scores"][1000], card)

        # phase 4k: a hyperband sweep through run_composite on 4c's dataset
        sw = sweep_phase(workdir)
        hb = sw["results"]["hyperband"]
        log(f"sweep (configs/sweep-4view-data.yaml's grid, hyperband max_iter {SWEEP_MAX_ITER}, "
            f"configs/synth-4view-best.txt; {card}): {len(sw['runs'])} runs; rungs "
            f"{hb['rung_iters']}, promoted {[r.get('promoted') for r in hb['rungs']]}; scores "
            f"{[r['scores'] for r in hb['rungs']]}")
        runs = [(r["steps"][0], r["steps"][-1], r["launches"]["fused_train_loss"],
                 bool(r["resume_from"])) for r in sw["runs"]]
        log(f"  runs (first and last step, K3 launches, resumed): {runs}")

        # phases 4l, 4l' and 4m: non-SYNTH data, the volumes built in the
        # background since the first main path
        non_synth_phases(workdir, vb, card)

        sp = static_phase(workdir)
        if not report_static(sp, card):
            raise AssertionError("static: the run is outside the gates against the JAX record")
        fsp = static_phase(workdir, fourier=True)
        if not report_static(fsp, card):
            raise AssertionError("static fourier: the run is outside the gates against the JAX "
                                 "record")

        dp = data_parallel_phase(workdir)
        r0 = dp["ranks"][0]
        log(f"data parallel ({card}): world 1 over NCCL, the sharded entry equals K3 bitwise: "
            f"{dp['world1_bitwise']}; world {DP_WORLD} over gloo on the one card: sharded K3 vs "
            f"K3 on the whole batch, per rank {[round(r['loss_rel'], 9) for r in dp['ranks']]} "
            f"loss rel, grads worst {[round(r['norm'], 6) for r in dp['ranks']]} of their scale; "
            f"vs the plain version, {[round(r['loss_rel_vs_plain'], 9) for r in dp['ranks']]} "
            f"loss rel, grads worst {[round(r['norm_vs_plain'], 6) for r in dp['ranks']]}; "
            f"{DP_STEPS} steps: parameters bitwise equal across ranks "
            f"{dp['params_bitwise_equal']}, losses {r0['losses']} vs single-card "
            f"{dp['single_losses']} (rel {[f'{x:.2e}' for x in dp['loss_rel_vs_single']]}); "
            f"launches per rank {[r['launches'] for r in dp['ranks']]}")

        # phase 4n: the autograd paths (K1/K2, the fine pass, the static
        # step) under data parallelism
        report_dpa(data_parallel_autograd_phase(workdir), card)

    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
