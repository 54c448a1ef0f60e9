#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the environment (torch, CUDA, the card and its power limit);
2. builds the CUDA kernels from ``nerfca_tpu_torch/csrc`` (one nvcc per
   source, started together);
3. holds each kernel against its plain PyTorch version at the flagship
   shapes (1024 rays x 500 samples, two 4x128 fields, basis 12, 8-d
   latents, every band open) and times both with CUDA events: K1 and K2,
   then K3 (``fused_train_loss_and_grads``: K1, the loss kernel, K2)
   without and with a random motion-hull gate that leaves some rays empty,
   and K3's forward and loss phase apart; then the static method's
   entries at ``configs/3d.txt``'s field on the same points:
   ``fused_static_field`` (the one-field K1/K2) and the two-field point
   form ``fused_composite_fields``, timed in turns with the composite K1/K2;
   then the same K1/K2, K3 and static checks with every field on the
   fourier encoding (basis 12, sigma 2: the kernels' FOURIER instantiations);
   then bf16 compute: the BF16 instantiations of K1 and K2 (two fields,
   one field, free_windowed and fourier) and K3 against their bf16 twin,
   and bf16 residual storage: K3 and its K2 over the bf16 scratch against
   theirs, each under ``BF16_GATE`` (below); then K1 and K2 at the fine
   pass's shapes (1024 rays x 628 sorted per-ray depths from ``sample_pdf``);
4. drives the main paths through ``nerfca_tpu_torch.train.run_composite.main``,
   each with the launch counts set to 0 just before and read just after:
   a. the two-kernel step (``configs/composite.txt --use_pallas true``):
      builds the flagship SYNTH dataset on the card, 6 train steps, one eval
      view; K1 and K2 must run in training and K1 in the eval render;
   b. the fused-loss step (``--use_fused_loss true``) on that dataset: 6
      steps and one eval view; K1, the loss kernel and K2 must run once on
      every step, K1 in the eval;
   c. the clean-protocol reconstruction, ``configs/synth-4view-best.txt``
      (SYNTH-FOVHC at 96^3, 4 views, the motion hull, K3, ray jitter,
      selection view 0,0, ``best_metric separated_psnr``) for 1000 steps:
      finite steps with K3 on each, a non-empty hull, checkpoints 500, 1000
      and 1001 with checkpoint-best at the highest selection metric; a
      resume from checkpoint-500 whose checkpoint-1000 equals the first
      run's bitwise; ``run_eval`` of checkpoints 500 and 1000 over the 40
      views of evaluate.json and ``run_render`` of two views of
      checkpoint-best; checkpoint-1000 must pass the quality gate
      (``GATE_PSNR``, ``GATE_DYN_CORR``), printed beside the JAX record;
   d. the static 3-D method through ``run_nerf.main`` on ``configs/3d.txt``
      (its own one-phase 128^3 dataset, ``STATIC_STEPS`` steps): the
      one-field K1 and K2 once a step and nothing else; the train loss and
      ``test_image_psnr`` at steps 0, 100, 200 beside the JAX record
      (``JAX_STATIC``), gated (``GATE_STATIC_LOSS0_REL``,
      ``GATE_STATIC_PSNR_DB``); the entries against their twins at the
      trained state; the warm step, kernels and plain, and the eval view;
   e. the fourier composite (``configs/composite.txt`` with both fields on
      the fourier encoding, sigma 2, ``--use_fused_loss true``) on the
      flagship dataset: 6 steps and one eval, K3 once a step;
   f. ``configs/3d.txt --static_pos_enc fourier`` through ``run_nerf.main``
      on phase d's dataset, ``FOURIER_STATIC_STEPS`` steps, under phase d's
      gates against its own JAX record (``JAX_STATIC_FOURIER``);
   h. bf16 compute (``--compute_dtype bfloat16``) and i. bf16 residual
      storage (``--pallas_bf16_residuals true``) through K3 on the flagship
      dataset, 6 steps and one eval view each: one K3 a step with the bf16
      K1 and K2 (10 bf16 K1 in the eval), or with K2 over bf16 residuals;
   c'. after phase c, the same clean protocol once with
      ``--pallas_bf16_residuals true`` and once with ``--compute_dtype
      bfloat16`` (1000 steps each on phase c's dataset, ``run_eval`` of
      checkpoint-1000 beside the f32 run's; gated on finite values and on
      the selection view's PSNR rising from step 0);
   j. the fine pass: ``configs/composite.txt`` with 128 fine samples a ray
      and a 128-wide fine pair, ``--use_fused_loss true``, on the flagship
      dataset, 10 steps and an eval: no K3 (it has no fine pass), K1 and
      K2 twice a step (the coarse pair, then the fine pair at per-ray
      depths); the step-0 loss and the step-10 PSNRs (coarse and fine)
      held against the JAX record (``JAX_FINE``) under phase d's gates;
      the warm fine step, kernels and plain, and the eval view;
   j'. the shipped 64-wide fine pair: 6 steps and an eval; the trainer warns
      that the fine pair lies outside the envelope, the coarse pair keeps
      K1/K2 and the fine pass runs plain;
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
      printed beside the JAX round-5 record, the warm K3 + hull step and
      eval view on this data; (c) the native C++ projector against the
      card's on one view (``NATIVE_ATOL``);
   l'. ``--use_experiment_name true --experiment_name one-frame-resp`` on
      those volumes: 6 K3 steps and one eval;
   m. XCAT-SURR: the XCAT driver contract at 512 x 512 x 401 through the
      port's stand-in ``dxcat1_bin`` for 2 phases (in the background), the
      XCAT preset's dataset, 6 K3 steps and one eval;
   g. data parallelism at the flagship widths: world 1 over NCCL in this
      process (the sharded K3 entry equals K3 bitwise), then ``DP_WORLD``
      ranks over gloo on the one card in spawned processes (the sharded K3
      within K3's gate of the whole batch's, its parts timed, ``DP_STEPS``
      data-parallel steps with the ranks' parameters bitwise equal and the
      losses within ``LOSS_REL`` of the single-card steps);
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
      per rank as the single-card step launches them; the two-kernel
      step's parts timed against the single-card step;
5. times the warm flagship step and eval render on the flagship dataset,
   in turns: K3, K1+K2, plain, K3+hull (the clean-protocol hull), K3 under
   bf16 compute, K3 over bf16 residuals, then in the reverse order, and
   prints phase l's K3 + hull step, eval view and dataset build beside
   the flagship's; the same for the fourier composite (K3, K1+K2, plain);
6. profiles three K3 steps with ``torch.profiler`` (device time by kernel);
7. prints one ``{"kernels": [...]}`` line, the card's name and power limit,
   and last the result line.

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
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# tolerances, stated with their reasons
K1_ATOL = 2e-4   # f32 raw densities; only the matmul summation order differs
K2_REL = 2e-2    # per-leaf grads vs max(leaf scale, 1e-2 x global max), bench.py:93-116
LOSS_REL = 1e-3  # loss and each K3 term: f32 sums over rays in another order (bench.py rule)
RENDER_REL = 1e-4  # rendered intensities, of I0: integrals of K1's raw densities (each K1_ATOL)

# bf16 compute and bf16 residual storage, gates set before the first card
# run of these kernels. The bf16 kernels take bf16 operands and f32 sums, as
# their twin does (fused_field.twin_*), so only the f32 summation order, and
# the rare bf16 rounding of an activation that it flips, separate them. Each
# statistic of a bf16 kernel against its twin must lie within BF16_GATE of
# the same statistic between the bf16 and the f32 twins on the same inputs,
# measured in the same call, so that an f32 kernel cannot pass it: the mean
# |difference| of each field's raw densities (a flip moves one point by up
# to ~2e-3 of scale and no other, so the max is no test of the route; by
# the mean a CPU emulation of the kernel sits ~1e-3 of the way to f32), and
# the worst leaf of the gradients by K2's normalization, K2's and K3's
# (emulated: ~4e-4 and ~5e-3 of the way). K3's loss and terms come from the
# f32 loss kernel on bf16 K1's raw densities, and bf16 moves them by only
# ~4e-6 (the loss) to ~1e-4 (the worst term) relative, no more than the f32
# sums' order does, so they are held by the f32 K3's LOSS_REL and only
# reported beside their gap; the bf16 gate of K3 is its gradients'. bf16
# residual storage keeps K3's loss and terms bit for bit and every leaf
# whose gradient reads no stored activation. K2 over bf16 residuals is held
# at the flagship shapes on seeded unit-normal cotangents: each other
# leaf's change from the f32 K2, dk, must carry the twin's change, dt (the
# twin's backward with and without the rounding, the same sums apart from
# it): the share beta = <dk, dt> / <dt, dt> within BF16_GATE of 1 (an f32
# kernel changes nothing and sits at 0). On K3's own cotangents the
# rounding moves a hidden layer's gradient by ~1e-5 of its norm, below the
# f32 K2's own distance from the twin there (~5e-5), so no gate can tell
# the two apart: K3's gradients under bf16 residuals are held against the
# twin by the f32 K3's rule, and the share on K3's cotangents is only
# reported. Two earlier forms of the gate failed on the card before this
# one was set: |dk - dt| within BF16_GATE of |dt| (0.16 at the last hidden
# layer: the f32 sums that separate the kernel's forward from the twin's
# make ~0.2% of the stored activations round the other way, which moves
# dk - dt by that much but beta by ~1%), and beta on K3's own cotangents
# (off by 2.6, as above).
BF16_GATE = 0.1

# the card's peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W)
PEAK_F32_FLOPS = 67e12    # f32 outside the tensor cores: the f32 bound beside each kernel
PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores: K1's and K2's mma.sync, 3 per product
PEAK_BF16_FLOPS = 989e12  # dense BF16 on the tensor cores: the bf16 instantiations, 1 per product
PEAK_BYTES = 3.35e12      # HBM3


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
# under phase 4d's gates
FOURIER_STATIC_STEPS = 100
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


def wall_ms(fn, n: int) -> float:
    """Host-clock ms per call of ``fn`` over ``n`` synchronized calls."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


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


def check_kernels(n_rays: int = 1024, n_samples: int = 500, seed: int = 0,
                  fourier: bool = False, n_fine: int = 0) -> dict:
    """K1 and K2 against the plain version on the same inputs (the flagship
    pair, or with ``fourier`` the pair on the fourier encoding). With
    ``n_fine`` the rays carry the fine pass's per-ray depths ``[R, S +
    n_fine]`` (:func:`fine_rays`). Raises on a disagreement; returns errors
    and times."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    dev = torch.device("cuda")
    cfg_s, cfg_t = flagship_cfgs(fourier)
    params = flagship_params(seed, dev, fourier)
    names, leaves = trained_leaves(params)
    if n_fine:
        origins, dirs, z, phases = fine_rays(params, n_rays, n_samples, n_fine, seed, dev)
    else:
        origins, dirs, z, phases = flagship_rays(n_rays, n_samples, seed, dev)
    # every band open: the hardest case (a fourier field reads no window)
    window = None if fourier else torch.ones(12, device=dev)
    args = (params["static"], params["temp"], origins, dirs, z, phases, cfg_s, cfg_t,
            window, window)

    before = dict(ff.LAUNCHES)
    with torch.no_grad():
        k_s, k_t = ff.fused_composite_fields_rays(*args)
        p_s, p_t = ff.plain_composite_fields_rays(*args)
    torch.cuda.synchronize()
    if (ff.LAUNCHES["fused_field_fwd.wgmma"] != before["fused_field_fwd.wgmma"] + 1
            or ff.LAUNCHES["fused_field_fwd.mma_sync"] != before["fused_field_fwd.mma_sync"]):
        raise AssertionError(f"K1 in f32 did not take the wgmma route: {ff.LAUNCHES}")
    k1_err = max(float((k_s - p_s).abs().max()), float((k_t - p_t).abs().max()))
    if not (math.isfinite(k1_err) and k1_err <= K1_ATOL):
        raise AssertionError(f"K1 disagrees with the plain version: {k1_err:.3e} > {K1_ATOL}")

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    g_s = torch.randn(p_s.shape, generator=g, device=dev)
    g_t = torch.randn(p_t.shape, generator=g, device=dev)

    def grads(fn):
        out_s, out_t = fn(*args)
        return torch.autograd.grad((out_s * g_s).sum() + (out_t * g_t).sum(), leaves)

    k_g = grads(ff.fused_composite_fields_rays)
    p_g = grads(ff.plain_composite_fields_rays)
    torch.cuda.synchronize()
    k2_err, k2_norm, worst = leaf_errors(names, k_g, p_g)
    res = {"k1_err": k1_err, "k2_err": k2_err, "k2_norm": k2_norm, "k2_worst": worst}

    # time the launch functions on packed inputs (the wrapper's packing is
    # outside the kernel); the counts are reset before each main path
    pack_s, pack_t = packs(params, (cfg_s, cfg_t), window, dev)
    ph32 = phases.to(torch.int32)
    lat = params["temp"]["latents"].detach()
    with torch.no_grad():
        res["k1_ms"] = cuda_time_ms(
            lambda: ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat))
        res["k1_plain_ms"] = cuda_time_ms(lambda: ff.plain_composite_fields_rays(*args))
    gs_flat, gt_flat = g_s.reshape(-1).contiguous(), g_t.reshape(-1).contiguous()
    res["k2_ms"] = cuda_time_ms(
        lambda: ff.fused_field_bwd(pack_s, pack_t, origins, dirs, z, ph32, lat,
                                   gs_flat, gt_flat))
    out_s, out_t = ff.plain_composite_fields_rays(*args)
    loss = (out_s * g_s).sum() + (out_t * g_t).sum()
    res["k2_plain_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True))
    res["shapes"] = {"n_rays": n_rays, "n_samples": z.shape[-1], "depth_floats": z.numel(),
                     "param_floats": sum(t.numel() for t in leaves)}
    return res


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


def check_kernels_fine(seed: int = 0) -> dict:
    """K1 and K2 (two fields) at the fine pass's shapes, 1024 rays x (500 +
    FINE_SAMPLES) sorted per-ray depths, against the plain version under
    :func:`check_kernels`' gates."""
    return check_kernels(n_rays=1024, n_samples=500, seed=seed, n_fine=FINE_SAMPLES)


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


def packs(params, cfgs, window, dev, bf16: bool = False) -> tuple:
    """Both fields' packed weights for the launch functions."""
    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    return tuple(ff._Pack(c, ff._leaves(params[k]), ff.enc_table(params[k], c, window), dev,
                          bf16) for k, c in zip(("static", "temp"), cfgs))


def k3_problem(seed: int = 0, fourier: bool = False, device=None, n_rays: int = 1024,
               n_samples: int = 500) -> dict:
    """K3's inputs at the flagship shapes (the pair on the fourier encoding
    with ``fourier``): params, rays of the flagship view, pixels, weights,
    the flagship's regularizers at weights large enough to move the grads,
    and a random hull gate that leaves some rays empty. ``args(hull)`` is
    the entry's argument tuple."""
    import torch

    from nerfca_tpu_torch.train.step import CompositeHParams

    dev = torch.device("cuda") if device is None else device
    cfg_s, cfg_t = flagship_cfgs(fourier)
    params = flagship_params(seed + 7, dev, fourier)
    origins, dirs, z, phases = flagship_rays(n_rays, n_samples, seed + 8, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    pixels = 2.16 - 0.5 * torch.rand(n_rays, generator=g, device=dev)
    weights = 1.0 + torch.rand(n_rays, generator=g, device=dev)
    i0 = torch.full((n_rays,), 2.16, device=dev)
    window = None if fourier else torch.ones(12, device=dev)
    hp = CompositeHParams(entro_mask_thre=1e-4, entro_use_weighting=True,
                          entro_weighted_thresh=0.03, occl_reg_perc=0.2, use_pallas=True,
                          use_fused_loss=True)
    pb = {"params": params, "cfgs": (cfg_s, cfg_t), "origins": origins, "dirs": dirs, "z": z,
          "phases": phases, "pixels": pixels, "weights": weights, "i0": i0,
          "window": window, "hp": hp, "hull": flagship_hull(dev)}

    def args(with_hull: bool) -> tuple:
        lw = [1e-3, 1e-3, 1e-3, 1e-4] + ([1e-3] if with_hull else [])
        return (params["static"], params["temp"], origins, dirs, z, phases, pixels, weights,
                i0, cfg_s, cfg_t, window, window, lw, hp)

    pb["args"] = args
    return pb


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


def check_k3(seed: int = 0, fourier: bool = False) -> dict:
    """K3 (``fused_train_loss_and_grads``) against its plain version at the
    flagship shapes (with ``fourier`` the pair on the fourier encoding),
    without and with the hull gate; times both with CUDA events, and K3's
    forward (K1) and loss phase (the loss kernel) apart."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import hull_gate_rays

    pb = k3_problem(seed, fourier)
    dev, hull = pb["origins"].device, pb["hull"]
    origins, dirs, z, phases = pb["origins"], pb["dirs"], pb["z"], pb["phases"]
    gate = hull_gate_rays(hull, origins, dirs, z)
    empty = int((gate.sum(-1) == 0).sum())
    if not 0 < empty < 1024:
        raise AssertionError(f"the K3 check's gate should leave some rays empty: {empty}")
    res = {"empty_rays": empty}
    for tag, h in (("", None), ("_hull", hull)):
        args = pb["args"](h is not None)
        got = ft.fused_train_loss_and_grads(*args, hull=h)
        want = ft.plain_train_loss_and_grads(*args, hull=h)
        torch.cuda.synchronize()
        res.update(k3_errors(tag, got, want))
        if (float(got[1]["hull_s_l1"]) > 0) != (h is not None):
            raise AssertionError(f"K3{tag} hull_s_l1 {float(got[1]['hull_s_l1'])}")
        res[f"ms{tag}"] = cuda_time_ms(lambda: ft.fused_train_loss_and_grads(*args, hull=h))
        res[f"plain_ms{tag}"] = cuda_time_ms(
            lambda: ft.plain_train_loss_and_grads(*args, hull=h))
    params, (cfg_s, cfg_t), window, hp = pb["params"], pb["cfgs"], pb["window"], pb["hp"]
    pixels, weights, i0 = pb["pixels"], pb["weights"], pb["i0"]

    # K3's forward (K1 on the batch's points) and its loss phase (the loss
    # kernel on K1's raw densities: loss, terms, cotangents)
    pack_s, pack_t = packs(params, (cfg_s, cfg_t), window, dev)
    ph32 = phases.to(torch.int32)
    lat = params["temp"]["latents"].detach()
    occl = ft.occlusion_mask(z, hp)  # kept alive: the launch reads its pointer
    largs = ft.loss_args(pixels, weights, i0, None, occl, [1e-3] * 3 + [1e-4], hp, 1024, 500)

    def forward():
        return ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat)

    raw_s, raw_t = forward()
    res["forward_ms"] = cuda_time_ms(forward)
    res["loss_phase_ms"] = cuda_time_ms(lambda: ft.fused_train_loss(raw_s, raw_t, z, largs))
    return res


def check_step_loss(seed: int = 0) -> float:
    """One flagship train-step loss with the kernels vs the plain path on
    the same batch and depths; returns the relative difference."""
    import torch

    from nerfca_tpu_torch.train.step import CompositeHParams, composite_loss_fn

    dev = torch.device("cuda")
    cfg_s, cfg_t = flagship_cfgs()
    params = flagship_params(seed, dev)
    origins, dirs, z, phases = flagship_rays(1024, 500, seed + 2, dev)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    batch = {"origins": origins, "directions": dirs, "phases": phases,
             "pixels": 2.16 - 0.5 * torch.rand(1024, generator=g, device=dev),
             "weights": 1.0 + torch.rand(1024, generator=g, device=dev),
             "initial_intensities": torch.full((1024,), 2.16, device=dev)}
    hp = CompositeHParams(entro_use_weighting=True, entro_weighted_thresh=0.03,
                          dynamic_entro_weight_start=1e-10, occl_weight_start=1e-8,
                          l1_weight_start=1e-8, occl_reg_perc=0.2)
    cfgs = {"static": cfg_s, "temp": cfg_t}
    with torch.no_grad():
        lk, _ = composite_loss_fn(params, batch, z, 100, cfgs, dataclasses.replace(hp, use_pallas=True))
        lp, _ = composite_loss_fn(params, batch, z, 100, cfgs, dataclasses.replace(hp, use_pallas=False))
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    if not (math.isfinite(rel) and rel <= LOSS_REL):
        raise AssertionError(f"step loss kernel {float(lk)} vs plain {float(lp)}")
    return rel


def mean_gap(a, b) -> float:
    return float((a - b).detach().abs().mean())


def leaf_gap(got, want) -> float:
    """The worst leaf's max-abs difference over max(its scale, 1e-2 x the
    largest leaf's), K2's normalization."""
    top = max(float(b.abs().max()) for b in want)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2 * top)
               for a, b in zip(got, want))


def bf16_gate(what: str, err: float, gap: float) -> float:
    """``err / gap``; raises unless it is finite and within BF16_GATE."""
    ratio = err / gap if gap > 0 else float("inf")
    if not (math.isfinite(ratio) and ratio <= BF16_GATE):
        raise AssertionError(f"{what}: {err:.3e} against its twin, bf16 vs f32 twin {gap:.3e} "
                             f"(ratio {ratio:.3e} > {BF16_GATE})")
    return ratio


def check_bf16_pair(what: str, k_out, t_out, f_out, k_g, t_g, f_g) -> dict:
    """A bf16 kernel's outputs and gradients against the bf16 twin's, each
    within BF16_GATE of the bf16 twin's distance from the f32 twin."""
    fwd = [(mean_gap(k, t), mean_gap(t, f)) for k, t, f in zip(k_out, t_out, f_out)]
    res = {"fwd_ratio": max(bf16_gate(f"{what} forward (mean |diff|)", e, g) for e, g in fwd),
           "fwd_mean_err": max(e for e, _ in fwd), "fwd_mean_gap": min(g for _, g in fwd),
           "max_abs_err": max(float((k - t).detach().abs().max()) for k, t in zip(k_out, t_out))}
    err, gap = leaf_gap(k_g, t_g), leaf_gap(t_g, f_g)
    res.update(grad_ratio=bf16_gate(f"{what} gradients (worst leaf)", err, gap), grad_err=err,
               grad_gap=gap, grad_max_abs_err=max(float((a - b).abs().max())
                                                  for a, b in zip(k_g, t_g)))
    return res


def check_kernels_bf16(n_rays: int = 1024, n_samples: int = 500, seed: int = 0,
                       fourier: bool = False) -> dict:
    """The bf16 K1 and K2 against their bf16 twin at the flagship shapes
    (with ``fourier`` the pair on the fourier encoding), two fields (ray
    form) and one (``fused_static_field`` with ``configs/3d.txt``'s field on
    the same points), under BF16_GATE; each launch must be the bf16
    instantiation's. Times the bf16 launch functions and the twin."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    dev = torch.device("cuda")
    bf = "bfloat16"
    cfg_s, cfg_t = flagship_cfgs(fourier)
    params = flagship_params(seed, dev, fourier)
    names, leaves = trained_leaves(params)
    origins, dirs, z, phases = flagship_rays(n_rays, n_samples, seed, dev)
    window = None if fourier else torch.ones(12, device=dev)
    args = (params["static"], params["temp"], origins, dirs, z, phases, cfg_s, cfg_t,
            window, window)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    cot = [torch.randn(n_rays, n_samples, 1, generator=g, device=dev) for _ in range(2)]

    def run(fn, *extra):
        out = fn(*args, *extra)
        return out, torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cot)), leaves)

    before = dict(ff.LAUNCHES)
    k_out, k_g = run(ff.fused_composite_fields_rays, bf)
    for name in ("fused_field_fwd", "fused_field_bwd", "fused_field_fwd.mma_sync"):
        bf_name = name + "_bf16" if "." not in name else name
        f32_name = name if "." not in name else "fused_field_fwd.wgmma"
        if (ff.LAUNCHES[bf_name] != before[bf_name] + 1
                or ff.LAUNCHES[f32_name] != before[f32_name]):
            raise AssertionError(f"the bf16 entry did not launch the bf16 {name}: {ff.LAUNCHES}")
    t_out, t_g = run(ff.twin_composite_fields_rays, bf)
    f_out, f_g = run(ff.plain_composite_fields_rays)
    torch.cuda.synchronize()
    res = check_bf16_pair("bf16 K1/K2" + " fourier" * fourier, k_out, t_out, f_out, k_g, t_g,
                          f_g)

    pack_s, pack_t = packs(params, (cfg_s, cfg_t), window, dev, bf16=True)
    ph32 = phases.to(torch.int32)
    lat = params["temp"]["latents"].detach()
    gs, gt = (c.reshape(-1).contiguous() for c in cot)
    with torch.no_grad():
        res["k1_ms"] = cuda_time_ms(
            lambda: ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat))
        res["k1_plain_ms"] = cuda_time_ms(lambda: ff.twin_composite_fields_rays(*args, bf))
    res["k2_ms"] = cuda_time_ms(
        lambda: ff.fused_field_bwd(pack_s, pack_t, origins, dirs, z, ph32, lat, gs, gt))
    out = ff.twin_composite_fields_rays(*args, bf)
    loss = sum((o * c).sum() for o, c in zip(out, cot))
    res["k2_plain_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True))
    del out, loss
    res["shapes"] = {"n_rays": n_rays, "n_samples": n_samples,
                     "param_floats": sum(t.numel() for t in leaves)}

    # one field: configs/3d.txt's static field on the same points
    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng

    cfg = static_cfg(fourier)
    p1 = {"static": init_static_field(prng.key(seed), cfg, dev)}
    n1, l1 = trained_leaves(p1)
    with torch.no_grad():
        pts = ff._points(origins, dirs, z).contiguous()
    w1 = None if fourier else torch.ones(cfg.pos_enc_basis, device=dev)
    runs = []
    before = dict(ff.LAUNCHES)
    for fn, cd in ((ff.fused_static_field, bf), (ff.twin_static_field, bf),
                   (ff.plain_static_field, "float32")):
        o1 = fn(p1["static"], pts, cfg, w1, cd)
        runs.append(([o1], torch.autograd.grad((o1 * cot[0]).sum(), l1)))
        if fn is ff.fused_static_field:
            for name in ("fused_static_field_fwd", "fused_static_field_bwd"):
                if (ff.LAUNCHES[name + "_bf16"] != before[name + "_bf16"] + 1
                        or ff.LAUNCHES[name] != before[name]):
                    raise AssertionError(f"the bf16 static entry did not launch the bf16 {name}")
    torch.cuda.synchronize()
    one = check_bf16_pair("bf16 one-field K1/K2" + " fourier" * fourier, *[r[0] for r in runs],
                          *[r[1] for r in runs])
    res["one_field"] = one
    pack = ff._Pack(cfg, ff._leaves(p1["static"]), ff.enc_table(p1["static"], cfg, w1), dev,
                    bf16=True)
    n = n_rays * n_samples
    po, pd, z0 = pts.reshape(n, 3), torch.zeros(n, 3, device=dev), torch.zeros(1, device=dev)
    zero_ph, lat0 = torch.zeros(n, dtype=torch.int32, device=dev), torch.zeros(1, 8, device=dev)
    g1 = cot[0].reshape(-1).contiguous()
    with torch.no_grad():
        one["k1_ms"] = cuda_time_ms(lambda: ff.fused_field_fwd(pack, None, po, pd, z0, zero_ph,
                                                               lat0))
        one["k1_plain_ms"] = cuda_time_ms(
            lambda: ff.twin_static_field(p1["static"], pts, cfg, w1, bf))
    one["k2_ms"] = cuda_time_ms(
        lambda: ff.fused_field_bwd(pack, None, po, pd, z0, zero_ph, lat0, g1, None))
    o1 = ff.twin_static_field(p1["static"], pts, cfg, w1, bf)
    loss1 = (o1 * cot[0]).sum()
    one["k2_plain_ms"] = cuda_time_ms(lambda: torch.autograd.grad(loss1, l1, retain_graph=True))
    one["param_floats"] = sum(t.numel() for t in l1)
    return res


def k3_leaves(result) -> list:
    from nerfca_tpu_torch.train.step import param_items

    return [t for _, t in param_items({"static": result[2], "temp": result[3]})]


def k3_names(result) -> list:
    from nerfca_tpu_torch.train.step import param_items

    return [n for n, _ in param_items({"static": result[2], "temp": result[3]})]


def reads_residual(name: str) -> bool:
    """A leaf whose gradient reads a stored post-ReLU activation: the
    weights of the hidden layers and of the output layer."""
    return name.endswith("/w") and "/early/0/" not in name


def check_k3_bf16(seed: int = 0) -> dict:
    """K3 under bf16 compute and under bf16 residual storage at the flagship
    shapes (no hull), each against its twin: bf16 compute by the gradients
    under BF16_GATE (the loss and terms by LOSS_REL); bf16 residuals by the
    f32 K3's loss and terms bit for bit, the leaves that read no stored
    activation bit for bit, the gradients by K2_REL against the twin, and
    K2 over bf16 residuals by its change against the twin's on unit-normal
    cotangents under BF16_GATE (on K3's own cotangents only reported).
    Times both, their twins and K2 over bf16 residuals alone."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    pb = k3_problem(seed)
    args = pb["args"](False)
    bargs = args[:-1] + (dataclasses.replace(args[-1], compute_dtype="bfloat16"),)
    rargs = args[:-1] + (dataclasses.replace(args[-1], pallas_bf16_residuals=True),)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731

    def term_gap(got, want):
        return max(rel(got[k], want[k]) for k in want if float(want[k]))

    before = dict(ff.LAUNCHES)
    k = ft.fused_train_loss_and_grads(*bargs)
    if (ff.LAUNCHES["fused_field_fwd_bf16"] != before["fused_field_fwd_bf16"] + 1
            or ff.LAUNCHES["fused_field_bwd_bf16"] != before["fused_field_bwd_bf16"] + 1
            or ff.LAUNCHES["fused_field_fwd"] != before["fused_field_fwd"]):
        raise AssertionError(f"bf16 K3 did not launch the bf16 K1/K2: {ff.LAUNCHES}")
    t = ft.plain_train_loss_and_grads(*bargs)
    f = ft.plain_train_loss_and_grads(*args)
    torch.cuda.synchronize()
    res = {"loss_err": rel(k[0], t[0]), "loss_gap": rel(t[0], f[0]),
           "term_err": term_gap(k[1], t[1]), "term_gap": term_gap(t[1], f[1])}
    if not (res["loss_err"] <= LOSS_REL and res["term_err"] <= LOSS_REL):
        raise AssertionError(f"bf16 K3: loss rel {res['loss_err']:.3e}, worst term "
                             f"{res['term_err']:.3e} (> {LOSS_REL})")
    kl, tl, fl = k3_leaves(k), k3_leaves(t), k3_leaves(f)
    res["grad_err"], res["grad_gap"] = leaf_gap(kl, tl), leaf_gap(tl, fl)
    res["grad_ratio"] = bf16_gate("bf16 K3 gradients", res["grad_err"], res["grad_gap"])
    res["max_abs_err"] = max(float((a - b).abs().max()) for a, b in zip(kl, tl))
    res["ms"] = cuda_time_ms(lambda: ft.fused_train_loss_and_grads(*bargs))
    res["plain_ms"] = cuda_time_ms(lambda: ft.plain_train_loss_and_grads(*bargs))
    del k, t, kl, tl

    before = dict(ff.LAUNCHES)
    k_res = ft.fused_train_loss_and_grads(*rargs)
    if (ff.LAUNCHES["fused_field_bwd_res_bf16"] != before["fused_field_bwd_res_bf16"] + 1
            or ff.LAUNCHES["fused_field_bwd"] != before["fused_field_bwd"]):
        raise AssertionError(f"K3 with bf16 residuals did not launch its K2: {ff.LAUNCHES}")
    k_f32 = ft.fused_train_loss_and_grads(*args)
    t_res = ft.plain_train_loss_and_grads(*rargs)
    torch.cuda.synchronize()
    res["res_loss_bitwise"] = float(k_res[0]) == float(k_f32[0]) and all(
        float(k_res[1][n]) == float(k_f32[1][n]) for n in k_f32[1])
    if not res["res_loss_bitwise"]:
        raise AssertionError("K3 with bf16 residuals: the loss or a term differs from the f32 K3")
    # only the leaves whose dW reads a stored activation (the hidden and
    # output layers' weights) can move; every other leaf keeps its bits
    moved = 0
    for name, kr, kf in zip(k3_names(k_f32), k3_leaves(k_res), k3_leaves(k_f32)):
        if reads_residual(name):
            moved += not torch.equal(kr, kf)
        elif not torch.equal(kr, kf):
            raise AssertionError(f"K3 with bf16 residuals moved {name}")
    res["res_leaves_moved"] = moved
    if moved == 0:
        raise AssertionError("K3 with bf16 residuals: no gradient moved from the f32 K3's")
    res["res_grad_err_vs_twin"] = leaf_gap(k3_leaves(k_res), k3_leaves(t_res))
    if not res["res_grad_err_vs_twin"] <= K2_REL:
        raise AssertionError(f"K3 with bf16 residuals: grads {res['res_grad_err_vs_twin']:.3e} "
                             f"of scale from the twin (> {K2_REL})")
    res["res_max_abs_err"] = max(float((a - b).abs().max())
                                 for a, b in zip(k3_leaves(k_res), k3_leaves(t_res)))
    res["res_ms"] = cuda_time_ms(lambda: ft.fused_train_loss_and_grads(*rargs))
    res["res_plain_ms"] = cuda_time_ms(lambda: ft.plain_train_loss_and_grads(*rargs))
    res["f32_ms"] = cuda_time_ms(lambda: ft.fused_train_loss_and_grads(*args))
    del k_res, k_f32, t_res, f, fl

    # K2 over bf16 residuals (and the f32 K2) on K3's own cotangents: each
    # moving leaf's change against the twin's on the same cotangents
    params, (cfg_s, cfg_t), window, hp = pb["params"], pb["cfgs"], pb["window"], pb["hp"]
    origins, dirs, z, phases = pb["origins"], pb["dirs"], pb["z"], pb["phases"]
    dev = origins.device
    pack_s, pack_t = packs(params, (cfg_s, cfg_t), window, dev)
    ph32 = phases.to(torch.int32)
    lat = params["temp"]["latents"].detach()
    occl = ft.occlusion_mask(z, hp)  # kept alive: the launch reads its pointer
    largs = ft.loss_args(pb["pixels"], pb["weights"], pb["i0"], None, occl, args[13], hp,
                         origins.shape[0], z.shape[0])
    raw_s, raw_t = ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat)
    _, g_s, g_t = ft.fused_train_loss(raw_s, raw_t, z, largs)

    def k2(res_bf16, cot=(g_s, g_t)):
        return ff.fused_field_bwd(pack_s, pack_t, origins, dirs, z, ph32, lat, *cot,
                                  res_bf16=res_bf16)

    rays = (origins, dirs, z, phases)
    on_k3 = residual_shares(params, (cfg_s, cfg_t), window, rays, (pack_s, pack_t), k2(True),
                            k2(False), (g_s, g_t))
    res.update({f"{k}_k3_cotangents": v for k, v in on_k3.items()})
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    cot = tuple(torch.randn(g_s.shape, generator=gen, device=dev) for _ in range(2))
    res.update(residual_shares(params, (cfg_s, cfg_t), window, rays, (pack_s, pack_t),
                               k2(True, cot), k2(False, cot), cot))
    if not res["res_share_err"] <= BF16_GATE:
        raise AssertionError(f"K2 over bf16 residuals: share of the twin's change off by "
                             f"{res['res_share_err']:.3e} (> {BF16_GATE})")
    res["k2_res_ms"], res["k2_f32_ms"] = cuda_time_ms(lambda: k2(True)), cuda_time_ms(
        lambda: k2(False))
    names, leaves = trained_leaves(params)
    out = ff.twin_composite_fields_rays(params["static"], params["temp"], origins, dirs, z,
                                        phases, cfg_s, cfg_t, window, window, "float32", True)
    shape = out[0].shape
    loss = (out[0] * g_s.view(shape)).sum() + (out[1] * g_t.view(shape)).sum()
    res["k2_res_plain_ms"] = cuda_time_ms(
        lambda: torch.autograd.grad(loss, leaves, retain_graph=True))
    return res


def residual_shares(params, cfgs, window, rays, pks, flat_res, flat_f32, cot) -> dict:
    """K2's change under bf16 residual storage, dk (its flat gradients with
    and without), against the twin's change on the same cotangents, dt (the
    twin's backward with and without the rounding, the same sums apart from
    it): per leaf whose dW reads a stored activation, the share beta =
    <dk, dt> / <dt, dt> (1 when the kernel rounds what the twin rounds, 0
    for an f32 kernel), its worst distance from 1, the worst |dk - dt| /
    |dt|, the smallest |dt| as a share of its leaf and the largest distance
    of the f32 K2 from the twin, by the same norm. Every other leaf must
    keep its bits."""
    import torch

    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    origins, dirs, z, phases = rays
    n_phases = params["temp"]["latents"].shape[0]
    size_s = pks[0].grad_layout(n_phases)["size"]

    def kernel_leaves(flat):
        out = []
        for pk, part in zip(pks, (flat[:size_s], flat[size_s:])):
            out += pk.leaf_grads(part, n_phases)[0]
        return out

    def twin_leaves(res_bf16):
        trees = [{"early": [{k: v.detach().clone().requires_grad_(True) for k, v in l.items()}
                            for l in p["early"]],
                  "out": {k: v.detach().clone().requires_grad_(True) for k, v in p["out"].items()},
                  **{k: p[k].detach() for k in ("latents", "fourier") if k in p}}
                 for p in (params["static"], params["temp"])]
        out = ff.twin_composite_fields_rays(trees[0], trees[1], origins, dirs, z, phases, *cfgs,
                                            window, window, "float32", res_bf16,
                                            hand_backward=True)
        loss = sum((o * c.view(o.shape)).sum() for o, c in zip(out, cot))
        return list(torch.autograd.grad(loss, ff._leaves(trees[0]) + ff._leaves(trees[1])))

    names = [f"{f}/{n}" for f, c in zip(("static", "temp"), cfgs)
             for n in [f"early/{i}/{k}" for i in range(c.num_early_layers + 1) for k in "wb"]
             + ["out/w", "out/b"]]
    worst, spread, effect, noise = 0.0, 0.0, float("inf"), 0.0
    for name, kr, kf, tr, tf_ in zip(names, kernel_leaves(flat_res), kernel_leaves(flat_f32),
                                     twin_leaves(True), twin_leaves(False)):
        if not reads_residual(name):
            if not torch.equal(kr, kf):
                raise AssertionError(f"K2 over bf16 residuals moved {name}")
            continue
        dk, dt = (kr - kf).double(), (tr - tf_).double()
        if not float(dt.norm()) > 0:
            raise AssertionError(f"the twin's bf16 residuals leave {name} unchanged")
        err = abs(float((dk * dt).sum() / (dt * dt).sum()) - 1)
        worst = err if not err <= worst else worst  # a NaN stays
        spread = max(spread, float((dk - dt).norm() / dt.norm()))
        effect = min(effect, float(dt.norm() / tf_.norm()))
        noise = max(noise, float((kf - tf_).norm() / tf_.norm()))
    return {"res_share_err": worst, "res_change_diff": spread, "res_change_of_leaf": effect,
            "res_f32_kernel_vs_twin": noise}


def counted_run(argv: list, static: bool = False) -> dict:
    """``run_composite.main(argv)`` (``run_nerf.main`` with ``static``) with
    the launch counts set to 0 just before and read just after, the eval
    renders' launches and times apart and the time inside the train chunks
    summed (each chunk ends in a read-back of its metrics, so its host time
    covers its device work)."""
    import torch

    from nerfca_tpu_torch.train import evaluation, run_composite, run_nerf, trainer

    info = {"eval_launches": {}, "eval_ms": [], "train_s": 0.0, "train_steps": 0}
    render_name = "render_static_test_view" if static else "render_test_view"
    render, run_chunk = getattr(evaluation, render_name), trainer._run_chunk

    def counted_render(*a, **k):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        out = render(*a, **k)
        torch.cuda.synchronize()
        info["eval_ms"].append(1e3 * (time.perf_counter() - t0))
        for key, v in launch_counts().items():
            info["eval_launches"][key] = info["eval_launches"].get(key, 0) + v - before[key]
        return out

    def timed_chunk(train_step, state, dd, n_now, hull=None):
        t0 = time.perf_counter()
        out = run_chunk(train_step, state, dd, n_now, hull=hull)
        info["train_s"] += time.perf_counter() - t0
        info["train_steps"] += n_now
        return out

    setattr(evaluation, render_name, counted_render)
    trainer._run_chunk = timed_chunk
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = (run_nerf if static else run_composite).main(argv)
        torch.cuda.synchronize()
        info["wall_s"] = time.perf_counter() - t0
        total = launch_counts()
    finally:
        setattr(evaluation, render_name, render)
        trainer._run_chunk = run_chunk
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    info.update(run=out, launches=total, train=[r for r in records if "train_loss" in r],
                evals=[r for r in records if "test_image_psnr" in r],
                train_launches={k: total[k] - info["eval_launches"].get(k, 0) for k in total})
    return info


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
    step-0 eval of the seed's initial params, the warm fine step on the
    kernels and plain in turns, and the eval view. Raises on a failure; the
    gates against the JAX record are :func:`report_fine`'s. ``extra_argv``
    is appended to the command line (a smaller rehearsal)."""
    import torch

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

    setup, state = out["setup"], out["state"]
    args = parse_args(argv)
    dd = setup["device_data"]
    dev = dd["rays"].device
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

    steady: dict = {}
    for path in ("kernels", "plain", "plain", "kernels"):
        hp = dataclasses.replace(setup["hp"], use_pallas=path == "kernels")
        step = trainer.make_composite_train_step(setup["cfgs"], hp, setup["tx"],
                                                 setup["depth_values"],
                                                 setup["max_pixel_value"])

        def train_step():
            step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"],
                 hull=setup["hull"])

        wall_ms(train_step, 2)
        steady.setdefault(f"step_ms_{path}", []).append(wall_ms(train_step, 5))
    wall_ms(lambda: eval_view(state.params, state.step), 1)
    steady["eval_ms"] = [wall_ms(lambda: eval_view(state.params, state.step), 1)
                         for _ in range(2)]
    return {"res": res, "loss": {r["step"]: r["train_loss"] for r in res["train"]},
            "evals": evals, "steady": steady, "tiles": tiles}


def report_fine(fp: dict, card: str) -> bool:
    """Print phase 4j beside the JAX record; True when its gates pass."""
    with open(JAX_FINE) as f:
        rec = json.load(f)
    res, loss, evals = fp["res"], fp["loss"], fp["evals"]
    log(f"fine pass (configs/composite.txt {' '.join(FINE_ARGV)}, K1/K2, {FINE_STEPS} steps; "
        f"{card}): {res['wall_s']:.1f} s wall; {res['train_steps']} steps in "
        f"{res['train_s']:.2f} s of train chunks; in-loop eval "
        f"{[round(m, 1) for m in res['eval_ms']]} ms")
    log(f"  launches: training {res['train_launches']}, in-loop eval {res['eval_launches']} "
        f"({fp['tiles']} tiles a pass)")
    for s in sorted(int(k) for k in rec["train_loss"]):
        log(f"  step {s}: train_loss {loss[s]:.7g} (JAX {rec['train_loss'][str(s)]:.7g})")
    for s in sorted(int(k) for k in rec["evals"]):
        log(f"  eval at step {s}: test_image_psnr {evals[s]['test_image_psnr']:.4f} dB (JAX "
            f"{rec['evals'][str(s)]['test_image_psnr']:.4f}), test_image_psnr_fine "
            f"{evals[s]['test_image_psnr_fine']:.4f} dB (JAX "
            f"{rec['evals'][str(s)]['test_image_psnr_fine']:.4f})")
    log(f"  steady state in turns, kernels / plain then reversed: {json.dumps(fp['steady'])}")
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
        t0 = time.perf_counter()
        ranked = run_composite.main(argv)
        wall = time.perf_counter() - t0
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
    return {"wall_s": wall, "results": results, "runs": runs, "ranked": ranked}


class Background:
    """``fn(*args)`` in a thread, started at once: :meth:`result` joins it
    and returns its value (raising its error), ``seconds`` its wall time."""

    def __init__(self, fn, *args):
        import threading

        self.value, self.error, self.seconds = None, None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        t0 = time.perf_counter()
        try:
            self.value = fn(*args)
        except BaseException as e:  # re-raised in the main thread by result()
            self.error = e
        self.seconds = time.perf_counter() - t0

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
    scripts/tpu_xcat_surrogate.py does). Per phase: its registry entry, its
    seconds and the artery voxels of its ``dyn_volume_tigre.npy``."""
    import numpy as np

    from nerfca_tpu_torch.data import dxcat_surrogate_bin, xcat

    dxcat_surrogate_bin.install(xcat_path)
    for name in ("volume", "noarteries"):
        with open(os.path.join(xcat_path, f"{name}.samp.par"), "w") as f:
            f.write(XCAT_PAR)
    out = []
    for p in range(XCAT_PHASES):
        t0 = time.perf_counter()
        obj = xcat.prepare_and_run_xcat(p / 10.0, 0.0, xcat_path, dimensions=XCAT_DIMS)
        run_dir = os.path.join(xcat_path, str(obj["id"]))
        for name in ("volume", "noarteries"):
            os.remove(os.path.join(run_dir, f"{name}_atn_1.bin"))
        dyn = np.load(os.path.join(run_dir, "dyn_volume_tigre.npy"))
        out.append({**obj, "seconds": time.perf_counter() - t0,
                    "dyn_voxels": int((dyn > 0).sum()), "shape": list(dyn.shape)})
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
    of checkpoint-1000 over the 40 views of evaluate.json, the warm K3+hull
    step and eval view on this data; (c) the native projector against the
    card's on the first train view of phase 0. Raises on a failure other
    than the gates against the JAX records, which :func:`report_magix`
    applies. ``extra_argv`` is appended to every command line."""
    import numpy as np
    import torch

    from nerfca_tpu_torch.data import native
    from nerfca_tpu_torch.data.dataset import dataset_paths
    from nerfca_tpu_torch.ops.projector import project_view
    from nerfca_tpu_torch.train import evaluation, run_eval, trainer
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.step import make_composite_train_step

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
    before, t0 = launch_counts(), time.perf_counter()
    result = run_eval.evaluate_checkpoint(args, write_images=False)
    keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
    score = {"wall_s": time.perf_counter() - t0, "views": len(result["per_view"]),
             "k1_launches": launch_counts()["fused_field_fwd"] - before["fused_field_fwd"],
             **{k: result[k] for k in keys}}
    if (score["views"] != 40 or result["step"] != 1000 or score["k1_launches"] < 40
            or not all(math.isfinite(score[k]) for k in keys)):
        raise AssertionError(f"MAGIX-SURR: run_eval of checkpoint-1000 {score}")

    setup, state = out["setup"], out["state"]
    dd, view = setup["device_data"], setup["test_views"][0]
    step = make_composite_train_step(setup["cfgs"], setup["hp"], setup["tx"],
                                     setup["depth_values"], setup["max_pixel_value"])

    def train_step():
        step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"], hull=hull)

    def eval_view():
        evaluation.render_test_view(state.params, view["origins"], view["directions"],
                                    view["phases"], setup["depth_values"], state.step,
                                    setup["cfgs"], setup["hp"], setup["max_pixel_value"],
                                    hull=hull)

    wall_ms(train_step, 3)
    steady = {"step_ms_k3_hull": [wall_ms(train_step, 10) for _ in range(2)]}
    wall_ms(eval_view, 1)
    steady["eval_ms_k3_hull"] = [wall_ms(eval_view, 1) for _ in range(2)]

    # (c) the native projector on the host against the card's, one view
    vol = np.load(os.path.join(vols, "0", "full_volume_tigre.npy"))
    with open(dataset_paths(pargs, pargs.data_root).general) as f:
        info = json.load(f)
    theta, phi = -30.0, 30.0  # the first of the four train views
    t0 = time.perf_counter()
    card = project_view(vol, info, theta, phi, device=dev).cpu().numpy()
    card_s = time.perf_counter() - t0
    if not native.is_available():
        raise AssertionError(f"native projector: {native._error}")
    t0 = time.perf_counter()
    host = native.native_project_view(vol, info, theta, phi)
    native_s = time.perf_counter() - t0
    native_err = float(np.abs(host - card).max())
    if not native_err <= NATIVE_ATOL:
        raise AssertionError(f"native projector vs the card's: max abs {native_err:.3e}")
    return {"parity": parity, "psnr": psnr, "res": res, "hull": hull, "occupied": occupied,
            "checkpoints": ckpts, "score": score, "steady": steady,
            "native": {"err": native_err, "max": float(np.abs(card).max()), "card_s": card_s,
                       "native_s": native_s, "view": (theta, phi),
                       "threads": native._load().cone_projector_num_threads()}}


def report_magix(mg: dict, vb: VolumeBuilds, builds: dict, card: str) -> bool:
    """Print phase 4l beside the JAX records; True when its gates pass."""
    with open(JAX_MAGIX) as f:
        rec = json.load(f)
    with open(JAX_MAGIX_RUN) as f:
        jrun = {r["step"]: r for r in json.load(f)["per_checkpoint_40view"]}
    pr, res, sc = mg["parity"], mg["res"], mg["score"]
    log(f"MAGIX-SURR ({card}): {MAGIX_PHASES} phases of write_surrogate_case in "
        f"{MAGIX_WORKERS} processes, in the background: {vb.magix.seconds:.1f} s; dataset "
        f"build on the card {builds.get('MAGIX-SURR', float('nan')):.1f} s (the flagship SYNTH "
        f"build, its phantom included: {builds.get('SYNTH', float('nan')):.1f} s)")
    log(f"  (a) parity, {MAGIX_PARITY_STEPS} K3 steps without the hull: {pr['wall_s']:.1f} s "
        f"wall with the dataset build; launches: training {pr['train_launches']}, eval "
        f"{pr['eval_launches']}")
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
    log(f"  (b) the recipe with the hull, {MAGIX_STEPS} steps: {res['train_steps']} steps in "
        f"{res['train_s']:.2f} s of train chunks ({1e3 * res['train_s'] / res['train_steps']:.2f} "
        f"ms a step); launches: training {res['train_launches']}, in-loop evals "
        f"{res['eval_launches']}; hull res {mg['hull'].grid.shape[0]}, occupied share "
        f"{mg['occupied']:.6f}; checkpoints {mg['checkpoints']}")
    log(f"  selection view: {[(r['step'], round(r['test_image_psnr'], 3), round(r.get('test_dyn_corr', float('nan')), 4)) for r in res['evals']]}")
    j = jrun.get(1000, {})
    log(f"  run_eval checkpoint-1000 over {sc['views']} views ({sc['wall_s']:.2f} s, "
        f"{sc['k1_launches']} K1 launches): PSNR {sc['mean_psnr']:.3f} dB, SSIM "
        f"{sc['mean_ssim']:.4f}, dyn_psnr_masked {sc['mean_dyn_psnr_masked']:.3f}, dyn_corr "
        f"{sc['mean_dyn_corr']:.4f} (the JAX round-5 record of the recipe at step 1000: "
        f"{j.get('mean_psnr', float('nan')):.2f} dB, SSIM {j.get('mean_ssim', float('nan')):.3f}, "
        f"dyn_corr {j.get('mean_dyn_corr', float('nan')):.3f})")
    quality_ok = sc["mean_psnr"] >= GATE_MAGIX_PSNR and sc["mean_dyn_corr"] >= GATE_MAGIX_DYN_CORR
    log(f"  quality floor at checkpoint-1000: PSNR {sc['mean_psnr']:.3f} >= {GATE_MAGIX_PSNR} "
        f"and dyn_corr {sc['mean_dyn_corr']:.4f} >= {GATE_MAGIX_DYN_CORR}: "
        f"{'passed' if quality_ok else 'FAILED'}")
    log(f"  warm K3+hull step and eval view on this data: {json.dumps(mg['steady'])}")
    nt = mg["native"]
    log(f"  (c) native C++ projector ({nt['threads']} threads, {nt['native_s']:.2f} s) vs the "
        f"card's ({nt['card_s']:.3f} s), view {nt['view']} of phase 0: max abs {nt['err']:.3e} "
        f"(limit {NATIVE_ATOL}; line integrals up to {nt['max']:.4f})")
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


def non_synth_phases(workdir: str, vb: VolumeBuilds, builds: dict, card: str) -> dict:
    """Phases 4l, 4l' and 4m on ``vb``'s volumes, printed; raises when a
    gate fails. ``builds`` holds the dataset build times by data family
    (:func:`time_dataset_builds`)."""
    mg = magix_phase(workdir, vb)
    if not report_magix(mg, vb, builds, card):
        raise AssertionError("MAGIX-SURR: the run is outside its gates")
    ex = experiment_phase(workdir, vb)
    log(f"experiment view list (--use_experiment_name true --experiment_name {EXPERIMENT}, "
        f"MAGIX-SURR volumes, K3; {card}): {ex['wall_s']:.1f} s wall with its one-phase "
        f"build; train_loss {[round(r['train_loss'], 6) for r in ex['train']]}")
    log(f"  launches: training {ex['train_launches']}, eval {ex['eval_launches']}; eval "
        f"render {ex['eval_ms']} ms; test_image_psnr {ex['eval']['test_image_psnr']:.3f}")
    shutil.rmtree(vb.magix_vols)
    xc = xcat_phase(workdir, vb)
    log(f"XCAT-SURR ({card}): the driver contract at {' x '.join(map(str, XCAT_DIMS))} through "
        f"the port's stand-in dxcat1_bin, {XCAT_PHASES} phases in the background: "
        f"{vb.xcat.seconds:.1f} s ({[round(p['seconds'], 1) for p in xc['phases']]} s a "
        f"phase), artery voxels {[p['dyn_voxels'] for p in xc['phases']]}, LCA box centers "
        f"{[[round(v, 1) for v in p['bounding_box_center']] for p in xc['phases']]}; dataset "
        f"build on the card {builds.get('XCAT-SURR', float('nan')):.1f} s; "
        f"{xc['wall_s']:.1f} s wall; train_loss "
        f"{[round(r['train_loss'], 6) for r in xc['train']]}")
    log(f"  launches: training {xc['train_launches']}, eval {xc['eval_launches']}; eval "
        f"render {xc['eval_ms']} ms; test_image_psnr {xc['eval']['test_image_psnr']:.3f}")
    return {"magix": mg, "experiment": ex, "xcat": xc}


def time_dataset_builds() -> dict:
    """Wraps the trainer's dataset build to record the first build's
    seconds of each data family (the card synchronized) in the dict it
    returns."""
    import torch

    from nerfca_tpu_torch.train import trainer

    builds, build_dataset = {}, trainer.build_dataset

    def timed_build(args, *a, **k):
        t0 = time.perf_counter()
        out = build_dataset(args, *a, **k)
        torch.cuda.synchronize()
        builds.setdefault(str(args.data_name), time.perf_counter() - t0)
        return out

    trainer.build_dataset = timed_build
    return builds


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
        before, t0 = launch_counts(), time.perf_counter()
        result = run_eval.evaluate_checkpoint(args, write_images=False)
        wall = time.perf_counter() - t0
        k1 = launch_counts()["fused_field_fwd"] - before["fused_field_fwd"]
        n = len(result["per_view"])
        if n != 40 or result["step"] != step or k1 < n:
            raise AssertionError(f"run_eval of checkpoint-{step}: {n} views, step "
                                 f"{result['step']}, {k1} K1 launches")
        keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
        if not all(math.isfinite(result[k]) for k in keys):
            raise AssertionError(f"run_eval of checkpoint-{step}: {[result[k] for k in keys]}")
        scores[step] = {"wall_s": wall, "k1_launches": k1, "views": n,
                        **{k: result[k] for k in keys}}
    views = [(-30.0, 30.0, 0), (60.0, -30.0, 5)]
    best = os.path.join(log_dir, "checkpoint-best")
    args = parse_args(argv + ["--resume_from", best])
    before, t0 = launch_counts(), time.perf_counter()
    rendered = run_render.render_views(args, views)
    render = {"wall_s": time.perf_counter() - t0,
              "k1_launches": launch_counts()["fused_field_fwd"] - before["fused_field_fwd"]}
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
    t0 = time.perf_counter()
    result = run_eval.evaluate_checkpoint(args, write_images=False)
    keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
    score = {"wall_s": time.perf_counter() - t0, "views": len(result["per_view"]),
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
        f"{res['train_steps']} steps in {res['train_s']:.2f} s of train chunks "
        f"({1e3 * res['train_s'] / res['train_steps']:.2f} ms a step); launches: training "
        f"{res['train_launches']}, in-loop evals {res['eval_launches']}")
    log(f"  train_loss {[(r['step'], r['train_loss']) for r in res['train']]}")
    log(f"  selection view image PSNR: step 0 {leg['psnr0']:.3f} dB, then "
        f"{leg['selection']}; dyn_corr {leg['dyn_corr']}")
    log(f"  run_eval checkpoint-1000 over {sc['views']} views ({sc['wall_s']:.2f} s): PSNR "
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
        f"{res['wall_s']:.1f} s wall with the dataset build; {res['train_steps']} steps in "
        f"{res['train_s']:.2f} s of train chunks ({1e3 * res['train_s'] / res['train_steps']:.2f} "
        f"ms a step); evals {len(res['eval_ms'])} x {[round(m, 1) for m in res['eval_ms']]} ms; "
        f"hull res {cp['hull'].grid.shape[0]}, occupied share {cp['occupied']:.6f}")
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
    log(f"  resume from checkpoint-500: {rs['train_steps']} steps in {rs['train_s']:.2f} s, "
        f"launches {rs['train_launches']}; checkpoint-1000 equals the first run's bitwise "
        f"(params, mu, nu, count, step, key)")
    for step, sc in cp["scores"].items():
        j = forty.get(step, {})
        log(f"  run_eval checkpoint-{step} over {sc['views']} views ({sc['wall_s']:.2f} s, "
            f"{sc['k1_launches']} K1 launches): PSNR {sc['mean_psnr']:.3f} dB, SSIM "
            f"{sc['mean_ssim']:.4f}, dyn_psnr_masked {sc['mean_dyn_psnr_masked']:.3f}, dyn_corr "
            f"{sc['mean_dyn_corr']:.4f} (JAX: {j.get('mean_psnr', float('nan')):.2f}, "
            f"{j.get('mean_ssim', float('nan')):.3f}, "
            f"{j.get('mean_dyn_psnr_masked', float('nan')):.2f}, "
            f"{j.get('mean_dyn_corr', float('nan')):.3f})")
    log(f"  run_render of checkpoint-best, 2 views: {cp['render']['wall_s']:.2f} s, "
        f"{cp['render']['k1_launches']} K1 launches")
    g = cp["scores"][1000]
    log(f"  quality gate at checkpoint-1000: PSNR {g['mean_psnr']:.3f} >= {GATE_PSNR} and "
        f"dyn_corr {g['mean_dyn_corr']:.4f} >= {GATE_DYN_CORR}: "
        f"{'passed' if cp['gate_passed'] else 'FAILED'}")


def steady_state_times(run: dict, hull, n_steps: int = 10, warmup: int = 3,
                       names=("k3", "k1k2", "plain", "k3_hull", "k3_bf16", "k3_res")) -> dict:
    """Flagship step and eval-render times (ms) on a main path's dataset and
    state, once warm, path by path in turns and then in the reverse order;
    host clock around synchronized work. ``k3_bf16`` is K3 under bf16
    compute, ``k3_res`` over bf16 residual storage."""
    from nerfca_tpu_torch.train import evaluation
    from nerfca_tpu_torch.train.step import make_composite_train_step

    setup, state = run["setup"], run["state"]
    dd, cfgs, view = setup["device_data"], setup["cfgs"], setup["test_views"][0]
    paths = {"k3": (True, True, None, {}), "k1k2": (True, False, None, {}),
             "plain": (False, False, None, {}), "k3_hull": (True, True, hull, {}),
             "k3_bf16": (True, True, None, {"compute_dtype": "bfloat16"}),
             "k3_res": (True, True, None, {"pallas_bf16_residuals": True})}
    paths = {k: paths[k] for k in names}

    times: dict = {}
    order = list(paths)
    for path in order + order[::-1]:
        use_pallas, fused, h, precision = paths[path]
        hp = dataclasses.replace(setup["hp"], use_pallas=use_pallas, use_fused_loss=fused,
                                 **precision)
        step = make_composite_train_step(cfgs, hp, setup["tx"], setup["depth_values"],
                                         setup["max_pixel_value"])

        def train_step():
            step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"], hull=h)

        def render():
            evaluation.render_test_view(state.params, view["origins"], view["directions"],
                                        view["phases"], setup["depth_values"], state.step,
                                        cfgs, hp, setup["max_pixel_value"], hull=h)

        wall_ms(train_step, warmup)
        times.setdefault(f"step_ms_{path}", []).append(wall_ms(train_step, n_steps))
        wall_ms(render, 1)
        times.setdefault(f"eval_ms_{path}", []).append(wall_ms(render, 1))
    return times


def profile_k3_step(run: dict, n_steps: int = 3) -> dict:
    """:func:`profile_steps` of warm K3 steps on a main path's state."""
    from nerfca_tpu_torch.train.step import make_composite_train_step

    setup = run["setup"]
    hp = dataclasses.replace(setup["hp"], use_pallas=True, use_fused_loss=True)
    step = make_composite_train_step(setup["cfgs"], hp, setup["tx"], setup["depth_values"],
                                     setup["max_pixel_value"])
    return profile_steps(step, run["state"], setup["device_data"], n_steps)


def profile_steps(step, state, dd: dict, n_steps: int = 3) -> dict:
    """Device time by kernel over ``n_steps`` warm steps of ``step``
    (torch.profiler), per step, with the window's wall time and the
    device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run_steps(n):
        for _ in range(n):
            step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"])

    run_steps(3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps(n_steps)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((e.key, us / n_steps / 1e3, e.count / n_steps))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"wall_ms_per_step": wall_us / n_steps / 1e3, "device_ms_per_step": busy_ms,
            "busy_share": busy_ms / (wall_us / n_steps / 1e3), "n_kernels_per_step":
            sum(r[2] for r in rows),
            "top": [[name[:60], round(ms, 4), count] for name, ms, count in rows[:8]]}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


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


def plain_sharded(mesh, args, n_rays: int):
    """The sharded entry's composition built from the plain version alone:
    this rank's ``plain_train_loss_and_grads`` on its slice of the rays with
    the normalizations set to ``n_rays``, then a SUM all-reduce of the terms
    and gradients (``param_items`` order) and a MAX all-reduce of
    ``sigma_s_max``/``sigma_d_max``. Returns what the entry returns."""
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.parallel import batch_sharding
    from nerfca_tpu_torch.train.step import param_items

    part = batch_sharding(mesh, "data").slice(n_rays)
    local = [a[part] if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n_rays
             else a for a in args]
    loss, terms, g_s, g_t = ft.plain_train_loss_and_grads(*local, total_rays=n_rays)
    grads = [g for _, g in param_items({"static": g_s, "temp": g_t})]
    names = list(terms)
    maxima = [ft.TERM_NAMES[i] for i in ft.MAX_TERMS]
    group = mesh.get_group("data")
    buf = torch.cat([torch.stack([loss] + [terms[k] for k in names])]
                    + [g.reshape(-1) for g in grads])
    top = torch.stack([terms[k] for k in maxima])
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    terms = dict(zip(names, buf[1:1 + len(names)]))
    terms.update(zip(maxima, top))
    off = 1 + len(names)
    for g in grads:
        g.copy_(buf[off:off + g.numel()].view_as(g))
        off += g.numel()
    return buf[0], terms, g_s, g_t


def dp_rank(rank: int, world: int, port: int, out_dir: str, device: str = "cuda",
            n_rays: int = 1024, n_samples: int = 500) -> None:
    """One rank of phase 4g (``DP_WORLD`` processes over gloo, one card):
    the sharded K3 on the flagship batch against K3 and against the plain
    version on the whole batch; the per-rank K3 on its rays, the all-reduce
    of its buffer, the whole sharded call and the same composition of the
    plain version (:func:`plain_sharded`) timed; then ``DP_STEPS``
    data-parallel train steps. Writes ``rank<rank>.pt`` under ``out_dir``."""
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
    pb = k3_problem(device=dev, n_rays=n_rays, n_samples=n_samples)
    args = pb["args"](False)
    shard = ft.fused_train_loss_and_grads_sharded(mesh, "data", *args)
    full = ft.fused_train_loss_and_grads(*args)
    res.update(k3_errors("", shard, full))
    res.update(k3_errors("_vs_plain", shard, ft.plain_train_loss_and_grads(*args)))
    if device == "cuda":
        part = slice(rank * n_rays // world, (rank + 1) * n_rays // world)
        local = [a[part] if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == n_rays
                 else a for a in args]
        res["local_k3_ms"] = cuda_time_ms(
            lambda: ft.fused_train_loss_and_grads(*local, total_rays=n_rays))
        res["local_plain_ms"] = cuda_time_ms(
            lambda: ft.plain_train_loss_and_grads(*local, total_rays=n_rays))
        # the same K3 with the other ranks waiting at a barrier (the ranks
        # share one card)
        dist.barrier()
        for r in range(world):
            if r == rank:
                res["local_k3_ms_alone"] = cuda_time_ms(
                    lambda: ft.fused_train_loss_and_grads(*local, total_rays=n_rays))
            dist.barrier()
        # the entry's SUM buffer: the 16 terms and K2's gradient buffer
        n_buf = ft.TERMS + ft._terms_grads(*local, total_rays=n_rays)[1].numel()
        buf = torch.zeros(n_buf, device=dev)
        res["buffer_floats"] = n_buf
        res["allreduce_ms"] = wall_ms(lambda: dist.all_reduce(buf), 10)
        res["sharded_ms"] = wall_ms(
            lambda: ft.fused_train_loss_and_grads_sharded(mesh, "data", *args), 10)
        res["plain_sharded_ms"] = wall_ms(lambda: plain_sharded(mesh, args, n_rays), 10)
    res.update(dp_train(dp_problem(dev, n_rays, n_samples), mesh))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def data_parallel_phase(workdir: str, device: str = "cuda", n_rays: int = 1024,
                        n_samples: int = 500) -> dict:
    """Phase 4g, data parallelism at full width: (1) world 1 over NCCL in
    this process, the sharded entry against the unsharded K3 bitwise;
    (2) ``DP_WORLD`` ranks over gloo on the one card (NCCL refuses two ranks
    on one device), spawned: the sharded K3 within K3's gate of K3 on the
    whole batch, then ``DP_STEPS`` data-parallel steps, the parameters
    bitwise equal across ranks and the losses within ``LOSS_REL`` of the
    single-card steps from the same state. The kernels are built before the
    ranks start. Raises on any failure."""
    import multiprocessing as mp

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
        args = k3_problem(device=dev, n_rays=n_rays, n_samples=n_samples)["args"](False)
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
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dp_rank, args=(r, DP_WORLD, port, out_dir, device, n_rays,
                                               n_samples)) for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    res["ranks_wall_s"] = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"data-parallel ranks exited {[p.exitcode for p in procs]}")
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
    import dataclasses

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
    every case of :func:`dpa_problems` under the mesh, then, on the card,
    the two-kernel step's parts timed with both ranks running: K1+K2 on
    this rank's slice, the all-reduce of the gradient buffer, the whole
    step. Writes ``dpa_rank<rank>.pt`` under ``out_dir``."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.parallel import batch_sharding, make_mesh, multihost
    from nerfca_tpu_torch.train.step import composite_grads, param_items

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device=device)
    dev = torch.device(device)
    cases = dpa_problems(dev, n_rays, n_samples, n_fine)
    res: dict = {"rank": rank}
    for name, case in cases.items():
        run = dpa_train(case, mesh)
        res[name] = {k: run[k] for k in ("losses", "launches", "params", "grads0")}
    if device == "cuda":
        case = cases["two_kernel"]
        step, state = case["make"](mesh), case["state"]()
        rays, phases, var_ids, non_var_ids = case["args"]
        part = batch_sharding(mesh).uneven_slice(n_rays)
        hp = case["hp"]
        # the slice's K1 + K2 under the loss battery: composite_grads on the
        # slice alone
        batch = {"origins": rays[part, 0].contiguous(), "directions": rays[part, 1].contiguous(),
                 "pixels": rays[part, 2, 0].contiguous(), "weights": rays[part, 3, 0].contiguous(),
                 "phases": phases[part],
                 "initial_intensities": torch.full((part.stop - part.start,), 2.16, device=dev)}
        res["local_grads_ms"] = cuda_time_ms(lambda: composite_grads(
            state.params, batch, case["z"], 0, case["cfgs"], hp))
        n_buf = sum(t.numel() for _, t in param_items(state.params))
        buf = torch.zeros(n_buf, device=dev)
        res["grad_floats"] = n_buf
        res["allreduce_ms"] = wall_ms(lambda: dist.all_reduce(buf), 10)
        res["step_ms"] = wall_ms(lambda: step(state, rays, phases, var_ids, non_var_ids), 10)
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
    import multiprocessing as mp

    import numpy as np
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.parallel import make_mesh, multihost
    from nerfca_tpu_torch.train.step import param_items

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
    if device == "cuda":
        case = cases["two_kernel"]
        step, state = case["make"](None), case["state"]()
        res["single_step_ms"] = wall_ms(lambda: step(state, *case["args"]), 10)
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
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dpa_rank, args=(r, DP_WORLD, port, out_dir, device, n_rays,
                                                n_samples, n_fine)) for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    res["ranks_wall_s"] = time.perf_counter() - t0
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 4n ranks exited {[p.exitcode for p in procs]}")
    ranks = [torch.load(os.path.join(out_dir, f"dpa_rank{r}.pt"), weights_only=False)
             for r in range(DP_WORLD)]
    res["timing"] = [{k: r[k] for k in ("local_grads_ms", "grad_floats", "allreduce_ms",
                                        "step_ms") if k in r} for r in ranks]
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
        f"the one card ({dpa['ranks_wall_s']:.1f} s for the ranks); the fine batch's arg-max "
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
    t = dpa["timing"]
    if t and t[0]:
        log(f"  two-kernel step, both ranks running ({card}): per rank K1+K2 under the loss "
            f"battery on its {1024 // DP_WORLD} rays {[round(r['local_grads_ms'], 3) for r in t]} "
            f"ms, all-reduce of {t[0]['grad_floats']} gradient floats "
            f"{[round(r['allreduce_ms'], 3) for r in t]} ms, the whole step "
            f"{[round(r['step_ms'], 3) for r in t]} ms; single-card two-kernel step "
            f"{dpa['single_step_ms']:.3f} ms")


def static_cfg(fourier: bool = False):
    """The static field of ``configs/3d.txt`` (``--static_pos_enc fourier``
    with ``fourier``: its sigma 2, basis 12)."""
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.trainer import static_config_from_args

    extra = ["--static_pos_enc", "fourier"] if fourier else []
    return static_config_from_args(parse_args(["--config", STATIC_CONFIG, *extra]))


def check_static_entries(params_static=None, window=None, n_rays: int = 1024,
                         n_samples: int = 500, seed: int = 0, timed: bool = True,
                         fourier: bool = False) -> dict:
    """The static method's entries against their plain twins at the full
    shapes of ``configs/3d.txt`` (``n_rays`` x ``n_samples`` points of the
    flagship view): ``fused_static_field`` (the one-field K1/K2) on
    ``params_static`` (the seed's initial field when None) under ``window``
    (every band open when None), and the two-field point form
    ``fused_composite_fields`` (the flagship pair) against
    ``plain_composite_fields``. Forward within K1_ATOL, gradients by K2's
    rule. With ``timed``, CUDA-event times of the one-field K1 and K2, of
    the point form's K1 and K2 and of the composite ray-form K1 and K2 on
    the same points, in turns and then in the reverse order, with the plain
    twins. With ``fourier`` the fields take the fourier encoding
    (``configs/3d.txt --static_pos_enc fourier``, the flagship pair at sigma
    2). Raises on a disagreement."""
    import torch

    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    dev = torch.device("cuda")
    cfg = static_cfg(fourier)
    if params_static is None:
        params_static = init_static_field(prng.key(seed), cfg, dev)
    if window is None and not fourier:
        window = torch.ones(cfg.pos_enc_basis, device=dev)

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
    res = {"k1_err": k1_err, "k2_err": k2_err, "k2_norm": k2_norm, "k2_worst": worst,
           "param_floats": sum(t.numel() for t in leaves)}

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
    res["point_param_floats"] = sum(t.numel() for t in f_leaves)
    if not timed:
        return res

    # the launch functions on packed inputs, as check_kernels times them
    pack = ff._Pack(cfg, ff._leaves(params_static), ff.enc_table(params_static, cfg, window),
                    dev)
    pack_s, pack_t = packs(fp, (cfg_s, cfg_t), w12, dev)
    n = n_rays * n_samples
    po, pd = pts.reshape(n, 3), torch.zeros(n, 3, device=dev)
    z0 = torch.zeros(1, device=dev)
    zero_ph, lat0 = torch.zeros(n, dtype=torch.int32, device=dev), torch.zeros(1, 8, device=dev)
    pph32 = pph.reshape(n).to(torch.int32).contiguous()
    ph32 = phases.to(torch.int32)
    lat = fp["temp"]["latents"].detach()
    g1 = cot.reshape(n).contiguous()
    g2 = [c.reshape(n).contiguous() for c in cot2]
    loss_p = (ff.plain_static_field(params_static, pts, cfg, window) * cot).sum()

    def plain_fwd():
        with torch.no_grad():
            return ff.plain_static_field(params_static, pts, cfg, window)

    def point_plain_fwd():
        with torch.no_grad():
            return ff.plain_composite_fields(*pargs)

    fns = {
        "static_k1": lambda: ff.fused_field_fwd(pack, None, po, pd, z0, zero_ph, lat0),
        "static_k2": lambda: ff.fused_field_bwd(pack, None, po, pd, z0, zero_ph, lat0, g1, None),
        "point_k1": lambda: ff.fused_field_fwd(pack_s, pack_t, po, pd, z0, pph32, lat),
        "point_k2": lambda: ff.fused_field_bwd(pack_s, pack_t, po, pd, z0, pph32, lat, *g2),
        "composite_k1": lambda: ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat),
        "composite_k2": lambda: ff.fused_field_bwd(pack_s, pack_t, origins, dirs, z, ph32, lat,
                                                   *g2),
        "static_plain_fwd": plain_fwd,
        "point_plain_fwd": point_plain_fwd,
        "static_plain_bwd": lambda: torch.autograd.grad(loss_p, leaves, retain_graph=True),
    }
    times: dict = {}
    for name in list(fns) + list(fns)[::-1]:
        times.setdefault(name, []).append(cuda_time_ms(fns[name], iters=10))
    res["ms"] = times
    return res


def static_phase(workdir: str, fourier: bool = False) -> dict:
    """Phase 4d: the static 3-D method through ``run_nerf.main`` on
    ``configs/3d.txt`` at full width with ``--use_pallas true`` (its own
    one-phase 128^3 dataset, ``STATIC_STEPS`` steps, an eval every
    ``STATIC_EVERY``), launch counts set to 0 just before and read just
    after: the one-field K1 and K2 once a step, no composite launch and no
    K3. Then the step-0 eval (the seed's initial field, as the trainer's
    eval scores it), the entries against their twins at the trained state,
    and the warm step, kernels against plain, and the eval view, in turns.
    With ``fourier`` (phase 4f): ``configs/3d.txt --static_pos_enc
    fourier`` on the same dataset, ``FOURIER_STATIC_STEPS`` steps, held
    against its own JAX record, no profile. Raises on any failure."""
    import torch

    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.train import evaluation
    from nerfca_tpu_torch.train.step import field_window, make_static_train_step

    steps, every = (FOURIER_STATIC_STEPS, FOURIER_STATIC_STEPS) if fourier else (STATIC_STEPS,
                                                                                  STATIC_EVERY)
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
                                   timed=False, fourier=fourier)

    dd = setup["device_data"]
    paths = {"kernels": True, "plain": False}
    steady: dict = {}
    for path in list(paths) + list(paths)[::-1]:
        hp = dataclasses.replace(setup["hp"], use_pallas=paths[path])
        step = make_static_train_step(cfg, hp, setup["tx"], setup["depth_values"],
                                      setup["max_pixel_value"])

        def train_step():
            step(state, dd["rays"], dd["phases"], dd["var_ids"], dd["non_var_ids"])

        wall_ms(train_step, 3)
        steady.setdefault(f"step_ms_{path}", []).append(wall_ms(train_step, 10))
        steady.setdefault("eval_ms", []).append(
            wall_ms(lambda: eval_psnr(state.params, state.step), 1))
    prof = None if fourier else profile_steps(
        make_static_train_step(cfg, setup["hp"], setup["tx"], setup["depth_values"],
                               setup["max_pixel_value"]), state, dd)
    return {"res": res, "loss": loss, "psnr": psnr, "trained": trained, "steady": steady,
            "profile": prof, "steps": steps, "fourier": fourier,
            "record": JAX_STATIC_FOURIER if fourier else JAX_STATIC,
            "n_total": n_total, "meta_run": meta["run"],
            "rays": int(dd["rays"].shape[0]), "view": [w, h]}


def report_static(sp: dict, card: str) -> bool:
    """Print phase 4d (4f) beside the JAX record; True when both gates pass."""
    with open(sp["record"]) as f:
        rec = json.load(f)
    res, loss, psnr = sp["res"], sp["loss"], sp["psnr"]
    what = "configs/3d.txt --static_pos_enc fourier" if sp["fourier"] else "configs/3d.txt"
    log(f"static 3-D method ({what}, run_nerf, {sp['steps']} steps; {card}): "
        f"{res['wall_s']:.1f} s wall with the dataset build ({sp['rays']} rays, view "
        f"{sp['view']}); {res['train_steps']} steps in {res['train_s']:.2f} s of train chunks "
        f"({1e3 * res['train_s'] / res['train_steps']:.2f} ms a step, first chunk included); "
        f"in-loop evals {[round(m, 1) for m in res['eval_ms']]} ms")
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
    log(f"  steady state in turns, kernels / plain then reversed: {json.dumps(sp['steady'])}")
    if sp["profile"] is not None:
        log(f"  profile of 3 static kernel steps: {json.dumps(sp['profile'])}")
    log(f"  gates against the JAX record: step-0 train_loss rel {loss0_rel:.3e} <= "
        f"{GATE_STATIC_LOSS0_REL} and step-{last} test_image_psnr gap {psnr_gap:.4f} dB <= "
        f"{GATE_STATIC_PSNR_DB}: {'passed' if passed else 'FAILED'}")
    return passed


def field_macs(cfg) -> int:
    """Multiply-adds of one field's MLP per point."""
    k0 = cfg.encoded_features + (cfg.num_time_dim if cfg.use_time_latents else 0)
    return k0 * cfg.num_filters + cfg.num_early_layers * cfg.num_filters ** 2 + cfg.num_filters


def table_floats(cfg) -> int:
    """What a field's encoding reads besides the points: its band window,
    or its fourier projection."""
    return 3 * cfg.pos_enc_basis if cfg.pos_enc == "fourier" else cfg.pos_enc_basis


def bounds(shapes: dict, fourier: bool = False, bf16: bool = False) -> dict:
    """Least time (ms) the card could take for each kernel's work at this
    run's shapes, max(bytes / HBM rate, operations / peak), on the route the
    kernel takes, with every route beside it: f32 FMAs on the CUDA cores
    (operations / 67 TFLOP/s), 3xTF32 on the tensor cores (3 x operations /
    495 TFLOP/s: three TF32 products per f32 product) and bf16 on the tensor
    cores (operations / 989 TFLOP/s, one product). ``fourier``: the fields
    on the fourier encoding (72 encoded features against 75); ``bf16``: the
    bf16 instantiations' route."""
    cfg_s, cfg_t = flagship_cfgs(fourier)
    r, s, n_par = shapes["n_rays"], shapes["n_samples"], shapes["param_floats"]
    n = r * s
    fwd = 2 * (field_macs(cfg_s) + field_macs(cfg_t)) * n  # forward flops
    # origins, directions, depths (shared [S] or per-ray), phases, the
    # encodings' tables
    ray_bytes = 4 * (6 * r + shapes.get("depth_floats", s) + r + table_floats(cfg_s)
                     + table_floats(cfg_t))
    f32_s = lambda flops: flops / PEAK_F32_FLOPS
    tc_s = lambda flops: 3 * flops / PEAK_TF32_FLOPS
    bf_s = lambda flops: flops / PEAK_BF16_FLOPS
    route_s = bf_s if bf16 else tc_s
    mma = "bf16 mma.sync on the tensor cores" if bf16 else "3xTF32 mma.sync on the tensor cores"
    work = {
        # K1: the forward; reads rays and weights, writes two raw densities
        "k1": (mma, fwd, ray_bytes + 4 * n_par + 8 * n),
        # K2: its VJP, counted as 3x the forward (recompute, dW, dX); reads
        # rays, weights, the two cotangents, writes every gradient
        "k2": (mma, 3 * fwd, ray_bytes + 8 * n_par + 8 * n),
        # K3: forward + backward without recompute (3x the forward); K1 runs
        # the forward and K2 the backward; the loss phase (~100 flops a
        # sample on the CUDA cores) is left out; reads rays, per-ray data,
        # weights and the gate, writes every gradient and the terms
        "k3": (f"K1 then K2 {mma}, the loss kernel between", 3 * fwd,
               ray_bytes + 12 * r + 4 * n + 8 * n_par + 64),
    }
    # the point-form entries, on materialized points (12 bytes a point in,
    # phases 4 more for the pair): the static field alone (one-field K1 and
    # K2) and the flagship pair
    if "static_param_floats" in shapes:
        fwd1 = 2 * field_macs(static_cfg(fourier)) * n
        p1 = shapes["static_param_floats"]
        work["static_k1"] = (mma, fwd1, 12 * n + 4 * p1 + 4 * n)
        work["static_k2"] = (mma, 3 * fwd1, 12 * n + 4 * n + 8 * p1)
    if "point_param_floats" in shapes:
        p2 = shapes["point_param_floats"]
        work["point_k1"] = (mma, fwd, 16 * n + 4 * p2 + 8 * n)
        work["point_k2"] = (mma, 3 * fwd, 16 * n + 8 * n + 8 * p2)
    out = {}
    for k, (route, flops, nbytes) in work.items():
        t_ops, t_bytes = route_s(flops), nbytes / PEAK_BYTES
        out[k] = {"route": route, "bound_ms": 1e3 * max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                  "bound_ms_f32_cuda_cores": 1e3 * max(f32_s(flops), t_bytes),
                  "bound_ms_3xtf32_tensor_cores": 1e3 * max(tc_s(flops), t_bytes),
                  "bound_ms_bf16_tensor_cores": 1e3 * max(bf_s(flops), t_bytes),
                  "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
    return out


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

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    built = build.build(verbose=True)
    log(f"kernel build ({', '.join(built)}, in parallel): {time.perf_counter() - t0:.1f} s")
    for name, (_, out) in built.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")
    ff_lib = build.load("fused_field")
    log(f"  shared memory per CTA: K1 {ff_lib.fused_field_smem_bytes(0)} bytes, K2 "
        f"{ff_lib.fused_field_smem_bytes(1)} bytes, loss kernel "
        f"{build.load('fused_train').fused_train_smem_bytes(500)} bytes at 500 samples")

    kc = check_kernels()
    log(f"K1 max abs err {kc['k1_err']:.3e} (limit {K1_ATOL}); "
        f"K2 max abs err {kc['k2_err']:.3e}, worst leaf {kc['k2_worst']} at "
        f"{kc['k2_norm']:.3e} of its scale (limit {K2_REL})")
    log(f"K1 {kc['k1_ms']:.3f} ms vs plain {kc['k1_plain_ms']:.3f} ms; "
        f"K2 {kc['k2_ms']:.3f} ms vs plain backward {kc['k2_plain_ms']:.3f} ms "
        f"(1024 x 500 points, {card})")
    k3 = check_k3()
    for tag, what in (("", "no hull"), ("_hull", f"hull gate, {k3['empty_rays']} empty rays")):
        log(f"K3 ({what}): loss rel err {k3['loss_rel' + tag]:.3e}, worst term rel err "
            f"{k3['term_rel' + tag]:.3e} (limit {LOSS_REL}); grads max abs err "
            f"{k3['err' + tag]:.3e}, worst leaf {k3['worst' + tag]} at {k3['norm' + tag]:.3e} "
            f"of its scale (limit {K2_REL}); {k3['ms' + tag]:.3f} ms vs plain "
            f"{k3['plain_ms' + tag]:.3f} ms")
    log(f"K3 apart: forward (K1) {k3['forward_ms']:.3f} ms, loss phase (loss kernel: loss, "
        f"terms, cotangents) {k3['loss_phase_ms']:.3f} ms ({card})")
    rel = check_step_loss()
    log(f"flagship step loss, kernels vs plain: rel diff {rel:.3e} (limit {LOSS_REL})")
    se = check_static_entries()
    log(f"fused_static_field (one-field K1/K2, configs/3d.txt's field, initial params, every "
        f"band open) vs plain_static_field: max abs err {se['k1_err']:.3e} (limit {K1_ATOL}); "
        f"grads max abs err {se['k2_err']:.3e}, worst leaf {se['k2_worst']} at "
        f"{se['k2_norm']:.3e} of its scale (limit {K2_REL})")
    log(f"fused_composite_fields (point form, flagship pair) vs plain_composite_fields: max abs "
        f"err {se['point_k1_err']:.3e}; grads {se['point_k2_err']:.3e}, worst leaf "
        f"{se['point_k2_worst']} at {se['point_k2_norm']:.3e} of its scale")
    log(f"static / point-form / composite K1 and K2 in turns then reversed, CUDA events, "
        f"1024 x 500 points ({card}): {json.dumps(se['ms'])}")

    # the fourier encoding (basis 12, sigma 2) through K1, K2 and K3 at the
    # flagship shapes, under the same gates, the free_windowed times above
    # in the same call
    fk = check_kernels(fourier=True)
    log(f"fourier K1 max abs err {fk['k1_err']:.3e} (limit {K1_ATOL}); K2 max abs err "
        f"{fk['k2_err']:.3e}, worst leaf {fk['k2_worst']} at {fk['k2_norm']:.3e} of its scale "
        f"(limit {K2_REL}); K1 {fk['k1_ms']:.3f} ms vs plain {fk['k1_plain_ms']:.3f} ms, K2 "
        f"{fk['k2_ms']:.3f} ms vs plain {fk['k2_plain_ms']:.3f} ms; free_windowed K1 "
        f"{kc['k1_ms']:.3f} / K2 {kc['k2_ms']:.3f} ms ({card})")
    fk3 = check_k3(fourier=True)
    for tag, what in (("", "no hull"), ("_hull", f"hull gate, {fk3['empty_rays']} empty rays")):
        log(f"fourier K3 ({what}): loss rel err {fk3['loss_rel' + tag]:.3e}, worst term rel "
            f"err {fk3['term_rel' + tag]:.3e}; grads worst leaf {fk3['worst' + tag]} at "
            f"{fk3['norm' + tag]:.3e} of its scale; {fk3['ms' + tag]:.3f} ms vs plain "
            f"{fk3['plain_ms' + tag]:.3f} ms")
    fse = check_static_entries(fourier=True)
    log(f"fourier fused_static_field (configs/3d.txt --static_pos_enc fourier) vs plain: max "
        f"abs err {fse['k1_err']:.3e}; grads worst leaf {fse['k2_worst']} at "
        f"{fse['k2_norm']:.3e} of its scale; fourier point form {fse['point_k1_err']:.3e} / "
        f"{fse['point_k2_norm']:.3e}")
    log(f"fourier static / point-form / composite K1 and K2 in turns then reversed, CUDA "
        f"events, 1024 x 500 points ({card}): {json.dumps(fse['ms'])}")

    # bf16 compute (the BF16 instantiations) and bf16 residual storage (K2's
    # RES_BF16 one, under K3) against their twins at the flagship shapes
    bk, bfk = check_kernels_bf16(), check_kernels_bf16(fourier=True)
    for what, r in (("bf16", bk), ("bf16 one field (configs/3d.txt's)", bk["one_field"]),
                    ("bf16 fourier", bfk), ("bf16 fourier one field", bfk["one_field"])):
        log(f"{what} K1: mean |kernel - twin| {r['fwd_mean_err']:.3e} against bf16 vs f32 twin "
            f"{r['fwd_mean_gap']:.3e} (ratio {r['fwd_ratio']:.3e}, limit {BF16_GATE}), max abs "
            f"{r['max_abs_err']:.3e}; K2: worst leaf {r['grad_err']:.3e} of scale against "
            f"{r['grad_gap']:.3e} (ratio {r['grad_ratio']:.3e}); K1 {r['k1_ms']:.3f} ms vs twin "
            f"{r['k1_plain_ms']:.3f} ms, K2 {r['k2_ms']:.3f} ms vs twin backward "
            f"{r['k2_plain_ms']:.3f} ms ({card})")
    bk3 = check_k3_bf16()
    log(f"bf16 K3: grads worst leaf {bk3['grad_err']:.3e} against bf16 vs f32 twin "
        f"{bk3['grad_gap']:.3e} (ratio {bk3['grad_ratio']:.3e}, limit {BF16_GATE}); loss rel "
        f"{bk3['loss_err']:.3e} (bf16 vs f32 twin {bk3['loss_gap']:.3e}), worst term "
        f"{bk3['term_err']:.3e} ({bk3['term_gap']:.3e}), limit {LOSS_REL}; {bk3['ms']:.3f} ms vs "
        f"twin {bk3['plain_ms']:.3f} ms ({card})")
    log(f"K3 over bf16 residuals: loss and terms bitwise the f32 K3's "
        f"{bk3['res_loss_bitwise']}; {bk3['res_leaves_moved']} leaves move; K2 over bf16 "
        f"residuals on unit-normal cotangents: share of the twin's change within "
        f"{bk3['res_share_err']:.3e} of 1 (limit {BF16_GATE}; |dk - dt| up to "
        f"{bk3['res_change_diff']:.3e} of |dt|, |dt| at least {bk3['res_change_of_leaf']:.3e} "
        f"of its leaf, f32 K2 vs twin {bk3['res_f32_kernel_vs_twin']:.3e}); on K3's own "
        f"cotangents: share off by {bk3['res_share_err_k3_cotangents']:.3e}, |dt| at least "
        f"{bk3['res_change_of_leaf_k3_cotangents']:.3e} of its leaf against the f32 K2's "
        f"{bk3['res_f32_kernel_vs_twin_k3_cotangents']:.3e}; K3 against the twin "
        f"worst leaf {bk3['res_grad_err_vs_twin']:.3e} of scale; {bk3['res_ms']:.3f} ms vs twin "
        f"{bk3['res_plain_ms']:.3f} ms, f32 K3 {bk3['f32_ms']:.3f} ms ({card})")

    # the fine pass's shapes: per-ray sorted depths, 1024 x (500 + 128)
    fkc = check_kernels_fine()
    log(f"fine shapes ({fkc['shapes']['n_rays']} rays x {fkc['shapes']['n_samples']} per-ray "
        f"depths): K1 max abs err {fkc['k1_err']:.3e} (limit {K1_ATOL}); K2 max abs err "
        f"{fkc['k2_err']:.3e}, worst leaf {fkc['k2_worst']} at {fkc['k2_norm']:.3e} of its "
        f"scale (limit {K2_REL}); K1 {fkc['k1_ms']:.3f} ms vs plain {fkc['k1_plain_ms']:.3f} ms, "
        f"K2 {fkc['k2_ms']:.3f} ms vs plain backward {fkc['k2_plain_ms']:.3f} ms ({card})")

    builds = time_dataset_builds()
    with tempfile.TemporaryDirectory() as workdir, VolumeBuilds(workdir) as vb:
        mp = drive_main_path(workdir, [], 6)
        tl = mp["train_launches"]
        if tl["fused_field_fwd"] < 1 or tl["fused_field_bwd"] < 1:
            raise AssertionError(f"K1/K2 not launched during training: {tl}")
        log(f"main path, two kernels: {mp['wall_s']:.1f} s wall (dataset build included); "
            f"train_loss {[round(r['train_loss'], 6) for r in mp['train']]}")
        log(f"  launches: training {tl}, eval {mp['eval_launches']}")
        log(f"  eval render: {mp['eval_ms']} ms; test_image_psnr "
            f"{mp['eval']['test_image_psnr']:.3f}")

        fp = drive_main_path(workdir, ["--use_fused_loss", "true"], 6)
        tl = fp["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_bwd"] != 6
                or tl["fused_field_fwd"] != 6):
            raise AssertionError(f"the fused-loss path did not run K1, the loss kernel and K2 "
                                 f"once on every step: {tl}")
        log(f"main path, fused loss (K3): {fp['wall_s']:.1f} s wall; "
            f"train_loss {[round(r['train_loss'], 6) for r in fp['train']]}")
        log(f"  launches: training {tl}, eval {fp['eval_launches']}")
        log(f"  train_time per step, chunk means incl. warm-up (s): "
            f"{[r['train_time'] for r in fp['train']]}")
        log(f"  eval render: {fp['eval_ms']} ms; test_image_psnr "
            f"{fp['eval']['test_image_psnr']:.3f}")

        # phase 4e: the fourier composite through K3 on the flagship dataset
        fc = drive_main_path(workdir, ["--use_fused_loss", "true", *FOURIER_ARGV], 6)
        tl = fc["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_bwd"] != 6
                or tl["fused_field_fwd"] != 6):
            raise AssertionError(f"the fourier composite did not run K3 once a step: {tl}")
        log(f"main path, fourier composite (both fields fourier, sigma 2, K3): "
            f"{fc['wall_s']:.1f} s wall; train_loss {[round(r['train_loss'], 6) for r in fc['train']]}")
        log(f"  launches: training {tl}, eval {fc['eval_launches']}")
        log(f"  eval render: {fc['eval_ms']} ms; test_image_psnr "
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
        log(f"main path, bf16 compute (K3 bf16): {bp['wall_s']:.1f} s wall; train_loss "
            f"{[round(r['train_loss'], 6) for r in bp['train']]}")
        log(f"  launches: training {tl}, eval {el}")
        log(f"  eval render: {bp['eval_ms']} ms; test_image_psnr "
            f"{bp['eval']['test_image_psnr']:.3f}")
        rp = drive_main_path(workdir, ["--use_fused_loss", "true", "--pallas_bf16_residuals",
                                       "true"], 6)
        tl = rp["train_launches"]
        if (tl["fused_train_loss"] != 6 or tl["fused_field_fwd"] != 6
                or tl["fused_field_bwd_res_bf16"] != 6 or tl["fused_field_bwd"]):
            raise AssertionError(f"bf16 residual main path: expected K1, the loss kernel and "
                                 f"the residual K2 once a step: {tl}")
        log(f"main path, bf16 residuals (K3 over the bf16 scratch): {rp['wall_s']:.1f} s wall; "
            f"train_loss {[round(r['train_loss'], 6) for r in rp['train']]} (f32 K3: "
            f"{[round(r['train_loss'], 6) for r in fp['train']]})")
        log(f"  launches: training {tl}, eval {rp['eval_launches']}")
        log(f"  eval render: {rp['eval_ms']} ms; test_image_psnr "
            f"{rp['eval']['test_image_psnr']:.3f}")

        # phases 4j and 4j': the fine pass, on K1/K2 with a 128-wide fine
        # pair and plain with the shipped 64-wide one
        fine = fine_phase(workdir)
        if not report_fine(fine, card):
            raise AssertionError("fine pass: the run is outside the gates against the JAX record")
        sfp = shipped_fine_phase(workdir)
        log(f"shipped 64-wide fine pair ({FINE_SAMPLES} fine samples, --use_fused_loss true): "
            f"{sfp['wall_s']:.1f} s wall; warned: {sfp['warning']!r}; train_loss "
            f"{[round(r['train_loss'], 6) for r in sfp['train']]}")
        log(f"  launches: training {sfp['train_launches']}, eval {sfp['eval_launches']}; eval "
            f"render {sfp['eval_ms']} ms; test_image_psnr {sfp['eval']['test_image_psnr']:.3f}, "
            f"test_image_psnr_fine {sfp['eval']['test_image_psnr_fine']:.3f}")

        cp = clean_protocol_phase(workdir)
        report_clean_protocol(cp, card)
        if not cp["gate_passed"]:
            raise AssertionError("clean protocol: checkpoint-1000 is under the quality gate")
        hull = cp["hull"]
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
            f"configs/synth-4view-best.txt; {card}): {sw['wall_s']:.1f} s wall, "
            f"{len(sw['runs'])} runs; rungs {hb['rung_iters']}, promoted "
            f"{[r.get('promoted') for r in hb['rungs']]}; scores "
            f"{[r['scores'] for r in hb['rungs']]}")
        runs = [(r["steps"][0], r["steps"][-1], r["launches"]["fused_train_loss"],
                 bool(r["resume_from"])) for r in sw["runs"]]
        log(f"  runs (first and last step, K3 launches, resumed): {runs}")

        # phases 4l, 4l' and 4m: non-SYNTH data, the volumes built in the
        # background since the first main path
        mg = non_synth_phases(workdir, vb, builds, card)["magix"]

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
            f"{dp['world1_bitwise']}; world {DP_WORLD} over gloo on the one card "
            f"({dp['ranks_wall_s']:.1f} s for the ranks): sharded K3 vs K3 on the whole batch, "
            f"per rank {[round(r['loss_rel'], 9) for r in dp['ranks']]} loss rel, grads worst "
            f"{[round(r['norm'], 6) for r in dp['ranks']]} of their scale; {DP_STEPS} steps: "
            f"parameters bitwise equal across ranks {dp['params_bitwise_equal']}, losses "
            f"{r0['losses']} vs single-card {dp['single_losses']} (rel "
            f"{[f'{x:.2e}' for x in dp['loss_rel_vs_single']]}); launches per rank "
            f"{[r['launches'] for r in dp['ranks']]}")
        log(f"  rank 0, both ranks running: K3 on its {1024 // DP_WORLD} rays "
            f"{r0['local_k3_ms']:.3f} ms (plain {r0['local_plain_ms']:.3f} ms), all-reduce of "
            f"{r0['buffer_floats']} floats {r0['allreduce_ms']:.3f} ms, the whole sharded call "
            f"{r0['sharded_ms']:.3f} ms, the plain version's composition "
            f"{r0['plain_sharded_ms']:.3f} ms; K3 on its rays with the other rank waiting "
            f"{[round(r['local_k3_ms_alone'], 3) for r in dp['ranks']]} ms; sharded K3 vs the "
            f"plain version on the whole batch, per rank "
            f"{[round(r['loss_rel_vs_plain'], 9) for r in dp['ranks']]} loss rel, grads worst "
            f"{[round(r['norm_vs_plain'], 6) for r in dp['ranks']]} of their scale")

        # phase 4n: the autograd paths (K1/K2, the fine pass, the static
        # step) under data parallelism
        t0 = time.perf_counter()
        dpa = data_parallel_autograd_phase(workdir)
        report_dpa(dpa, card)
        log(f"  phase 4n: {time.perf_counter() - t0:.1f} s")

    steady = steady_state_times(fp["run"], hull)
    log(f"steady state in turns, K3 / K1+K2 / plain / K3+hull / K3 bf16 / K3 over bf16 "
        f"residuals then reversed ({card}): {json.dumps(steady)}")
    log(f"MAGIX-SURR against the flagship ({card}): warm K3+hull step "
        f"{mg['steady']['step_ms_k3_hull']} ms (flagship batches, the clean hull: "
        f"{steady['step_ms_k3_hull']}), eval view {mg['steady']['eval_ms_k3_hull']} ms "
        f"({steady['eval_ms_k3_hull']}); dataset build {builds.get('MAGIX-SURR', float('nan')):.1f} "
        f"s ({builds.get('SYNTH', float('nan')):.1f})")
    fsteady = steady_state_times(fc["run"], None, names=("k3", "k1k2", "plain"))
    log(f"steady state of the fourier composite in turns, K3 / K1+K2 / plain then reversed "
        f"({card}): {json.dumps(fsteady)}")
    prof = profile_k3_step(fp["run"])
    log(f"profile of 3 K3 steps ({card}): {json.dumps(prof)}")

    bd = bounds({**kc["shapes"], "static_param_floats": se["param_floats"],
                 "point_param_floats": se["point_param_floats"]})
    fbd = bounds({**fk["shapes"], "static_param_floats": fse["param_floats"],
                  "point_param_floats": fse["point_param_floats"]}, fourier=True)
    rank_bd = bounds({**kc["shapes"], "n_rays": kc["shapes"]["n_rays"] // DP_WORLD})["k3"]
    bbd = bounds({**bk["shapes"], "static_param_floats": bk["one_field"]["param_floats"]},
                 bf16=True)
    fbbd = bounds({**bfk["shapes"], "static_param_floats": bfk["one_field"]["param_floats"]},
                  fourier=True, bf16=True)
    fbd_fine = bounds(fkc["shapes"])
    for k, b in [*bd.items(), *((f"{k}_fourier", b) for k, b in fbd.items()),
                 *((f"{k}_bf16", b) for k, b in bbd.items()),
                 *((f"{k}_fourier_bf16", b) for k, b in fbbd.items()),
                 *((f"{k}_fine_shapes", b) for k, b in fbd_fine.items() if k != "k3")]:
        log(f"{k.upper()} runs {b['route']}: bound {b['bound_ms']:.3f} ms ({b['bound_by']}); "
            f"all f32 on the CUDA cores {b['bound_ms_f32_cuda_cores']:.3f} ms, all 3xTF32 on "
            f"the tensor cores {b['bound_ms_3xtf32_tensor_cores']:.3f} ms, all bf16 on the "
            f"tensor cores {b['bound_ms_bf16_tensor_cores']:.3f} ms")

    def bound_keys(b):
        return {"math": b["route"], "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "bound_ms_f32_cuda_cores": b["bound_ms_f32_cuda_cores"],
                "bound_ms_3xtf32_tensor_cores": b["bound_ms_3xtf32_tensor_cores"],
                "bound_ms_bf16_tensor_cores": b["bound_ms_bf16_tensor_cores"]}

    launches, clean, static = fp["launches"], cp["res"]["launches"], sp["res"]["launches"]
    # phase 4n's launches on rank 0 (each rank launches as many) by case
    dpa_l = {name: c["launches"][0] for name, c in dpa["cases"].items()}

    def dpa_launches(key, names):
        return {name: dpa_l[name][key] for name in names}

    def mean(name):
        return sum(se["ms"][name]) / len(se["ms"][name])

    def fmean(name):
        return sum(fse["ms"][name]) / len(fse["ms"][name])

    kernels = [
        {"name": "fused_field_fwd (K1)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:527",
         "launches": launches["fused_field_fwd"],
         "launches_clean_protocol": clean["fused_field_fwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_field_fwd",
                                                         ("two_kernel", "uneven")),
         "max_abs_err": kc["k1_err"],
         "limit": f"abs {K1_ATOL}", "ms": kc["k1_ms"], "plain_ms": kc["k1_plain_ms"],
         **bound_keys(bd["k1"]),
         "library_ms": None},
        {"name": "fused_field_bwd (K2)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:604",
         "launches": launches["fused_field_bwd"],
         "launches_clean_protocol": clean["fused_field_bwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_field_bwd",
                                                         ("two_kernel", "uneven")),
         "max_abs_err": kc["k2_err"],
         "max_err_of_leaf_scale": kc["k2_norm"], "limit": f"{K2_REL} of leaf scale",
         "ms": kc["k2_ms"], "plain_ms": kc["k2_plain_ms"],
         **bound_keys(bd["k2"]),
         "library_ms": None},
        {"name": "fused_field_fwd + fused_train_loss + fused_field_bwd (K3)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_train.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:607",
         "launches": launches["fused_train_loss"],
         "launches_clean_protocol": clean["fused_train_loss"], "max_abs_err": k3["err"],
         "max_err_of_leaf_scale": k3["norm"], "loss_rel_err": k3["loss_rel"],
         "term_rel_err": k3["term_rel"],
         "limit": f"loss and terms rel {LOSS_REL}, grads {K2_REL} of leaf scale",
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "forward_ms": k3["forward_ms"],
         "loss_phase_ms": k3["loss_phase_ms"],
         "ms_hull": k3["ms_hull"], "plain_ms_hull": k3["plain_ms_hull"],
         **bound_keys(bd["k3"]),
         "library_ms": None},
        {"name": "fused_static_field forward (K1 one field, fwd_kernel<2, 32, 1, false>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:803",
         "launches": static["fused_static_field_fwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_static_field_fwd", ("static",)),
         "max_abs_err": se["k1_err"],
         "max_abs_err_trained": sp["trained"]["k1_err"], "limit": f"abs {K1_ATOL}",
         "ms": mean("static_k1"), "plain_ms": mean("static_plain_fwd"),
         **bound_keys(bd["static_k1"]), "library_ms": None},
        {"name": "fused_static_field backward (K2 one field, bwd_kernel<1, false>)",
         "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:803",
         "launches": static["fused_static_field_bwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_static_field_bwd", ("static",)),
         "max_abs_err": se["k2_err"],
         "max_err_of_leaf_scale": se["k2_norm"],
         "max_err_of_leaf_scale_trained": sp["trained"]["k2_norm"],
         "limit": f"{K2_REL} of leaf scale", "ms": mean("static_k2"),
         "plain_ms": mean("static_plain_bwd"), **bound_keys(bd["static_k2"]),
         "library_ms": None},
        {"name": "fused_composite_fields point form (K1 + K2 over one-sample rays)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:741",
         # fused_static_field is the point form without a temporal field:
         # the static path's point-form launches are all one-field
         "launches": static["fused_static_field_fwd"],
         "launches_two_fields": static["fused_field_fwd"], "max_abs_err": se["point_k1_err"],
         "max_err_of_leaf_scale": se["point_k2_norm"], "limit": f"abs {K1_ATOL}; grads "
         f"{K2_REL} of leaf scale", "ms": mean("point_k1"), "bwd_ms": mean("point_k2"),
         "ray_form_ms": mean("composite_k1"), "ray_form_bwd_ms": mean("composite_k2"),
         "plain_ms": mean("point_plain_fwd"), **bound_keys(bd["point_k1"]), "bwd_bound_ms": bd["point_k2"]["bound_ms"],
         "library_ms": None},
        {"name": "fused_field_fwd (K1, fourier encoding, fwd_kernel<2, 32, 2, true>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:527 (fourier rows, :108-131)",
         "launches": fc["launches"]["fused_field_fwd"], "max_abs_err": fk["k1_err"],
         "limit": f"abs {K1_ATOL}", "ms": fk["k1_ms"], "plain_ms": fk["k1_plain_ms"],
         "free_windowed_ms_same_call": kc["k1_ms"], **bound_keys(fbd["k1"]), "library_ms": None},
        {"name": "fused_field_bwd (K2, fourier encoding, bwd_kernel<2, true>)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:604 (fourier rows, :623-627)",
         "launches": fc["launches"]["fused_field_bwd"], "max_abs_err": fk["k2_err"],
         "max_err_of_leaf_scale": fk["k2_norm"], "limit": f"{K2_REL} of leaf scale",
         "ms": fk["k2_ms"], "plain_ms": fk["k2_plain_ms"],
         "free_windowed_ms_same_call": kc["k2_ms"], **bound_keys(fbd["k2"]), "library_ms": None},
        {"name": "K3, fourier encoding (K1, fused_train_loss, K2 on the fourier fields)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_train.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:607 (fourier fields)",
         "launches": fc["launches"]["fused_train_loss"], "max_abs_err": fk3["err"],
         "max_err_of_leaf_scale": fk3["norm"], "loss_rel_err": fk3["loss_rel"],
         "term_rel_err": fk3["term_rel"],
         "limit": f"loss and terms rel {LOSS_REL}, grads {K2_REL} of leaf scale",
         "ms": fk3["ms"], "plain_ms": fk3["plain_ms"], "ms_hull": fk3["ms_hull"],
         "plain_ms_hull": fk3["plain_ms_hull"], **bound_keys(fbd["k3"]), "library_ms": None},
        {"name": "fused_static_field forward, fourier (K1 one field, fwd_kernel<2, 32, 1, true>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:803 (fourier)",
         "launches": fsp["res"]["launches"]["fused_static_field_fwd"],
         "max_abs_err": fse["k1_err"], "max_abs_err_trained": fsp["trained"]["k1_err"],
         "limit": f"abs {K1_ATOL}", "ms": fmean("static_k1"),
         "plain_ms": fmean("static_plain_fwd"), **bound_keys(fbd["static_k1"]),
         "library_ms": None},
        {"name": "fused_static_field backward, fourier (K2 one field, bwd_kernel<1, true>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:803 (fourier)",
         "launches": fsp["res"]["launches"]["fused_static_field_bwd"],
         "max_abs_err": fse["k2_err"], "max_err_of_leaf_scale": fse["k2_norm"],
         "max_err_of_leaf_scale_trained": fsp["trained"]["k2_norm"],
         "limit": f"{K2_REL} of leaf scale", "ms": fmean("static_k2"),
         "plain_ms": fmean("static_plain_bwd"), **bound_keys(fbd["static_k2"]),
         "library_ms": None},
        {"name": f"fused_train_loss_and_grads_sharded (K3 per rank + all-reduce, {DP_WORLD} "
                 f"ranks over gloo on one card)", "route": "cuda",
         "source": "nerfca_tpu_torch/ops/cuda/fused_train.py",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:695",
         "launches": r0["launches"]["fused_train_loss"],
         "launches_all_ranks": sum(r["launches"]["fused_train_loss"] for r in dp["ranks"]),
         "max_abs_err": max(r["err_vs_plain"] for r in dp["ranks"]),
         "max_err_of_leaf_scale": max(r["norm_vs_plain"] for r in dp["ranks"]),
         "loss_rel_err": max(r["loss_rel_vs_plain"] for r in dp["ranks"]),
         "max_abs_err_vs_k3": max(r["err"] for r in dp["ranks"]),
         "max_err_of_leaf_scale_vs_k3": max(r["norm"] for r in dp["ranks"]),
         "loss_rel_err_vs_k3": max(r["loss_rel"] for r in dp["ranks"]),
         "world1_bitwise_equal_to_k3": dp["world1_bitwise"],
         "limit": f"against the plain version and K3 on the whole batch: loss and terms rel "
                  f"{LOSS_REL}, grads {K2_REL} of leaf scale; world 1 bitwise",
         "ms": r0["sharded_ms"], "local_k3_ms": r0["local_k3_ms"],
         "local_k3_ms_alone": r0["local_k3_ms_alone"],
         "allreduce_ms": r0["allreduce_ms"], "plain_ms": r0["plain_sharded_ms"],
         "local_plain_ms": r0["local_plain_ms"], **bound_keys(bd["k3"]),
         "bound_of": f"K3 on the whole batch: the {DP_WORLD} ranks' work shares the card in "
                     f"the timed window",
         "bound_ms_per_rank": rank_bd["bound_ms"], "library_ms": None},
        {"name": "fused_field_fwd, bf16 compute (K1, fwd_kernel<2, 32, NF, FOURIER, true>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:527 (compute_dtype bfloat16, "
                     ":709,730-738)",
         "launches": bp["launches"]["fused_field_fwd_bf16"],
         "launches_training": bp["train_launches"]["fused_field_fwd_bf16"],
         "launches_eval": bp["eval_launches"]["fused_field_fwd_bf16"],
         "launches_clean_protocol": legs["bf16"]["res"]["launches"]["fused_field_fwd_bf16"],
         "max_abs_err": bk["max_abs_err"], "mean_abs_err": bk["fwd_mean_err"],
         "bf16_vs_f32_twin_mean_abs": bk["fwd_mean_gap"], "ratio": bk["fwd_ratio"],
         "limit": f"mean |kernel - bf16 twin| <= {BF16_GATE} x mean |bf16 twin - f32 twin|, "
                  f"per field",
         "ms": bk["k1_ms"], "plain_ms": bk["k1_plain_ms"],
         "one_field": {k: bk["one_field"][k] for k in ("k1_ms", "k1_plain_ms", "fwd_ratio",
                                                      "max_abs_err")},
         "one_field_bound_ms": bbd["static_k1"]["bound_ms"],
         "fourier": {k: bfk[k] for k in ("k1_ms", "k1_plain_ms", "fwd_ratio", "max_abs_err")},
         "fourier_one_field": {k: bfk["one_field"][k] for k in ("k1_ms", "fwd_ratio")},
         **bound_keys(bbd["k1"]), "library_ms": None},
        {"name": "fused_field_bwd, bf16 compute (K2, bwd_kernel<NF, FOURIER, true, false>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:604 (compute_dtype bfloat16, "
                     "_field_bwd :347-407)",
         "launches": bp["launches"]["fused_field_bwd_bf16"],
         "launches_clean_protocol": legs["bf16"]["res"]["launches"]["fused_field_bwd_bf16"],
         "max_abs_err": bk["grad_max_abs_err"], "max_err_of_leaf_scale": bk["grad_err"],
         "bf16_vs_f32_twin_of_leaf_scale": bk["grad_gap"], "ratio": bk["grad_ratio"],
         "limit": f"worst leaf against the bf16 twin <= {BF16_GATE} x the bf16 twin's against "
                  f"the f32 twin (K2's normalization)",
         "ms": bk["k2_ms"], "plain_ms": bk["k2_plain_ms"],
         "one_field": {k: bk["one_field"][k] for k in ("k2_ms", "k2_plain_ms", "grad_ratio")},
         "one_field_bound_ms": bbd["static_k2"]["bound_ms"],
         "fourier": {k: bfk[k] for k in ("k2_ms", "k2_plain_ms", "grad_ratio")},
         "fourier_one_field": {k: bfk["one_field"][k] for k in ("k2_ms", "grad_ratio")},
         **bound_keys(bbd["k2"]), "library_ms": None},
        {"name": "K3, bf16 compute (bf16 K1, fused_train_loss, bf16 K2)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_train.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:607 (compute_dtype bfloat16, :561)",
         "launches": bp["launches"]["fused_train_loss"],
         "launches_clean_protocol": legs["bf16"]["res"]["launches"]["fused_train_loss"],
         "max_abs_err": bk3["max_abs_err"], "max_err_of_leaf_scale": bk3["grad_err"],
         "loss_rel_err": bk3["loss_err"], "term_rel_err": bk3["term_err"],
         "bf16_vs_f32_twin": {k: bk3[k] for k in ("loss_gap", "term_gap", "grad_gap")},
         "ratio": bk3["grad_ratio"],
         "limit": f"worst leaf against the bf16 twin <= {BF16_GATE} x the bf16 twin's against "
                  f"the f32 twin; loss and terms rel {LOSS_REL} (the f32 loss kernel)",
         "ms": bk3["ms"], "plain_ms": bk3["plain_ms"], **bound_keys(bbd["k3"]),
         "library_ms": None},
        {"name": "fused_field_bwd over bf16 residuals (K2, bwd_kernel<2, FOURIER, false, true>)",
         "route": "cuda", "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:607 (pallas_bf16_residuals, :562)",
         "launches": rp["launches"]["fused_field_bwd_res_bf16"],
         "launches_clean_protocol": legs["res"]["res"]["launches"]["fused_field_bwd_res_bf16"],
         "max_abs_err": bk3["res_max_abs_err"],
         "max_err_of_leaf_scale": bk3["res_grad_err_vs_twin"],
         "share_of_twin_change_err": bk3["res_share_err"],
         "change_diff_of_twin_change": bk3["res_change_diff"],
         "share_err_on_k3_cotangents": bk3["res_share_err_k3_cotangents"],
         "limit": f"on unit-normal cotangents, per moving leaf |<dk, dt> / <dt, dt> - 1| <= "
                  f"{BF16_GATE}; other leaves bitwise",
         "ms": bk3["k2_res_ms"], "f32_ms_same_call": bk3["k2_f32_ms"],
         "plain_ms": bk3["k2_res_plain_ms"], **bound_keys(bd["k2"]), "library_ms": None},
        {"name": "K3 over bf16 residuals (K1, fused_train_loss, residual K2)", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_train.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_train.py:607 (pallas_bf16_residuals, :562)",
         "launches": rp["launches"]["fused_train_loss"],
         "launches_clean_protocol": legs["res"]["res"]["launches"]["fused_train_loss"],
         "max_abs_err": bk3["res_max_abs_err"], "loss_bitwise_f32": bk3["res_loss_bitwise"],
         "share_of_twin_change_err": bk3["res_share_err"],
         "max_err_of_leaf_scale": bk3["res_grad_err_vs_twin"],
         "limit": f"loss and terms bitwise the f32 K3's; grads {K2_REL} of leaf scale against "
                  f"the bf16-residual twin (the f32 K3's rule: on K3's cotangents the rounding "
                  f"moves the gradients less than f32 sums do)",
         "ms": bk3["res_ms"], "f32_ms_same_call": bk3["f32_ms"], "plain_ms": bk3["res_plain_ms"],
         **bound_keys(bd["k3"]), "library_ms": None},
        {"name": f"fused_field_fwd (K1), the fine pass's shapes (per-ray depths, 1024 x "
                 f"{fkc['shapes']['n_samples']})", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:527 (fused_composite_fields_rays "
                     "with z [R, S+F], nerfca_tpu/train/step.py:361-373)",
         "launches": fine["res"]["launches"]["fused_field_fwd"],
         "launches_training": fine["res"]["train_launches"]["fused_field_fwd"],
         "launches_eval": fine["res"]["eval_launches"]["fused_field_fwd"],
         "launches_shipped_fine_pair": sfp["launches"]["fused_field_fwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_field_fwd", ("fine",)),
         "max_abs_err": fkc["k1_err"], "limit": f"abs {K1_ATOL}", "ms": fkc["k1_ms"],
         "plain_ms": fkc["k1_plain_ms"], **bound_keys(fbd_fine["k1"]), "library_ms": None},
        {"name": f"fused_field_bwd (K2), the fine pass's shapes (per-ray depths, 1024 x "
                 f"{fkc['shapes']['n_samples']})", "route": "cuda",
         "source": "nerfca_tpu_torch/csrc/fused_field.cu",
         "replaces": "nerfca_tpu/ops/pallas/fused_field.py:604 (fused_composite_fields_rays "
                     "with z [R, S+F] under autograd)",
         "launches": fine["res"]["launches"]["fused_field_bwd"],
         "launches_shipped_fine_pair": sfp["launches"]["fused_field_bwd"],
         "launches_data_parallel_per_rank": dpa_launches("fused_field_bwd", ("fine",)),
         "max_abs_err": fkc["k2_err"], "max_err_of_leaf_scale": fkc["k2_norm"],
         "limit": f"{K2_REL} of leaf scale", "ms": fkc["k2_ms"], "plain_ms": fkc["k2_plain_ms"],
         **bound_keys(fbd_fine["k2"]), "library_ms": None},
    ]
    log(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
