#!/usr/bin/env python3
"""Seed spread of the clean-protocol reconstruction on one CUDA card.

    python3 scripts/clean_protocol_seeds.py [--runs k3,0,jax k3,0,torch plain,0,torch ...]
        [--steps 1000] [--out runs.jsonl]

Trains ``configs/synth-4view-best.txt`` for ``--steps`` steps for each run
``path,seed,stream`` (default: k3 with seeds 0-4 on the JAX stream) on one
dataset (built once under a temporary directory),
scores checkpoint-500 and the last checkpoint over the 40 views of
evaluate.json with ``run_eval``, and prints one JSON line per run (also
appended to ``--out`` when given). Paths: ``k3`` (the config: K3 + hull), ``k1k2``
(``--use_fused_loss false``), ``plain`` (no CUDA kernels).

The stream ``torch`` draws the initial params, ray batches, jitter and depths
from torch generators seeded with the seed, in the order the trainer drew
them before it drew the JAX trainer's stream (``ops/prng.py``): the
params from a CPU generator (each layer's weight ``[out, in]`` then bias,
static field then temporal field, then the latents), and per step from a
device generator: the high-variance ids, the other ids, the jitter
uniforms, the depth uniforms. The in-loop eval depths keep the JAX
stream's (they do not enter the 40-view scores).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = {"k3": [], "k1k2": ["--use_fused_loss", "false"],
         "plain": ["--use_pallas", "false", "--use_fused_loss", "false"]}


def torch_stream():
    """Patch the trainer's initial state and the step's draws with torch
    generators; returns a function that undoes the patch."""
    import numpy as np
    import torch

    from nerfca_tpu_torch.train import step, trainer

    init_state, step_draws = trainer._init_composite_state, step.step_draws
    gens = {}

    def uniform_layer(gen, fan_in, fan_out, device):
        bound = 1.0 / math.sqrt(fan_in)
        layer = {}
        for name, shape in (("w", (fan_out, fan_in)), ("b", (fan_out,))):
            u = torch.rand(shape, generator=gen, dtype=torch.float32)
            layer[name] = (u * (2 * bound) - bound).to(device)
        return layer

    def mlp(gen, cfg, device):
        f_in, width = cfg.input_features, cfg.num_filters
        early = [uniform_layer(gen, f_in, width, device)]
        early += [uniform_layer(gen, width, width, device) for _ in range(cfg.num_early_layers)]
        return {"early": early, "out": uniform_layer(gen, width, cfg.num_output_channels, device)}

    def patched_init(args, cfgs, tx, device):
        gen = torch.Generator().manual_seed(args.seed)
        params = {"static": mlp(gen, cfgs["static"], device), "temp": mlp(gen, cfgs["temp"], device)}
        params["temp"]["latents"] = torch.rand((10, cfgs["temp"].num_time_dim), generator=gen,
                                               dtype=torch.float32).to(device)
        gens["step"] = torch.Generator(device=device).manual_seed(args.seed)
        return step.TrainState(params, step.init_opt_state(params), 0, np.zeros(2, np.uint32))

    def patched_draws(rng, hp, n_var_ids, n_non_var_ids, n_rays, n_samples):
        gen = gens["step"]
        dev, n, nv = gen.device, hp.img_sample_size, hp.nb_var_rays
        if nv > 0:
            pos = torch.cat([torch.randint(0, n_var_ids, (nv,), generator=gen, device=dev),
                             torch.randint(0, n_non_var_ids, (n - nv,), generator=gen, device=dev)])
        else:
            pos = torch.randint(0, n_rays, (n,), generator=gen, device=dev)
        u = None
        if hp.ray_jitter > 0:
            u = torch.rand((n, 2), generator=gen, device=dev).cpu().numpy()
        t = torch.rand((n_samples,), generator=gen, device=dev).cpu().numpy()
        return rng, pos.cpu().numpy(), u, t

    trainer._init_composite_state, step.step_draws = patched_init, patched_draws

    def undo():
        trainer._init_composite_state, step.step_draws = init_state, step_draws
    return undo


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", default=[f"k3,{s},jax" for s in range(5)],
                   help="path,seed,stream triplets (paths k3, k1k2, plain; streams jax, torch)")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--out", default=None, help="JSON-lines file to append the runs to")
    a = p.parse_args()
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("clean_protocol_seeds: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from nerfca_tpu_torch.ops.cuda import build
    from nerfca_tpu_torch.train import run_composite, run_eval
    from nerfca_tpu_torch.train.config import parse_args

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    build.build()
    keys = ("mean_psnr", "mean_ssim", "mean_dyn_psnr_masked", "mean_dyn_corr")
    with tempfile.TemporaryDirectory() as work:
        base = ["--config", os.path.join(REPO, "configs", "synth-4view-best.txt"),
                "--n_iters", str(a.steps), "--platform", "cuda",
                "--data_root", os.path.join(work, "data")]
        for run in a.runs:
            path, seed, stream = run.split(",")
            argv = base + PATHS[path] + ["--seed", seed, "--log_dir_root",
                                         os.path.join(work, run.replace(",", "-"))]
            undo = torch_stream() if stream == "torch" else (lambda: None)
            try:
                t0 = time.perf_counter()
                out = run_composite.main(argv)
                wall = time.perf_counter() - t0
            finally:
                undo()
            row = {"path": path, "seed": int(seed), "stream": stream, "wall_s": wall,
                   "final_step": out["final_step"], "card": card}
            for step in (500, a.steps):
                ckpt = os.path.join(out["log_dir"], f"checkpoint-{step}")
                res = run_eval.evaluate_checkpoint(parse_args(argv + ["--resume_from", ckpt]),
                                                   write_images=False)
                row[str(step)] = {k: res[k] for k in keys}
            line = json.dumps(row)
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
