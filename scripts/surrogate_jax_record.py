#!/usr/bin/env python3
"""JAX record of the MAGIX-surrogate recipe, for the port to be held against.

    python3 scripts/surrogate_jax_record.py [--n_iters 10] [--display_every 10] [--seed 0]
        [--out artifacts/port/magix_surrogate_jax-10.json]

Builds JAX's own MAGIX-SURR volumes (``nerfca_tpu.data.ccta_surrogate.
write_surrogate_case``, 10 phases of 256x256x160 HU at (1.0, 1.0, 1.6) mm,
resampled to 256^3 attenuation) and runs JAX's ``run_composite`` on the CPU
with the plain (non-Pallas) fields, under a temporary directory, on
``configs/composite.txt`` with the argv of ``scripts/tpu_ccta_surrogate.py::
build(6000)`` (its ``data_argv()``, ray jitter, ``--selection_view 0,0``,
``--best_metric separated_psnr`` and the 6000-step schedules) but without
the motion hull: a hull voxel on the carve threshold can flip under the two
projectors' rounding. It writes to ``--out``, with the command that made
them: the train loss at every step, and the first test view's
``test_image_psnr`` at step 0 (the initial parameters, scored as the
trainer's eval scores them) and at every ``display_every`` steps.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCHEDULE_STEPS = 6000


def recipe_argv(n: int = SCHEDULE_STEPS) -> list:
    """``scripts/tpu_ccta_surrogate.py::build(n)`` less its data paths, the
    motion hull and the kernels (the record runs JAX's plain fields)."""
    return ["--data_name", "MAGIX-SURR", "--x_ray_type", "rotation", "--data_size", "200",
            "--data_limited_range", "60", "--data_step_size", "120", "--data_numb_angles", "4",
            "--data_time_range_start", "0", "--data_time_range_end", "10",
            "--selection_view", "0,0",
            "--save_every", str(max(500, n // 20)), "--steps_per_chunk", "250",
            "--keep_last_n_checkpoints", "50", "--best_metric", "separated_psnr",
            "--lr_decay_steps", str(int(n * 0.75)),
            "--static_pos_enc_window_decay_steps", str(int(n * 0.75)),
            "--temp_pos_enc_window_decay_steps", str(int(n * 0.75)),
            "--hyperparam_decay_steps", str(int(n * 0.5)),
            "--favor_s_weight_delay_steps", str(int(n * 0.2)),
            "--entro_clip_threshold", "1e-6", "--ray_jitter_perc", "1.0"]


def step0_eval(argv: list) -> dict:
    """The in-loop eval of ``train_composite`` applied to the initial
    params: the first test view (the selection view)."""
    import jax

    from nerfca_tpu.ops.sampling import stratify_depths
    from nerfca_tpu.train import evaluation, trainer
    from nerfca_tpu.train.config import parse_args

    args = parse_args(argv)
    setup = trainer.prepare_composite(args)
    test_depths = stratify_depths(jax.random.PRNGKey(args.seed + 1), setup["depth_values"])
    view = setup["test_view"]
    render = evaluation.render_test_view(
        setup["state"].params, view["origins"], view["directions"], view["phases"],
        test_depths, 0, setup["cfgs"], setup["hp"], setup["max_pixel_value"],
        hull=setup["hull"])
    return evaluation.test_metrics(render, view["image"], 0, setup["hp"],
                                   img_shape=view["shape"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_iters", type=int, default=10)
    ap.add_argument("--display_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "port",
                                                  "magix_surrogate_jax-10.json"))
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory(prefix="magix-") as work:
        record = run(a, work)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


def run(a, work: str) -> dict:
    import jax

    from nerfca_tpu.data.ccta_surrogate import write_surrogate_case
    from nerfca_tpu.train import run_composite

    vols = os.path.join(work, "vols")
    t0 = time.time()
    write_surrogate_case(vols, phases=10)
    volume_s = time.time() - t0
    argv = ["--config", os.path.join(REPO, "configs", "composite.txt"), *recipe_argv(),
            "--volume_root", vols, "--n_iters", str(a.n_iters),
            "--display_every", str(a.display_every), "--seed", str(a.seed),
            "--use_pallas", "false", "--use_fused_loss", "false", "--use_motion_hull", "false",
            "--platform", "cpu", "--log_every", "1", "--use_wandb", "false",
            "--data_root", os.path.join(work, "data"),
            "--log_dir_root", os.path.join(work, "cases")]
    t0 = time.time()
    run_composite.main(argv)
    seconds = time.time() - t0
    runs = os.path.join(work, "cases", "MAGIX-SURR", "runs")
    run_dir = os.path.join(runs, sorted(os.listdir(runs))[-1])
    first = step0_eval(argv)
    train = {}
    evals = {0: {k: first[k] for k in ("test_image_psnr", "test_loss")}}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train_loss" in rec:
                train[rec["step"]] = rec["train_loss"]
            if "test_image_psnr" in rec:
                evals[rec["step"]] = {k: rec[k] for k in ("test_image_psnr", "test_loss")}
    return {
        "command": "python3 scripts/surrogate_jax_record.py " + " ".join(sys.argv[1:]),
        "run_composite_argv": [x.replace(work, "<tmp>").replace(REPO + os.sep, "")
                               for x in argv],
        "jax": jax.__version__, "platform": "cpu", "volume_seconds": volume_s,
        "seconds": seconds,
        "train_loss": {str(s): train[s] for s in sorted(train)},
        "evals": {str(s): evals[s] for s in sorted(evals)},
    }


if __name__ == "__main__":
    sys.exit(main())
