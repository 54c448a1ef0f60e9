#!/usr/bin/env python3
"""JAX record of the composite method with the fine pass, for the port to
be held against.

    python3 scripts/composite_fine_jax_record.py [--n_iters 10] [--display_every 10] [--seed 0]
        [--out artifacts/port/composite_fine_jax-10.json]

Runs JAX's ``run_composite`` on ``configs/composite.txt`` with 128 fine
samples per ray and a 128-wide fine pair (``--depth_samples_per_ray_fine
128 --static_num_filters_fine 128 --temp_num_filters_fine 128``) on the CPU
with the plain (non-Pallas) fields, its dataset and run directory under a
temporary directory, and writes to ``--out``, with the command that made
them: the train loss at every step, and the first test view's
``test_image_psnr`` and ``test_image_psnr_fine`` at step 0 (the initial
parameters, scored as the trainer's eval scores them) and at every
``display_every`` steps.
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

FINE_ARGV = ["--depth_samples_per_ray_fine", "128", "--static_num_filters_fine", "128",
             "--temp_num_filters_fine", "128"]


def step0_eval(argv: list) -> dict:
    """The in-loop eval of ``train_composite`` applied to the initial
    params: the first test view with the coarse and fine eval grids."""
    import jax

    from nerfca_tpu.ops.sampling import linspace_depths, stratify_depths
    from nerfca_tpu.train import evaluation, trainer
    from nerfca_tpu.train.config import parse_args

    args = parse_args(argv)
    setup = trainer.prepare_composite(args)
    info = setup["data"].info
    test_depths = stratify_depths(jax.random.PRNGKey(args.seed + 1), setup["depth_values"])
    test_depths_fine = stratify_depths(
        jax.random.PRNGKey(args.seed + 2),
        linspace_depths(info["near_thresh"], info["far_thresh"],
                        args.depth_samples_per_ray_fine))
    view = setup["test_view"]
    render = evaluation.render_test_view(
        setup["state"].params, view["origins"], view["directions"], view["phases"],
        test_depths, 0, setup["cfgs"], setup["hp"], setup["max_pixel_value"],
        depth_values_fine=test_depths_fine, hull=setup["hull"])
    return evaluation.test_metrics(render, view["image"], 0, setup["hp"],
                                   img_shape=view["shape"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_iters", type=int, default=10)
    ap.add_argument("--display_every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "port",
                                                  "composite_fine_jax-10.json"))
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory(prefix="fine-") as work:
        record = run(a, work)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


def run(a, work: str) -> dict:
    import jax

    from nerfca_tpu.train import run_composite

    argv = ["--config", os.path.join(REPO, "configs", "composite.txt"), *FINE_ARGV,
            "--n_iters", str(a.n_iters), "--display_every", str(a.display_every),
            "--seed", str(a.seed), "--use_pallas", "false", "--use_fused_loss", "false",
            "--platform", "cpu", "--log_every", "1", "--use_wandb", "false",
            "--data_root", os.path.join(work, "data"),
            "--log_dir_root", os.path.join(work, "cases")]
    t0 = time.time()
    run_composite.main(argv)
    seconds = time.time() - t0
    runs = os.path.join(work, "cases", "SYNTH", "runs")
    run_dir = os.path.join(runs, sorted(os.listdir(runs))[-1])
    first = step0_eval(argv)
    train = {}
    evals = {0: {k: first[k] for k in ("test_image_psnr", "test_image_psnr_fine", "test_loss")}}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train_loss" in rec:
                train[rec["step"]] = rec["train_loss"]
            if "test_image_psnr" in rec:
                evals[rec["step"]] = {k: rec[k] for k in
                                      ("test_image_psnr", "test_image_psnr_fine", "test_loss")}
    return {
        "command": "python3 scripts/composite_fine_jax_record.py " + " ".join(sys.argv[1:]),
        "run_composite_argv": [x.replace(work, "<tmp>").replace(REPO + os.sep, "")
                               for x in argv],
        "jax": jax.__version__, "platform": "cpu", "seconds": seconds,
        "train_loss": {str(s): train[s] for s in sorted(train)},
        "evals": {str(s): evals[s] for s in sorted(evals)},
    }


if __name__ == "__main__":
    sys.exit(main())
