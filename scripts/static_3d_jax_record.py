#!/usr/bin/env python3
"""JAX record of the static 3-D method, for the port to be held against.

    python3 scripts/static_3d_jax_record.py [--config configs/3d.txt] [--n_iters 200] [--display_every 100]
        [--seed 0] [--static_pos_enc fourier] [--out artifacts/port/static_3d_jax-200.json]

Runs JAX's ``run_nerf`` on ``--config`` on the CPU with the plain
(non-Pallas) field, its dataset and run directory under a temporary
directory, and writes the train loss at steps 0, display_every, ... and the
``test_image_psnr`` of the first test view at the same steps (step 0: the
initial parameters, scored as the trainer's ``eval_fn`` scores them) to
``--out`` with the command that made them. ``--static_pos_enc`` overrides the
config's encoding (``fourier`` takes the config's ``static_pos_enc_fourier_sigma``
and basis: ``configs/3d.txt --static_pos_enc fourier`` is sigma 2, basis 12).

JAX's static eval renders through the composite tile renderer beside a
zero dummy temporal field that it builds without the ``fourier`` leaf its
config then asks for (``nerfca_tpu/train/evaluation.py:246-255``), so a
fourier run of ``run_nerf`` raises at its first eval. This script, in its
own process, hands the dummy a zero projection (its weights are zero, so
the render is the same) and leaves the JAX package as it is.
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


def give_dummy_fourier() -> None:
    """Wrap ``evaluation.render_test_view`` so that a temporal field whose
    config is 'fourier' and which has no projection gets a zero one (only
    JAX's static eval passes such a field: its all-zero dummy)."""
    import inspect

    import jax.numpy as jnp

    from nerfca_tpu.train import evaluation

    inner = evaluation.render_test_view
    sig = inspect.signature(inner)

    def render_test_view(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        params, cfg = bound.arguments["params"], bound.arguments["cfgs"]["temp"]
        if cfg.pos_enc == "fourier" and "fourier" not in params["temp"]:
            temp = dict(params["temp"], fourier=jnp.zeros(3 * cfg.pos_enc_basis, jnp.float32))
            bound.arguments["params"] = dict(params, temp=temp)
        return inner(*bound.args, **bound.kwargs)

    evaluation.render_test_view = render_test_view


def step0_image_psnr(argv: list) -> float:
    """The in-loop eval of ``train_static`` applied to the initial params."""
    import jax
    import numpy as np

    from nerfca_tpu.data.dataset import dataset_paths
    from nerfca_tpu.data.loader import load_dataset
    from nerfca_tpu.models.fields import init_static_field
    from nerfca_tpu.ops.sampling import linspace_depths, stratify_depths
    from nerfca_tpu.train import evaluation, trainer
    from nerfca_tpu.train.config import parse_args

    args = parse_args(argv)
    args.data_time_range_end = args.data_time_range_start + 1
    data = load_dataset(dataset_paths(args, args.data_root), args.weighted_loss_max,
                        use_weighting=(args.var_sample_perc > 0))
    info = data.info
    cfg = trainer.field_configs_from_args(args)["static"]
    hp = trainer.resolve_pallas_support(trainer.static_hparams_from_args(args), cfg)
    params = {"static": init_static_field(jax.random.PRNGKey(args.seed), cfg)}
    depth_values = linspace_depths(info["near_thresh"], info["far_thresh"],
                                   args.depth_samples_per_ray_coarse)
    test_depths = stratify_depths(jax.random.PRNGKey(args.seed + 1), depth_values)
    view = trainer._setup_test_views(data, args)[0]
    render = evaluation.render_static_test_view(
        params, view["origins"], view["directions"], test_depths, 0, cfg, hp,
        info["max_pixel_value"])
    w, h = view["shape"]
    pred = np.asarray(render["pix_static"]).reshape(w, h)
    return evaluation.image_psnr(pred, np.asarray(view["image"]).reshape(w, h))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(REPO, "configs", "3d.txt"))
    ap.add_argument("--n_iters", type=int, default=200)
    ap.add_argument("--display_every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--static_pos_enc", default=None, help="override the config's encoding")
    ap.add_argument("--out", default=os.path.join(REPO, "artifacts", "port",
                                                  "static_3d_jax-200.json"))
    a = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    give_dummy_fourier()
    with tempfile.TemporaryDirectory(prefix="static3d-") as work:
        record = run(a, work)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


def run(a, work: str) -> dict:
    import jax

    from nerfca_tpu.train import run_nerf

    argv = ["--config", a.config,
            "--n_iters", str(a.n_iters), "--display_every", str(a.display_every),
            "--seed", str(a.seed), "--use_pallas", "false", "--platform", "cpu",
            "--log_every", "1", "--use_wandb", "false", "--data_root", os.path.join(work, "data"),
            "--log_dir_root", os.path.join(work, "cases")]
    if a.static_pos_enc:
        argv += ["--static_pos_enc", a.static_pos_enc]
    t0 = time.time()
    run_nerf.main(argv)
    seconds = time.time() - t0
    runs = os.path.join(work, "cases", "SYNTH", "runs")
    run_dir = os.path.join(runs, sorted(os.listdir(runs))[-1])
    train, test = {}, {0: step0_image_psnr(argv)}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train_loss" in rec:
                train[rec["step"]] = rec["train_loss"]
            if "test_image_psnr" in rec:
                test[rec["step"]] = rec["test_image_psnr"]
    steps = list(range(0, a.n_iters + 1, a.display_every))
    return {
        "command": "python3 scripts/static_3d_jax_record.py " + " ".join(sys.argv[1:]),
        "run_nerf_argv": [x.replace(work, "<tmp>").replace(REPO + os.sep, "")
                          for x in argv],
        "jax": jax.__version__, "platform": "cpu", "seconds": seconds,
        "train_loss": {str(s): train[s] for s in steps},
        "test_image_psnr": {str(s): test[s] for s in steps},
    }


if __name__ == "__main__":
    sys.exit(main())
