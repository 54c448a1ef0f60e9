"""The torch port's sweeps (``train/sweep.py``, ``config.overwrite_args``)
against the JAX package's on the CPU: the grids of every shipped sweep
yaml, the hyperband rungs, the overrides, the local executor's
``sweep_results.json`` with a stub trainer, and a sweep through
``run_composite`` whose promoted configs resume from their checkpoints."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import glob
import json
import math
import os

import pytest

from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import sweep as jsw
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import run_composite
from nerfca_tpu_torch.train.logging import make_log_dir
from nerfca_tpu_torch.train import sweep as tsw
from tests.test_torch_trainer import FAST_DATA, REPO, SMALL

SWEEPS = sorted(glob.glob(os.path.join(REPO, "configs", "sweep-*.yaml")))


def test_there_are_five_shipped_sweeps():
    assert len(SWEEPS) == 5


@pytest.mark.parametrize("path", SWEEPS, ids=os.path.basename)
def test_expand_grid_matches_jax(path):
    cfg = tsw.load_sweep_config(path)
    assert cfg == jsw.load_sweep_config(path)
    grid = tsw.expand_grid(cfg)
    assert grid == jsw.expand_grid(cfg)


@pytest.mark.parametrize("max_iter,eta,s", [(9, 3, 2), (50000, 3, 2), (3, 3, 2), (100, 2, 3),
                                            (10, 3, 0)])
def test_hyperband_rungs_match_jax(max_iter, eta, s):
    assert tsw.hyperband_rungs(max_iter, eta, s) == jsw.hyperband_rungs(max_iter, eta, s)


@pytest.mark.parametrize("overrides", [
    {"occl_weight_start": "1e-10", "lr": 0.01},  # YAML's string float into a float flag
    {"n_iters": "200", "img_sample_size": 512.0},  # an integral string into an int flag
    {"data_name": "SYNTH-HC", "use_pallas": "true"},  # strings and a bool pass through
    {"weighted_loss_max": 4.0, "var_sample_thre": 20.0, "unknown_flag": 3},
])
def test_overwrite_args_matches_jax(overrides):
    argv = ["--config", SMALL]
    a = vars(tcfg.overwrite_args(tcfg.parse_args(argv), overrides))
    b = vars(jcfg.overwrite_args(jcfg.parse_args(argv), overrides))
    a.pop("platform"), b.pop("platform")
    assert a == b
    for k, v in a.items():
        assert type(v) is type(b[k]), k


def test_overwrite_args_refuses_a_fractional_int():
    for mod in (tcfg, jcfg):
        args = mod.parse_args(["--config", SMALL])
        with pytest.raises(ValueError, match="fractional"):
            mod.overwrite_args(args, {"n_iters": "1e2", "img_sample_size": "64.5"})
        assert args.img_sample_size == 256  # the original is untouched


@pytest.mark.parametrize("value,goal,want", [
    (None, "maximize", -math.inf), (None, "minimize", math.inf),
    (float("nan"), "maximize", -math.inf), (float("inf"), "minimize", math.inf),
    (2.5, "maximize", 2.5), (-1, "minimize", -1.0)])
def test_rank_value_matches_jax(value, goal, want):
    assert tsw._rank_value(value, goal) == jsw._rank_value(value, goal) == want


def stub_trainer(root):
    """A train_fn that logs a metric from its overrides and its step count,
    resuming a run's step count from ``resume_from``, as the trainers do."""
    calls = []

    def train_fn(args, max_steps=None):
        start = 0
        if args.resume_from:
            with open(os.path.join(args.resume_from, "state.json")) as f:
                start = json.load(f)["step"]
        end = (max_steps if max_steps is not None else args.n_iters) + 1
        log_dir = os.path.join(root, f"run-{len(calls)}")
        os.makedirs(os.path.join(log_dir, "checkpoint"))
        # a config's score: better with a larger weighted_loss_max, and
        # with more steps; var_sample_thre 20 never logs a value
        score = args.weighted_loss_max + 0.01 * end
        with open(os.path.join(log_dir, "metrics.jsonl"), "w") as f:
            for step in range(start, end):
                rec = {"step": step, "train_loss": 1.0 / (1 + step)}
                if args.var_sample_thre != 20.0:
                    rec["test_image_psnr"] = score
                f.write(json.dumps(rec) + "\n")
        with open(os.path.join(log_dir, "checkpoint", "state.json"), "w") as f:
            json.dump({"step": end}, f)
        calls.append((dict(weighted_loss_max=args.weighted_loss_max,
                           var_sample_thre=args.var_sample_thre), start, end))
        return {"log_dir": log_dir}

    return train_fn, calls


@pytest.mark.parametrize("early", [None, {"type": "hyperband", "max_iter": 9}])
def test_run_sweep_writes_the_jax_results(tmp_path, early):
    # configs/sweep-4view-data.yaml's 4-config grid with a stub trainer:
    # the same runs (overrides, resumed step ranges) and the same
    # sweep_results.json, log dirs aside
    cfg = tsw.load_sweep_config(os.path.join(REPO, "configs", "sweep-4view-data.yaml"))
    if early:
        cfg["early_terminate"] = early
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(json.dumps(cfg))
    out = {}
    for name, mod, sw in (("jax", jcfg, jsw), ("torch", tcfg, tsw)):
        root = tmp_path / name
        args = mod.parse_args(["--config", SMALL, "--wandb_sweep_yaml", str(sweep),
                               "--log_dir_root", str(root), "--n_iters", "4"])
        train_fn, calls = stub_trainer(str(root / "runs"))
        ranked = sw.run_sweep(args, train_fn)
        with open(root / "SYNTH" / "sweep_results.json") as f:
            results = json.load(f)
        for r in results["results"]:
            r["log_dir"] = os.path.basename(r["log_dir"])
        out[name] = (calls, results, [os.path.basename(r["log_dir"]) for r in ranked])
    assert out["torch"] == out["jax"]
    calls, results, _ = out["torch"]
    if early:
        assert results["hyperband"]["rung_iters"] == tsw.hyperband_rungs(9) == [1, 3, 9]
        # promoted configs continue from their checkpoint's step
        resumed = [c for c in calls if c[1] > 0]
        assert resumed and all(c[1] in (2, 4) for c in resumed)
    else:
        assert "hyperband" not in results and len(calls) == 4


def test_sweep_through_run_composite_resumes_across_rungs(tmp_path):
    # a 2-config hyperband sweep (max_iter 9: rungs 1, 3, 9) through the
    # CLI on the CPU: the promoted config resumes from its checkpoint at
    # each rung, so each of its runs continues from the step it stopped at
    cfg = {"method": "grid", "metric": {"goal": "minimize", "name": "train_loss"},
           "parameters": {"weighted_loss_max": {"values": [1.0, 4.0]}},
           "early_terminate": {"type": "hyperband", "max_iter": 9}}
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text(json.dumps(cfg))
    ranked = run_composite.main([
        "--config", SMALL, "--platform", "cpu", "--wandb_sweep_yaml", str(sweep),
        "--data_root", str(tmp_path / "data"), "--log_dir_root", str(tmp_path / "cases"),
        "--log_every", "1", "--display_every", "100", "--steps_per_chunk", "1", *FAST_DATA])
    with open(tmp_path / "cases" / "SYNTH" / "sweep_results.json") as f:
        results = json.load(f)
    hb = results["hyperband"]
    assert hb["rung_iters"] == [1, 3, 9]
    assert [len(r["scores"]) for r in hb["rungs"]] == [2, 1, 1]
    winner = hb["rungs"][0]["promoted"][0]
    assert hb["rungs"][1]["promoted"] == [winner]
    assert len(ranked) == 2 and all(r["train_loss"] is not None for r in ranked)
    final = next(r for r in results["results"]
                 if r["overrides"]["weighted_loss_max"] == [1.0, 4.0][winner])
    # rung 0 trained steps 0-1, rung 1 resumed at 2 and trained 2-3, rung 2
    # resumed at 4 and trained 4-9
    with open(os.path.join(final["log_dir"], "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f if "train_loss" in line]
    assert steps == list(range(4, 10))
    with open(os.path.join(final["log_dir"], "checkpoint", "metadata.json")) as f:
        assert json.load(f)["run"]["step"] == 10


def test_runs_in_one_second_get_their_own_log_dirs(tmp_path):
    # a sweep's short runs start within one second of each other on a card:
    # each gets its own directory, so no run reads another's checkpoints
    dirs = [make_log_dir(str(tmp_path), "SYNTH", "-composite") for _ in range(3)]
    assert len(set(dirs)) == 3 and all(os.path.isdir(d) for d in dirs)
    assert all(os.path.basename(d).startswith(os.path.basename(dirs[0])) for d in dirs)
