"""Hyperparameter sweeps (port of ``nerfca_tpu/train/sweep.py``).

A sweep yaml has the reference's wandb schema:

    method: grid
    metric: {goal: minimize, name: train_loss}
    parameters: {<flag>: {values: [...]}}
    early_terminate: {type: hyperband, max_iter: N}

With ``--use_wandb`` and ``wandb`` importable, ``wandb.sweep``/``wandb.agent``
run it as in the reference. Otherwise the local executor expands the grid
and, with an ``early_terminate`` hyperband block, runs successive halving:
every config trains to the first rung's budget, the best ``ceil(n / eta)``
resume from their checkpoints to the next rung (the schedules continue from
the saved step), and so on up to ``max_iter``. Without that block every
config trains to ``max_iter`` (or ``--n_iters``). The ranking, and the
rungs with their promotions, go to
``<log_dir_root>/<data_name>/sweep_results.json``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Callable

import yaml

from nerfca_tpu_torch.train.config import overwrite_args


def load_sweep_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def expand_grid(sweep_config: dict) -> list[dict]:
    """Every combination of the ``parameters: {k: {values: [...]}}`` grid."""
    params = sweep_config.get("parameters", {})
    keys, value_lists = [], []
    for key, spec in params.items():
        keys.append(key)
        value_lists.append(spec["values"] if isinstance(spec, dict) else [spec])
    return [dict(zip(keys, combo)) for combo in itertools.product(*value_lists)]


def run_sweep(args, train_fn: Callable) -> list[dict]:
    """Run the sweep of ``args.wandb_sweep_yaml`` with ``train_fn(run_args,
    max_steps=...)`` (``train_composite`` or ``train_static``); returns the
    ranked results of the local executor (none through wandb)."""
    sweep_config = load_sweep_config(args.wandb_sweep_yaml)
    if args.use_wandb:
        try:
            import wandb  # type: ignore

            def agent_main():
                train_fn(overwrite_args(args, dict(wandb.config)))

            wandb.agent(wandb.sweep(sweep=sweep_config, project="4D-LIMITED"),
                        function=agent_main)
            return []
        except ImportError:
            print("wandb unavailable; falling back to the local sweep executor")

    grid = expand_grid(sweep_config)
    early = sweep_config.get("early_terminate") or {}
    max_iter = early.get("max_iter")
    metric = (sweep_config.get("metric") or {}).get("name", "train_loss")
    goal = (sweep_config.get("metric") or {}).get("goal", "minimize")
    rungs = None
    if early.get("type") == "hyperband" and max_iter and len(grid) > 1:
        results, rungs = _run_hyperband(args, train_fn, grid, metric, goal,
                                        max_iter=int(max_iter), eta=int(early.get("eta", 3)),
                                        s=int(early.get("s", 2)))
    else:
        results = []
        for i, overrides in enumerate(grid):
            print(f"[sweep {i + 1}/{len(grid)}] {overrides}")
            out = train_fn(_run_args(args, overrides), max_steps=max_iter)
            results.append({"overrides": overrides, "log_dir": out["log_dir"],
                            metric: _final_metric(out["log_dir"], metric)})
    results.sort(key=lambda r: _rank_value(r[metric], goal), reverse=(goal == "maximize"))
    out_path = os.path.join(args.log_dir_root, str(args.data_name), "sweep_results.json")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    payload = {"results": results} if rungs is None else {"results": results, "hyperband": rungs}
    with open(out_path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"sweep results -> {out_path}")
    return results


def _run_args(args, overrides: dict):
    """One run's arguments: the overrides applied, the sweep flag cleared."""
    run_args = overwrite_args(args, overrides)
    run_args.wandb_sweep_yaml = None
    return run_args


def _rank_value(value, goal: str) -> float:
    """Sort key that puts None and non-finite values at the losing end."""
    bad = float("-inf") if goal == "maximize" else float("inf")
    if value is None:
        return bad
    v = float(value)
    return v if math.isfinite(v) else bad


def hyperband_rungs(max_iter: int, eta: int = 3, s: int = 2) -> list[int]:
    """Successive-halving rung budgets ``[max_iter / eta^s, ..., max_iter]``
    (the wandb hyperband schedule for ``early_terminate.max_iter``)."""
    return [max(1, int(max_iter / eta**k)) for k in range(s, -1, -1)]


def _run_hyperband(args, train_fn, grid, metric, goal, *, max_iter, eta, s):
    """Successive halving: every config trains to rung 0, and the best
    ``ceil(n / eta)`` resume from their checkpoints to the next rung."""
    rung_iters = hyperband_rungs(max_iter, eta, s)
    survivors = list(range(len(grid)))
    last = {i: None for i in survivors}  # config index -> its last run's record
    rung_log = []
    for r_idx, budget in enumerate(rung_iters):
        print(f"[hyperband rung {r_idx + 1}/{len(rung_iters)}] budget={budget} "
              f"configs={survivors}")
        for ci in survivors:
            run_args = _run_args(args, grid[ci])
            if last[ci] is not None:
                run_args.resume_from = os.path.join(last[ci]["log_dir"], "checkpoint")
            out = train_fn(run_args, max_steps=budget)
            score = _final_metric(out["log_dir"], metric)
            last[ci] = {"overrides": grid[ci], "log_dir": out["log_dir"], metric: score}
            print(f"  config {ci} {grid[ci]}: {metric}={score}")
        ranked = sorted(survivors, key=lambda ci: _rank_value(last[ci][metric], goal),
                        reverse=(goal == "maximize"))
        rung_log.append({"rung": r_idx, "budget": budget,
                         "scores": {str(ci): last[ci][metric] for ci in survivors}})
        if r_idx < len(rung_iters) - 1:
            survivors = ranked[:max(1, math.ceil(len(survivors) / eta))]
            rung_log[-1]["promoted"] = survivors
    results = [last[ci] for ci in sorted(last) if last[ci] is not None]
    return results, {"eta": eta, "rung_iters": rung_iters, "rungs": rung_log}


def _final_metric(log_dir: str, metric: str):
    """The last logged value of ``metric`` in the run's ``metrics.jsonl``."""
    value = None
    try:
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if metric in rec:
                    value = rec[metric]
    except OSError:
        pass
    return value
