"""Checkpoints: symmetric save/restore of the full train state (port of
``nerfca_tpu/train/checkpoint.py``).

A checkpoint directory holds ``state.pt`` (``torch.save``: params and
Adam's ``mu``/``nu`` keyed by leaf name, ``count``, ``step`` and the
step's random key; plain tensors and ints, so ``torch.load(...,
weights_only=True)`` reads it) and ``metadata.json`` in the JAX package's
schema (``format_version``, ``field_configs``, ``run``), so either package
reads the other's field configs. The annealing state derives from the
step and the key is the JAX trainer's (``ops/prng.py``), drawn on the
host, so a resume is exact and restores on any device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Any, Optional

import numpy as np
import torch

from nerfca_tpu_torch.models.fields import FieldConfig
from nerfca_tpu_torch.train.step import TrainState, param_items, params_from_leaves

STATE_FILE = "state.pt"


def save_checkpoint(
    directory: str,
    state: TrainState,
    cfgs: Optional[dict] = None,
    run_metadata: Optional[dict] = None,
) -> None:
    """Write the train state (and json metadata) to ``directory``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    names = [n for n, _ in param_items(state.params)]

    def by_name(leaves):
        return {n: t.detach() for n, t in zip(names, leaves)}

    torch.save({
        "params": by_name(t for _, t in param_items(state.params)),
        "mu": by_name(state.opt_state["mu"]),
        "nu": by_name(state.opt_state["nu"]),
        "count": int(state.opt_state["count"]),
        "step": int(state.step),
        "rng": torch.from_numpy(state.rng.astype(np.int64)),
    }, os.path.join(directory, STATE_FILE))
    meta: dict[str, Any] = {"format_version": 1}
    if cfgs is not None:
        meta["field_configs"] = {k: dataclasses.asdict(v) for k, v in cfgs.items()}
    if run_metadata is not None:
        meta["run"] = run_metadata
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(
    directory: str, example_state: TrainState, *, params_only: bool = False
) -> TrainState:
    """Restore a state saved by :func:`save_checkpoint` onto the device of
    ``example_state``'s params, which give the tree's leaf names and shapes
    (build it with the same configs, then restore over it).

    ``params_only``: restore the params and the step and keep the
    optimizer state and the key of ``example_state`` (the path of eval and
    render); a full restore is a resume."""
    items = param_items(example_state.params)
    names = [n for n, _ in items]
    saved = torch.load(os.path.join(os.path.abspath(directory), STATE_FILE),
                       map_location=items[0][1].device, weights_only=True)
    if sorted(saved["params"]) != sorted(names):
        raise ValueError(f"checkpoint {directory} holds leaves {sorted(saved['params'])}, "
                         f"the example state {sorted(names)}")
    params = params_from_leaves(example_state.params, [saved["params"][n] for n in names])
    if params_only:
        return TrainState(params=params, opt_state=example_state.opt_state,
                          step=saved["step"], rng=example_state.rng)
    opt_state = {"count": saved["count"], "mu": [saved["mu"][n] for n in names],
                 "nu": [saved["nu"][n] for n in names]}
    return TrainState(params=params, opt_state=opt_state, step=saved["step"],
                      rng=saved["rng"].cpu().numpy().astype(np.uint32))


class CheckpointManager:
    """Retention policy around :func:`save_checkpoint`.

    Layout under ``root``:
      - ``checkpoint-<step>``: rolling history, last ``keep_last_n`` kept
      - ``checkpoint``: symlink to the latest (the stable resume path)
      - ``checkpoint-best``: symlink to the best-by-metric checkpoint
        (metric reported by the caller, e.g. ``test_image_psnr``), with
        its step and metric in ``checkpoint-best.json``
    """

    def __init__(self, root: str, keep_last_n: int = 3, maximize: bool = True) -> None:
        self.root = os.path.abspath(root)
        self.keep_last_n = max(1, keep_last_n)
        self.maximize = maximize
        self.best_metric: Optional[float] = None
        self.best_step: Optional[int] = None
        # Legacy dirs (symlink, no json): the best checkpoint exists but its
        # metric may be unrecoverable. While it is unknown the link is
        # non-replaceable: letting the first post-resume metric win could
        # repoint checkpoint-best to a worse checkpoint and prune the best.
        self._best_locked = False
        # A resumed run reuses the log dir: seed best_step/best_metric from
        # the persisted record so _prune never deletes the directory the
        # existing checkpoint-best symlink points to.
        best_json = os.path.join(self.root, "checkpoint-best.json")
        best_link = os.path.join(self.root, "checkpoint-best")
        if os.path.exists(best_json):
            try:
                with open(best_json) as f:
                    rec = json.load(f)
                self.best_metric = float(rec["metric"])
                self.best_step = int(rec["step"])
            except (ValueError, KeyError, json.JSONDecodeError):
                pass
        elif os.path.islink(best_link):
            target = os.path.basename(os.readlink(best_link))
            if target.startswith("checkpoint-") and target[11:].isdigit():
                self.best_step = int(target[11:])
                # a checkpoint embeds its selection metric in its own
                # metadata: recover it so best tracking resumes exactly
                try:
                    with open(os.path.join(self.root, target, "metadata.json")) as f:
                        m = json.load(f)["run"]["selection_metric"]
                    self.best_metric = float(m)
                except (OSError, KeyError, TypeError, ValueError, json.JSONDecodeError):
                    self._best_locked = True  # metric unknown: pin the link

    def _link(self, name: str, target_dir: str) -> None:
        path = os.path.join(self.root, name)
        if os.path.islink(path):
            os.unlink(path)
        elif os.path.isdir(path):
            shutil.rmtree(path)
        os.symlink(os.path.basename(target_dir), path)

    def save(
        self,
        state: TrainState,
        cfgs: Optional[dict] = None,
        run_metadata: Optional[dict] = None,
        metric: Optional[float] = None,
    ) -> str:
        os.makedirs(self.root, exist_ok=True)
        step = int(state.step)
        directory = os.path.join(self.root, f"checkpoint-{step}")
        if metric is not None:
            # embed the selection metric in the checkpoint's own metadata so
            # a later resume recovers best_metric even if the side-car
            # checkpoint-best.json is lost
            run_metadata = dict(run_metadata or {})
            run_metadata["selection_metric"] = float(metric)
        save_checkpoint(directory, state, cfgs, run_metadata)
        self._link("checkpoint", directory)

        if self._best_locked and metric is not None:
            warnings.warn(
                "checkpoint-best points at a legacy checkpoint with an unknown metric; "
                "keeping it pinned (delete the stale checkpoint-best symlink to re-enable "
                "best tracking)",
                stacklevel=2,
            )  # warnings dedup repeats this once per process
        elif metric is not None and (
            self.best_metric is None or (metric > self.best_metric) == self.maximize
        ):
            self.best_metric, self.best_step = float(metric), step
            self._link("checkpoint-best", directory)
            with open(os.path.join(self.root, "checkpoint-best.json"), "w") as f:
                json.dump({"step": step, "metric": self.best_metric}, f)

        self._prune()
        return directory

    def _steps_on_disk(self) -> list[int]:
        prefix = "checkpoint-"
        return sorted(int(name[len(prefix):]) for name in os.listdir(self.root)
                      if name.startswith(prefix) and name[len(prefix):].isdigit())

    def _prune(self) -> None:
        keep = set(self._steps_on_disk()[-self.keep_last_n:])
        if self.best_step is not None:
            keep.add(self.best_step)
        for step in self._steps_on_disk():
            if step not in keep:
                shutil.rmtree(os.path.join(self.root, f"checkpoint-{step}"),
                              ignore_errors=True)


def load_field_configs(directory: str) -> dict[str, FieldConfig]:
    """Rebuild the FieldConfig dict from checkpoint metadata."""
    with open(os.path.join(directory, "metadata.json")) as f:
        meta = json.load(f)
    return {k: FieldConfig(**v) for k, v in meta.get("field_configs", {}).items()}
