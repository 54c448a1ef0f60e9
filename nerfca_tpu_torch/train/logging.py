"""Metrics/observability: local JSONL logger with optional wandb mirror
(port of ``nerfca_tpu/train/logging.py``, unchanged; numpy only).

The reference's only observability system is Weights & Biases
(``run_composite.py:314-344,394-444``). wandb is optional here (the package
may be absent); every metric the reference logs — under the SAME names — is
always appended to ``<log_dir>/metrics.jsonl``, and image panels are saved
as PNGs under ``<log_dir>/panels/``. When wandb IS importable and
``use_wandb`` is set, everything is mirrored to it.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Optional

import numpy as np


def _try_wandb():
    try:
        import wandb  # type: ignore

        return wandb
    except Exception:
        return None


class MetricsLogger:
    """Scalar + image logger. Scalars go to JSONL (and wandb when enabled)."""

    def __init__(self, log_dir: str, use_wandb: bool = False, config: Optional[dict] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        os.makedirs(os.path.join(log_dir, "panels"), exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.wandb = _try_wandb() if use_wandb else None
        if self.wandb is not None:
            try:
                self.wandb.init(
                    notes=datetime.now().strftime("%Y-%m-%d-%H%M"), config=config
                )
            except Exception:
                self.wandb = None
        if config is not None:
            with open(os.path.join(log_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        record = {"_time": time.time()}
        if step is not None:
            record["step"] = int(step)
        for k, v in metrics.items():
            if v is None:
                continue
            record[k] = float(np.asarray(v))
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in record.items() if k != "_time"})

    def log_images(self, images: dict, step: int) -> None:
        """Save the five-panel eval images (``run_composite.py:415-444``)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        for name, img in images.items():
            path = os.path.join(self.log_dir, "panels", f"{name}-{step:06d}.png")
            plt.imsave(path, np.asarray(img), cmap="gray")
        if self.wandb is not None:
            self.wandb.log(
                {k: self.wandb.Image(np.asarray(v)) for k, v in images.items()}
            )

    def close(self) -> None:
        self._fh.close()
        if self.wandb is not None:
            try:
                self.wandb.finish()
            except Exception:
                pass


def make_log_dir(root: str, data_name: str, suffix: str = "") -> str:
    """``cases/<data_name>/runs/<timestamp><suffix>/`` — the reference's
    save-folder layout (``data_helpers.py:173-186``), a new directory for
    every run: a run that starts in the same second as another (a sweep's
    short runs on a card) gets ``-1``, ``-2``, ... appended, where the JAX
    package's would share the other's directory, metrics and checkpoints."""
    exp_name = datetime.now().strftime("%Y-%m-%d-%H%M%S") + suffix
    base = os.path.join(root, str(data_name), "runs", exp_name)
    os.makedirs(os.path.dirname(base), exist_ok=True)
    log_dir, n = base, 0
    while True:
        try:
            os.mkdir(log_dir)
            return log_dir
        except FileExistsError:
            n += 1
            log_dir = f"{base}-{n}"
