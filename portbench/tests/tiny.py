"""A tiny size of every cell, for runs on the CPU: a 50 x 50 detector, 32 rays
of 48 samples, chunks of 2 steps, 2 views checked.

Besides the cells of ``BENCHMARK.json`` the rehearsals drive the train cells
that it holds back until K2's weight gradients reach the configuration's
precision (``PERF.md``, Open questions): their entries below, and limits for
the CPU alone, where the program's kernels run as their plain twins. They
have no limits on the card."""

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CFG = {"data_size": 50, "img_sample_size": 32, "depth_samples_per_ray_coarse": 48}
TRAFFIC = {"chunk_steps": 2, "warmup_chunks": 1, "check_views": 2, "warmup_views": 1,
           "trace_views": 2}
HELD_CONFIGS = [{"name": "nerfca-static3d", "file": "portbench/configs/nerfca-static3d.json"}]
HELD = [{"name": "composite-k3-train", "config": "nerfca-composite", "traffic": "train-chunks",
         "chips": 1},
        {"name": "static3d-train", "config": "nerfca-static3d", "traffic": "train-chunks",
         "chips": 1},
        {"name": "composite-k3-hull-train", "config": "nerfca-composite",
         "traffic": "train-chunks-hull", "chips": 1}]
HELD_LIMITS = {"loss": 1e-5, "terms": 1e-5, "grad": 1e-5, "change": 1e-5}


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def bench() -> dict:
    """``BENCHMARK.json`` with the held-back cells added."""
    b = benchmark()
    b["configs"] += HELD_CONFIGS
    b["workloads"] += HELD
    return b


def cells() -> list:
    """The cells of ``BENCHMARK.json``."""
    return [w["name"] for w in benchmark()["workloads"]]


def all_cells() -> list:
    return [w["name"] for w in bench()["workloads"]]


def limits(cell: str) -> dict:
    """The cell's limits: its file, or the CPU limits of a held-back cell."""
    from portbench import harness

    return harness.cell_files(bench(), cell)[3] or dict(HELD_LIMITS)


def run(cell: str, seed: int = 4294967301, seconds: float = 0.5) -> dict:
    import time

    from portbench import harness

    return harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", "0"], time.time(), device="cpu",
                       overrides=(dict(CFG), dict(TRAFFIC), limits(cell)), bench=bench())
