"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's runs).

    python3 portbench/control.py --workload <cell> --seeds 1,2,... [--control-seeds 3]

For each seed, at the cell's own sizes, the runner of the cell's traffic
kind (``mixes/<kind>.py``, its ``readings``) gives the program's numbers
against the plain reference (the lower readings) and, for the first
``--control-seeds`` seeds, the control's: the reference computed one
precision below the configuration's (TF32 products), put in the program's
place; the program's own bf16 path; and the faults that its kind reads (a
train cell: half of each batch left out, the mean taken over the rest; a
state left unchanged reads 1 on ``change`` and needs no run). One JSON line
per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench import harness, mixes  # noqa: E402


def main(argv=None, device=None, overrides=None, bench=None) -> list:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    a = p.parse_args(argv)
    bench = bench or harness.load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, a.workload)
    for part, extra in zip((cfg, traffic), overrides or ({}, {})):
        part.update(extra)
    device = torch.device(device or "cuda")
    if device.type == "cuda":
        mixes.build_kernels(device)
    readings = mixes.runner(traffic["kind"]).readings
    rows = []
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t = time.time()
        row = {"workload": a.workload, "seed": seed,
               **readings(cfg, traffic, seed, device, i < a.control_seeds),
               "seconds": time.time() - t}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
