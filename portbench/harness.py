"""The benchmark's harness: one run of one cell.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

The cell names a configuration (``configs/<name>.json``: the sizes as run,
their source, what was assumed) and a traffic mix (``workloads/<traffic>.json``:
parameters for the runner of its ``kind``, ``mixes/<kind>.py``); its limits
for ``correct`` are ``limits/<cell>.json``; a per-layer metric
``<quantity>.<suffix>`` is read by ``metrics/<quantity>.<suffix>.py`` where
that file exists, else by ``metrics/<quantity>.py``. All are found by the
names in ``BENCHMARK.json``, so a cell, a traffic kind or a metric is added
as files.

A run makes its inputs and weights from the seed on the card, warms up the
cell's shapes, measures for ``--seconds`` (with ``--trace 1`` it traces a
short window instead and reports the per-layer metrics), checks what the
timed path produced against the plain reference (``reference.py``) and
prints the numbers compared beside their limits on standard error and one
JSON line on standard output.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nerfca_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, cell: str) -> tuple:
    """The cell's entry, its configuration file and traffic file, its limits
    (empty where the cell has no limits file)."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    path = HERE / "limits" / f"{cell}.json"
    limits = load_json(path) if path.is_file() else {}
    return entry, cfg, traffic, limits


def cell_metrics(bench: dict, cell: str) -> tuple:
    """The end-to-end and per-layer metric entries this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def metric_file(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the
    reader of its quantity, ``metrics/<quantity>.py``."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, ctx: dict):
    """The metric's reader's ``read(ctx)``: a number, or None where the run
    has nothing for it to read."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", metric_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None, t_start: float = 0.0, device=None, overrides=None, bench=None) -> dict:
    """One run; returns the result line's object. ``device``: None for the
    card (which must be there); the CPU tests pass ``"cpu"``, ``overrides``
    (keys merged into the configuration, the traffic and the limits) to
    rehearse at a tiny size, and ``bench`` (``BENCHMARK.json`` unless
    given) to rehearse cells it does not hold."""
    import torch

    from portbench import mixes

    args = parse(argv)
    torch.set_num_threads(1)
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry, cfg, traffic, limits = cell_files(bench, args.workload)
    for part, extra in zip((cfg, traffic, limits), overrides or ({}, {}, {})):
        part.update(extra)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise SystemExit(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                             f" available")
        device = torch.device("cuda")
    else:
        device = torch.device(device)
    if not limits:
        raise SystemExit(f"{args.workload} has no limits file, limits/{args.workload}.json")
    e2e, layer = cell_metrics(bench, args.workload)
    res = mixes.runner(traffic["kind"]).drive(cfg, traffic, args.seed, args.seconds,
                                              bool(args.trace), device, t_start)

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {found}")
    checks = res["checks"]
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise SystemExit(f"{args.workload} has no limit for {missing}")
    correct = all(v <= limits[k] for k, v in checks.items())
    if args.trace:
        ctx = dict(res["ctx"], cell=args.workload, config=cfg, traffic=traffic)
        metrics = {}
        for m in layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # a metric named ``<quantity>.<cell kind>`` reports the runner's
        # ``<quantity>``: one quantity, a bound for each kind of cell
        metrics = {m["name"]: {"value": res["e2e"][m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": entry["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = res["ctx"]["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    out["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return out


def main(argv=None, t_start: float = 0.0) -> int:
    out = run(argv, t_start)
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']:.6e} limit {v['limit']:.6e} "
              f"{'ok' if v['value'] <= v['limit'] else 'OVER'}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
