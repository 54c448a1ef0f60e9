"""The benchmark's files hang together (``portbench/``, read by name from
``BENCHMARK.json``): every per-layer metric has a reader, every cell a
configuration file, a traffic file whose kind has a runner, and a limits
file that bounds each number its comparison reads. Reads files only: no
run, no card."""

import importlib.util
import json
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    path = harness.metric_file(metric)
    assert path.is_file(), metric
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(entry.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files_and_limits(cell):
    entry, cfg, traffic, limits = harness.cell_files(BENCH, cell)
    assert cfg["name"] == entry["config"]
    assert (ROOT / "portbench" / "mixes" / f"{traffic['kind']}.py").is_file()
    assert limits and all(isinstance(v, (int, float)) and v > 0 for v in limits.values())
    e2e, layer = harness.cell_metrics(BENCH, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
