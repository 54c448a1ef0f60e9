"""The harness end to end at a tiny size on the CPU, the benchmark's file
against the contract's character rules, and what a run loads."""

import ast
import json
import re
import subprocess
import sys

import pytest

from portbench import harness, tracing
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench() -> dict:
    return harness.load_json(tiny.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("cell", tiny.all_cells())
def test_cell_runs_end_to_end(cell):
    out = tiny.run(cell)
    b = tiny.bench()
    e2e, _ = harness.cell_metrics(b, cell)
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "compared"
    assert out["attempted"] > 0 and out["failed"] == 0
    json.dumps(out)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        assert harness.metric_file(m["name"]).is_file()
    for w in b["workloads"]:
        assert (tiny.ROOT / "portbench" / "workloads" / f"{w['traffic']}.json").is_file()
        assert (tiny.ROOT / "portbench" / "limits" / f"{w['name']}.json").is_file()


def test_every_cell_reports_setup_and_a_layer_metric():
    b = bench()
    for w in b["workloads"]:
        e2e, layer = harness.cell_metrics(b, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


@pytest.mark.parametrize("cell", ["composite-k1-render", "composite-k3-train"])
def test_a_dry_run_loads_neither_jax_nor_the_jax_package(cell):
    code = ("import sys; sys.path.insert(0, '.'); from portbench.tests import tiny; "
            f"tiny.run({cell!r}); from portbench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


REFERENCE = ["reference/__init__.py", "reference/train.py", "reference/render.py",
             "threefry.py", "inputs.py", "geometry.py"]


@pytest.mark.parametrize("module", REFERENCE)
def test_the_reference_imports_nothing_of_jax_or_either_package(module):
    tree = ast.parse((tiny.ROOT / "portbench" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "nerfca_tpu", "nerfca_tpu_torch"}


def test_trace_reduction():
    device = [(0.0, 10.0, "fwd_kernel<2>"), (5.0, 20.0, "bwd_kernel<2>"),
              (30.0, 40.0, "Memcpy HtoD"), (50.0, 60.0, "bwd_kernel<2>")]
    host = [(0.0, 100.0, "portbench.chunk"), (20.0, 30.0, "host_a"), (40.0, 50.0, "host_b")]
    tr = tracing.reduce_trace(device, host, (0.0, 100.0), 1e-4)
    assert tr["busy_s"] == pytest.approx(40e-6)
    assert tr["n_kernels"] == 3
    assert tracing.kernel_seconds(tr, "bwd_kernel") == pytest.approx(25e-6)
    idle = dict(tr["idle_gaps"])
    assert idle["host_a"] == pytest.approx(10e-6) and idle["portbench.chunk"] == pytest.approx(40e-6)


def test_metric_readers_read_nothing_from_an_empty_trace():
    tr = {"busy_s": 0.0, "window_s": 1.0, "n_kernels": 0, "kernels": {}}
    ctx = {"trace": tr, "steps": 10, "views": 2, "k1_bound_s": 1.0, "k2_bound_s": 1.0,
           "flops": 1.0, "peak_flops": 1.0}
    for path in sorted((tiny.ROOT / "portbench" / "metrics").glob("*.py")):
        if "roofline" in path.stem or "idle" in path.stem:
            assert harness.read_metric(path.stem, ctx) is None


def test_a_metric_is_read_by_its_quantity_and_a_render_gives_no_train_metric():
    assert harness.metric_file("k1_roofline.render").name == "k1_roofline.py"
    tr = {"busy_s": 0.5, "window_s": 1.0, "n_kernels": 4,
          "kernels": {"fwd_kernel<2, 32, 2>": (0.4, 4)}}
    ctx = {"trace": tr, "views": 2, "k1_bound_s": 0.1, "flops": 1.0, "peak_flops": 4.0}
    assert harness.read_metric("k1_roofline.render", ctx) == pytest.approx(25.0)
    assert harness.read_metric("mfu.render", ctx) == pytest.approx(25.0)
    assert harness.read_metric("device_idle.render", ctx) == pytest.approx(50.0)
    assert harness.read_metric("k2_roofline.render", ctx) is None
    assert harness.read_metric("launches_per_step.render", ctx) is None


@pytest.mark.gpu
@pytest.mark.parametrize("cell", tiny.cells())
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "4294967311", "--seconds", "2", "--trace", "1"], cwd=tiny.ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["busy_s"] > 0
