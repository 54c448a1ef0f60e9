"""The hash-grid field's render cell, ``naf-hash-render``, rehearsed at a
tiny size on the CPU: it runs end to end and is ``correct``; a fault in the
field (a wrong hash prime, the skip's encoding dropped, ReLU for LeakyReLU,
the MLP's products in TF32) reads over its limits; its reference imports
nothing of JAX or either package, and a run loads none of them; its
readers read the hash-field kernel's share, the lead to its first launch
and the view's launches, and nothing from an empty trace."""

import ast
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

CELL = "naf-hash-render"


def test_the_cell_runs_end_to_end_and_is_correct():
    out = tiny.run(CELL)
    e2e, layer = harness.cell_metrics(tiny.bench(), CELL)
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in e2e} == {
        "render_views_per_s", "render_view_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {q + ".hash_render" for q in (
        "hash_roofline", "bl_roofline", "device_idle", "mfu", "view_lead_ms", "view_tail_ms",
        "view_launches")}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["compared"]) == {"view", "image"}


def tf32(x):
    r = x.contiguous().view(__import__("torch").int32)
    return ((r + 0x0FFF + ((r >> 13) & 1)) & ~0x1FFF).view(x.dtype)


@pytest.mark.parametrize("fault", ["wrong_prime", "skip_dropped", "relu", "tf32_mlp"])
def test_a_fault_in_the_field_is_not_correct(fault, monkeypatch):
    import torch.nn.functional as F

    from nerfca_tpu_torch.models import fields
    from nerfca_tpu_torch.ops import encoding

    if fault == "wrong_prime":
        monkeypatch.setattr(encoding, "HASH_PRIMES", (1, 2654435761, 805459867))
    elif fault == "relu":
        monkeypatch.setattr(fields, "LEAKY_SLOPE", 0.0)
    elif fault == "tf32_mlp":
        monkeypatch.setattr(fields, "_linear",
                            lambda layer, x, cd: F.linear(tf32(x), tf32(layer["w"]), layer["b"]))
    else:
        real = fields.apply_mlp

        def no_skip(params, features, cfg, *a, **k):
            w = params["skip"]["w"].clone()
            w[:, :features.shape[-1]] = 0.0
            return real(dict(params, skip=dict(params["skip"], w=w)), features, cfg, *a, **k)

        monkeypatch.setattr(fields, "apply_mlp", no_skip)
    out = tiny.run(CELL)
    assert out["correct"] is False
    assert out["compared"]["view"]["value"] > out["compared"]["view"]["limit"]


def test_the_reference_imports_nothing_of_jax_or_either_package():
    for module in ("reference/hash_render.py", "mixes/hash_render.py",
                   "metrics/hash_roofline.py", "metrics/view_lead_ms.hash_render.py",
                   "metrics/view_tail_ms.hash_render.py"):
        tree = ast.parse((tiny.ROOT / "portbench" / module).read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.col_offset == 0:
                names.add((node.module or "").split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "nerfca_tpu", "nerfca_tpu_torch"}, module


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.'); from portbench.tests import tiny; "
            f"tiny.run({CELL!r}); from portbench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_readers_of_the_hash_render_cell():
    from portbench.metrics import hash_roofline

    cfg = harness.cell_files(tiny.bench(), CELL)[1]
    assert hash_roofline.mlp_macs(cfg) == 4128
    rays, samples = 40000, 192
    points = rays * samples
    # the MLP's 8,256 operations a point at the f32 peak bound a view: over
    # the corner reads, 1 KB a point from L2, and over the HBM bytes (the
    # 48.8 MB table once, 4 B a point written, the rays and depths)
    assert hash_roofline.corner_bytes(cfg, points) == points * 1024
    assert hash_roofline.hbm_bytes(cfg, rays, samples) == pytest.approx(
        6_098_944 * 8 + 4 * points + 24 * rays + 4 * samples)
    assert hash_roofline.view_bound_s(cfg, rays, samples) == pytest.approx(
        points * 8256 / 66.9e12)
    assert (hash_roofline.mlp_flops(cfg, points) / hash_roofline.PEAK_F32_FMA
            > hash_roofline.corner_bytes(cfg, points) / hash_roofline.PEAK_L2_BYTES
            > hash_roofline.hbm_bytes(cfg, rays, samples) / 3.35e12)
    bound = 2 * hash_roofline.view_bound_s(cfg, rays, samples)
    tr = {"busy_s": 0.5, "window_s": 1.0, "n_kernels": 4,
          "kernels": {"hash_field_kernel(HashFieldArgs)": (4 * bound, 20),
                      "static_composite_kernel(StaticCompositeArgs)": (0.001, 20)}}
    rec = {"launches": 21, "k1": 0, "lead_ms": None, "tail_ms": None, "k1_ms": None,
           "lead_host_ms": None, "k1_after_call_ms": None, "first_op_after_span": True}
    # two views: the spans, their device operations, the calls' starts (ns)
    views = [(1_000_000, 9_000_000), (10_000_000, 19_000_000)]
    device = [(1_400_000, 2_000_000, "void fwd_kernel_wsplit()", 1),
              (1_500_000, 3_000_000, "hash_field_kernel(HashFieldArgs)", 2),
              (13_000_000, 14_000_000, "hash_field_kernel(HashFieldArgs)", 3),
              (3_000_000, 3_500_000, "static_composite_kernel(StaticCompositeArgs)", 4),
              (14_000_000, 14_500_000, "static_composite_kernel(StaticCompositeArgs)", 5)]
    calls = {1: 1_100_000, 2: 1_200_000, 3: 10_500_000, 4: 1_300_000, 5: 10_600_000}
    ctx = {"kind": "hash_render", "trace": tr, "views": 2, "rays": rays, "samples": samples,
           "hash_bound_s": bound, "flops": 1.0, "peak_flops": 4.0,
           "view_spans": [rec, dict(rec, launches=23)], "view_events": (views, device, calls)}
    assert harness.metric_file("view_lead_ms.hash_render").name == "view_lead_ms.hash_render.py"
    assert harness.read_metric("hash_roofline.hash_render", ctx) == pytest.approx(25.0)
    assert harness.read_metric("mfu.hash_render", ctx) == pytest.approx(25.0)
    assert harness.read_metric("device_idle.hash_render", ctx) == pytest.approx(50.0)
    assert harness.read_metric("view_launches.hash_render", ctx) == 22
    assert harness.read_metric("view_lead_ms.hash_render", ctx) == pytest.approx(1.75)
    # the tail: the last hash-field kernel's end to the view's last operation
    assert harness.metric_file("view_tail_ms.hash_render").name == "view_tail_ms.hash_render.py"
    assert harness.read_metric("view_tail_ms.hash_render", ctx) == pytest.approx(0.5)
    # a program without the kernel or the span: nothing to read
    tr["kernels"] = {}
    ctx["view_events"] = ([], [], {})
    assert harness.read_metric("hash_roofline.hash_render", ctx) is None
    assert harness.read_metric("view_lead_ms.hash_render", ctx) is None
    assert harness.read_metric("view_lead_ms.hash_render", {"trace": tr}) is None
    assert harness.read_metric("view_tail_ms.hash_render", ctx) is None
    assert harness.read_metric("view_tail_ms.hash_render", {"trace": tr}) is None
