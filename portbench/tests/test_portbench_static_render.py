"""The static method's render cell, ``static3d-k1-render``, rehearsed at a
tiny size on the CPU: it runs end to end and is ``correct``; a fault in
the one-field path (a wrong scale, a dropped sample, one pixel moved) or
in the view it returns (one pixel moved, half its rays left out) reads
over its limit; its reference imports nothing of JAX or either
package, and a run loads none of them; its new reader reads the one-field
Beer-Lambert kernel's share and nothing from an empty trace; the view
readers read the records the mix traced."""

import ast
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

CELL = "static3d-k1-render"


def test_the_cell_runs_end_to_end_and_is_correct():
    out = tiny.run(CELL)
    e2e, layer = harness.cell_metrics(tiny.bench(), CELL)
    assert out["correct"] is True
    assert set(out["metrics"]) == {m["name"] for m in e2e} == {
        "render_views_per_s", "render_view_p95_ms", "setup_s"}
    assert {m["name"] for m in layer} == {q + ".static_render" for q in (
        "k1_roofline", "device_idle", "mfu", "view_lead_ms", "view_tail_ms", "view_launches",
        "bl_roofline")}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["compared"]["view"]["value"] <= out["compared"]["view"]["limit"]


@pytest.mark.parametrize("fault", ["scale", "dropped_sample", "one_pixel"])
def test_a_fault_in_the_one_field_path_is_not_correct(fault, monkeypatch):
    from nerfca_tpu_torch.train import evaluation

    real = evaluation.render_transmission

    def broken(raw, i0, z, act, *a, **k):
        if fault == "scale":  # the Beer-Lambert scale off by 1e-4 of itself
            return real(raw, i0, z, act, scale_value=1e-2 * (1 + 1e-4))
        if fault == "dropped_sample":  # the first sample left out of each ray
            return real(raw[:, 1:], i0, z[1:], act)
        pix, sigma, dists = real(raw, i0, z, act)
        pix = pix.clone()
        pix[len(pix) // 3] -= 1e-4
        return pix, sigma, dists

    monkeypatch.setattr(evaluation, "render_transmission", broken)
    assert tiny.run(CELL)["correct"] is False


@pytest.mark.parametrize("fault", ["one_pixel", "half_the_rays"])
def test_a_static_view_altered_where_it_is_produced_is_not_correct(fault, monkeypatch):
    # test_portbench_control.py's faults on the one image a static view has
    from nerfca_tpu_torch.train import evaluation

    real = evaluation.render_test_view

    def broken(*a, **k):
        out = real(*a, **k)
        pix = out["pix_static"].clone()
        if fault == "one_pixel":
            pix[len(pix) // 3] -= 1e-4
        else:
            n = len(pix) // 2
            pix[n:2 * n] = pix[:n]
        out["pix_static"] = pix
        return out

    monkeypatch.setattr(evaluation, "render_test_view", broken)
    assert tiny.run(CELL)["correct"] is False


def test_the_reference_imports_nothing_of_jax_or_either_package():
    tree = ast.parse((tiny.ROOT / "portbench" / "reference" / "static_render.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "nerfca_tpu", "nerfca_tpu_torch"}


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.'); from portbench.tests import tiny; "
            f"tiny.run({CELL!r}); from portbench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_readers_of_the_static_render_cell():
    assert harness.metric_file("bl_roofline.static_render").name == "bl_roofline.py"
    assert harness.metric_file("view_lead_ms.static_render").name == "view_lead_ms.py"
    rays, samples = 40000, 500
    nbytes = 8.0 * rays * samples + 4.0 * rays + 8.0 * samples
    # two views' bytes in exactly twice the least time: 50%
    t = 2 * nbytes / 3.35e12
    tr = {"busy_s": 0.5, "window_s": 1.0, "n_kernels": 4,
          "kernels": {"fwd_kernel_wgmma<1, false, false>": (0.4, 2),
                      "static_composite_kernel(StaticCompositeArgs)": (2 * t, 2)}}
    rec = {"launches": 30, "k1": 10, "lead_ms": 1.0, "tail_ms": 0.01, "k1_ms": 20.0,
           "lead_host_ms": 0.9, "k1_after_call_ms": 0.001, "first_op_after_span": True}
    ctx = {"kind": "static_render", "trace": tr, "views": 2, "rays": rays, "samples": samples,
           "k1_bound_s": 0.1, "flops": 1.0, "peak_flops": 4.0,
           "view_spans": [rec, dict(rec, lead_ms=3.0)]}
    assert harness.read_metric("bl_roofline.static_render", ctx) == pytest.approx(50.0)
    assert harness.read_metric("k1_roofline.static_render", ctx) == pytest.approx(25.0)
    assert harness.read_metric("view_lead_ms.static_render", ctx) == pytest.approx(2.0)
    assert harness.read_metric("view_launches.static_render", ctx) == 30
    # the composite's Beer-Lambert kernel is not the one-field kernel
    tr["kernels"] = {"composite_kernel(CompositeArgs)": (0.1, 2)}
    assert harness.read_metric("bl_roofline.static_render", ctx) is None
