"""The eval renderer's composite off the card: ``render_test_view`` on CPU
tensors takes the torch route (``ops/render.py`` over the joined tiles),
counts it once a view, and gives bit for bit what the whole-view composite
of the joined tiles gives. The Beer-Lambert kernel itself is held against
the same composite on the card (``tests/test_torch_gpu.py``)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses

import pytest
import torch

from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite
from nerfca_tpu_torch.train import evaluation, step as ts
from tests.test_torch_spans import field_cfgs, field_params, hull, rays

N_RAYS, TILE, S, STEP, I0 = 10, 4, 8, 50, 2.16  # three tiles, the last of two rays


def whole_view_composite(params, origins, dirs, phases, z, cfgs, hp, gate_hull, suffix,
                         images):
    """The pair's raw densities tile by tile, joined, then the three renders
    of ``ops/render.py`` over the whole view."""
    windows = ts.field_windows(cfgs, STEP)
    s_parts, t_parts, g_parts = [], [], []
    for start in range(0, N_RAYS, TILE):
        rows = slice(start, start + TILE)
        s_raw, t_raw = ts.evaluate_fields(params, origins[rows], dirs[rows], z, phases[rows],
                                          windows, cfgs, hp, suffix)
        s_parts.append(s_raw)
        t_parts.append(t_raw)
        if gate_hull is not None:
            g_parts.append(hull_gate_rays(gate_hull, origins[rows], dirs[rows], z))
    s_raw, t_raw = torch.cat(s_parts), torch.cat(t_parts)
    gate = torch.cat(g_parts) if g_parts else None
    i0 = torch.full((N_RAYS,), I0)
    pix, s_sig, t_sig, dists = render_transmission_composite(
        s_raw, t_raw, i0, z, hp.output_activation, temp_gate=gate)
    out = {"pix": pix, "static_sigma": s_sig, "temp_sigma": t_sig, "dists": dists}
    if images:
        out["pix_temp"] = render_transmission(t_raw, i0, z, hp.output_activation, gate=gate)[0]
        out["pix_static"] = render_transmission(s_raw, i0, z, hp.output_activation)[0]
    return {k + suffix: v for k, v in out.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("gated", [False, True])
def test_cpu_view_takes_the_torch_composite_bit_for_bit(use_pallas, fine, gated):
    # use_pallas with 128-wide fields: the kernels' twin on the CPU, the
    # condition under which the card takes the Beer-Lambert kernel
    cfgs = field_cfgs(("", "_fine") if fine else ("",))
    if use_pallas:
        cfgs = {k: dataclasses.replace(c, num_filters=128) for k, c in cfgs.items()}
    params = field_params(cfgs)
    origins, dirs = rays(N_RAYS)
    phases = torch.arange(N_RAYS) % 10
    z = torch.linspace(3.6, 5.4, S)
    z_fine = torch.linspace(3.7, 5.3, S + 2) if fine else None
    hp = ts.CompositeHParams(depth_samples_coarse=S, use_pallas=use_pallas)
    gate_hull = hull() if gated else None
    assert not evaluation.composite_on_kernel(origins, cfgs, hp)

    ft.reset_launch_counts()
    got = evaluation.render_test_view(params, origins, dirs, phases, z, STEP, cfgs, hp, I0,
                                      tile=TILE, depth_values_fine=z_fine, hull=gate_hull)
    assert ft.LAUNCHES["eval_composite.torch"] == 1
    assert ft.LAUNCHES["eval_composite.kernel"] == 0

    want = whole_view_composite(params, origins, dirs, phases, z, cfgs, hp, gate_hull, "",
                                True)
    if fine:
        want.update(whole_view_composite(params, origins, dirs, phases, z_fine, cfgs, hp,
                                         gate_hull, "_fine", False))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    if gated:  # the gate reaches the dynamic image and sigma
        ungated = whole_view_composite(params, origins, dirs, phases, z, cfgs, hp, None, "",
                                       True)
        assert not torch.equal(got["temp_sigma"], ungated["temp_sigma"])


@pytest.mark.parametrize("fault", ["raw_t_short", "raw_float64", "gate_short", "z_rows",
                                   "past_the_view"])
def test_eval_composite_refuses_malformed_tiles(fault):
    # the kernel's wrapper checks what it hands the card as pointers before
    # any launch (so the checks run here, with no card)
    r, s, n = 4, 8, 10
    z = torch.linspace(3.6, 5.4, s)
    raw_s, raw_t, gate, start = torch.zeros(r, s), torch.zeros(r, s), None, 0
    out = ft.eval_composite_buffers(n, z)
    if fault == "raw_t_short":
        raw_t = torch.zeros(r, s - 1)
    elif fault == "raw_float64":
        raw_s = raw_s.double()
    elif fault == "gate_short":
        gate = torch.ones(r - 1, s)
    elif fault == "z_rows":
        with pytest.raises(ValueError):
            ft.eval_composite_buffers(n, torch.zeros(n - 1, s))
        z = torch.zeros(n, s)
    else:
        start = n - r + 1
    with pytest.raises(ValueError):
        ft.eval_composite(raw_s, raw_t, z, I0, "softplus", out, start, gate)
