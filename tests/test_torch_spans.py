"""The port's own spans (``utils/profiling.py::span``): free without a
profiler, operator-scope records under one, where the eval renderer, the
train steps, the hull gate and the chunk's read-back put them, and no
change to what a profiled call computes."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.hull import MotionHull
from nerfca_tpu_torch.train import evaluation, step as ts
from nerfca_tpu_torch.train.trainer import _run_chunk
from nerfca_tpu_torch.utils import profiling

PACKAGE = Path(__file__).resolve().parents[1] / "nerfca_tpu_torch"
PHASES = ["nerfca.step.draws", "nerfca.step.upload", "nerfca.step.batch",
          "nerfca.step.loss_grads", "nerfca.step.adam"]


def traced(fn):
    """``fn()``'s result and its ``nerfca.*`` spans in start order, each as
    ``(name, enclosing nerfca.* span or None)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("nerfca."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("nerfca."):
            parent = parent.cpu_parent
        found.append((e.name, parent.name if parent is not None else None))
    return out, found


def field_cfgs(suffixes=("",)):
    kw = dict(num_early_layers=1, num_filters=32, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    out = {}
    for s in suffixes:
        out["static" + s] = tf.FieldConfig(**kw)
        out["temp" + s] = tf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)
    return out


def field_params(cfgs, seed=0):
    keys = prng.split(prng.key(seed), len(cfgs))
    return {k: (tf.init_temporal_field if k.startswith("temp") else tf.init_static_field)(key, c)
            for (k, c), key in zip(sorted(cfgs.items()), keys)}


def hull():
    grid = (0.2 + 0.8 * np.random.default_rng(9).random((6, 6, 6))).astype(np.float32)
    return MotionHull(torch.tensor(grid), torch.full((3,), 0.5), torch.zeros(3))


def rays(n, seed=0):
    rng = np.random.default_rng(seed)
    origins = np.tile(np.array([[0.05, -0.1, -4.5]], np.float32), (n, 1))
    dirs = np.concatenate([rng.uniform(-0.08, 0.08, (n, 2)), np.ones((n, 1))], 1)
    return torch.tensor(origins), torch.tensor(dirs, dtype=torch.float32)


def test_span_calls_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record was made with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with profiling.span("nerfca.eval.view"):
        pass
    assert profiling.span("nerfca.a") is profiling.span("nerfca.b")


def test_span_records_an_operator_scope_event_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("nerfca.outer"):
            with profiling.span("nerfca.inner"):
                torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("nerfca.outer") == 1 and names.count("nerfca.inner") == 1
    inner = next(e for e in prof.events() if e.name == "nerfca.inner")
    assert inner.cpu_parent.name == "nerfca.outer"
    assert any(c.name == "aten::sum" for c in inner.cpu_children)
    # not a user annotation: the profiler mirrors those onto the device's timeline
    kineto = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert not kineto["nerfca.outer"].is_user_annotation()


def test_every_span_name_is_namespaced_and_names_no_kernel():
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r"""\bspan\(\s*["']([^"']+)["']""", path.read_text()))
    assert {"nerfca.eval.view", "nerfca.eval.tile", "nerfca.eval.composite",
            "nerfca.hull_gate", "nerfca.train.readback", *PHASES} <= names
    for name in names:
        assert name.startswith("nerfca."), name
        assert not any(k in name for k in ("fwd_kernel", "bwd_kernel", "reduce_kernel",
                                           "loss_kernel", "terms_kernel")), name


@pytest.mark.parametrize("fine,gated", [(False, False), (True, False), (False, True),
                                        (True, True)])
def test_render_test_view_spans(fine, gated):
    n, tile, s = 10, 4, 8
    n_tiles = -(-n // tile)
    cfgs = field_cfgs(("", "_fine") if fine else ("",))
    params = field_params(cfgs)
    origins, dirs = rays(n)
    phases = torch.arange(n) % 10
    z = torch.linspace(3.6, 5.4, s)
    hp = ts.CompositeHParams(depth_samples_coarse=s)
    kw = dict(tile=tile, hull=hull() if gated else None,
              depth_values_fine=torch.linspace(3.7, 5.3, s + 2) if fine else None)

    def view():
        return evaluation.render_test_view(params, origins, dirs, phases, z, 50, cfgs, hp, 2.16,
                                           **kw)

    plain = view()
    got, found = traced(view)
    tile_spans = [("nerfca.eval.tile", "nerfca.eval.view")] * n_tiles
    if gated:
        tile_spans = [("nerfca.eval.tile", "nerfca.eval.view"),
                      ("nerfca.hull_gate", "nerfca.eval.tile")] * n_tiles
    one_pair = tile_spans + [("nerfca.eval.composite", "nerfca.eval.view")]
    assert found == [("nerfca.eval.view", None)] + one_pair * (2 if fine else 1)
    assert set(got) == set(plain)
    for k in plain:
        assert torch.equal(got[k], plain[k]), k


def composite_problem(n=16, gated=False):
    origins, dirs = rays(n, seed=1)
    rng = np.random.default_rng(2)
    table = torch.zeros(n, 4, 3)
    table[:, 0], table[:, 1] = origins, dirs
    table[:, 2, 0] = torch.tensor(2.16 - rng.uniform(0, 0.5, n), dtype=torch.float32)
    table[:, 3, 0] = torch.tensor(rng.choice([1.0, 2.0], n), dtype=torch.float32)
    ids = torch.arange(n)
    args = (table, ids % 10, ids[: n // 4], ids[n // 4:])
    return args, (hull() if gated else None)


def check_step(train_step, params, gated):
    args, h = composite_problem(gated=gated)
    state = ts.TrainState(params, ts.init_opt_state(params), 0, prng.key(7))
    twin = copy.deepcopy(state)
    train_step(twin, *args, hull=h)
    _, found = traced(lambda: train_step(state, *args, hull=h))
    outer = [name for name, parent in found if parent is None]
    assert outer == PHASES
    gates = [parent for name, parent in found if name == "nerfca.hull_gate"]
    assert gates == (["nerfca.step.loss_grads"] if gated else [])
    assert state.step == twin.step and np.array_equal(state.rng, twin.rng)
    for a, b in zip(ts.param_items(state.params), ts.param_items(twin.params)):
        assert torch.equal(a[1], b[1]), a[0]
    assert state.opt_state["count"] == twin.opt_state["count"]
    for k in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(state.opt_state[k], twin.opt_state[k])), k


@pytest.mark.parametrize("gated", [False, True])
def test_composite_step_phase_spans(gated):
    cfgs = field_cfgs()
    hp = ts.CompositeHParams(img_sample_size=4, nb_var_rays=2, depth_samples_coarse=8,
                             hyperparam_decay_steps=100, ray_jitter=1e-3)
    step = ts.make_composite_train_step(cfgs, hp, ts.make_optimizer(1e-3, 0.1, 100),
                                        torch.linspace(3.6, 5.4, 8), 2.16)
    check_step(step, field_params(cfgs), gated)


def test_static_step_phase_spans():
    cfg = field_cfgs()["static"]
    hp = ts.StaticHParams(img_sample_size=4, nb_var_rays=2, depth_samples_coarse=8)
    step = ts.make_static_train_step(cfg, hp, ts.make_optimizer(1e-3, 0.1, 100),
                                     torch.linspace(3.6, 5.4, 8), 2.16)
    check_step(step, {"static": tf.init_static_field(prng.key(3), cfg)}, False)


def test_run_chunk_reads_back_once_a_chunk():
    cfgs = field_cfgs()
    hp = ts.CompositeHParams(img_sample_size=4, depth_samples_coarse=8,
                             hyperparam_decay_steps=100)
    step = ts.make_composite_train_step(cfgs, hp, ts.make_optimizer(1e-3, 0.1, 100),
                                        torch.linspace(3.6, 5.4, 8), 2.16)
    params = field_params(cfgs)
    state = ts.TrainState(params, ts.init_opt_state(params), 0, prng.key(5))
    args, _ = composite_problem()
    dd = dict(zip(("rays", "phases", "var_ids", "non_var_ids"), args))

    def two_chunks():
        return [_run_chunk(step, state, dd, 3) for _ in range(2)]

    chunks, found = traced(two_chunks)
    outer = [name for name, parent in found if parent is None]
    assert outer == (PHASES * 3 + ["nerfca.train.readback"]) * 2
    assert all(len(c["train_loss"]) == 3 for c in chunks)
