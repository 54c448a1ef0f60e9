"""The torch port's ``utils/activations.py`` and ``utils/profiling.py``
against the JAX package's on the CPU: activation capture on the same
numpy weights (``params_from_jax``), the activation statistics (JAX's
``jnp.std`` is the population std), ``StepTimer``'s keys and arithmetic,
``device_memory_stats`` on the CPU and without a card, and ``trace``. The
card's memory statistics and a trace on the card are in
``tests/test_torch_gpu.py``."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu.utils import activations as jact
from nerfca_tpu.utils import profiling as jprof
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.utils import activations as tact
from nerfca_tpu_torch.utils import profiling as tprof

ACT_ATOL = 1e-6  # f32 products of the same weights, summed in another order


def field(kind: str, late: int):
    kw = dict(num_early_layers=2, num_filters=32, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100, num_late_layers=late)
    if kind == "temporal":
        kw.update(use_time_latents=True, num_time_dim=4)
    jp = (jf.init_temporal_field if kind == "temporal" else jf.init_static_field)(
        jax.random.PRNGKey(late), jf.FieldConfig(**kw))
    return jf.FieldConfig(**kw), tf.FieldConfig(**kw), jax.tree.map(np.asarray, jp)


def capture_both(kind: str, late: int):
    jcfg, tcfg, params = field(kind, late)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (6, 5, 3)).astype(np.float32)
    window = np.asarray(free_window_mask(4, 50, 100, 1))
    if kind == "temporal":
        phases = rng.integers(0, 10, (6, 5)).astype(np.float32)  # cast to int inside
        want = jact.capture_temporal_activations(params, jnp.asarray(pts), jnp.asarray(phases),
                                                 jcfg, window=jnp.asarray(window))
        got = tact.capture_temporal_activations(tf.params_from_jax(params), torch.tensor(pts),
                                                torch.tensor(phases), tcfg,
                                                window=torch.tensor(window))
    else:
        want = jact.capture_static_activations(params, jnp.asarray(pts), jcfg,
                                               window=jnp.asarray(window))
        got = tact.capture_static_activations(tf.params_from_jax(params), torch.tensor(pts), tcfg,
                                              window=torch.tensor(window))
    return got, want


@pytest.mark.parametrize("kind", ["static", "temporal"])
@pytest.mark.parametrize("late", [0, 2])
def test_capture_activations_match_jax(kind, late):
    got, want = capture_both(kind, late)
    assert list(got) == list(want)
    names = ["input_layer", "early_0", "early_1"] + (["skip", "late_0"] if late else [])
    assert list(got) == names + ["output"] + (["latents"] if kind == "temporal" else [])
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(v), atol=ACT_ATOL,
                                   rtol=0, err_msg=k)


def test_activation_statistics_match_jax():
    got, want = capture_both("temporal", 2)
    ts_, js_ = tact.activation_statistics(got), jact.activation_statistics(want)
    assert list(ts_) == list(js_)
    for k, w in js_.items():
        g = ts_[k]
        assert g["shape"] == w["shape"] and set(g) == set(w), k
        # the same ReLU zeros, their share an f32 mean summed in another
        # order
        np.testing.assert_allclose(g["frac_zero"], w["frac_zero"], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose([g["mean"], g["std"]], [w["mean"], w["std"]], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # the population std (ddof 0), as jnp.std: torch.std's default is ddof 1
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    assert tact.activation_statistics({"a": a})["a"]["std"] == pytest.approx(np.sqrt(1.25))
    assert tact.activation_statistics({"a": a})["a"]["std"] == pytest.approx(
        float(jnp.std(jnp.asarray(a.numpy()))))


def test_step_timer_keys_and_arithmetic(monkeypatch):
    clock = iter([10.0, 12.0, 20.0, 20.5])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    t = tprof.StepTimer(rays_per_step=1024)
    t.start()
    out = [t.stop(4)]
    t.start()
    out += [t.stop(2), t.summary()]
    assert out[0] == {"chunk_time_s": 2.0, "steps_per_sec": 2.0, "rays_per_sec": 2048.0}
    assert out[1] == {"chunk_time_s": 0.5, "steps_per_sec": 4.0, "rays_per_sec": 4096.0}
    assert out[2] == {"total_steps": 6, "total_time_s": 2.5, "steps_per_sec": 2.4,
                      "rays_per_sec": 2.4 * 1024}
    # the same keys as JAX's timer (both read the one time module); no
    # rays_per_sec in a chunk without a ray count
    clock = iter([0.0, 0.0, 1.0, 1.0])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    t, j = tprof.StepTimer(), jprof.StepTimer()
    t.start()
    j.start()
    assert set(t.stop(3)) == set(j.stop(3)) == {"chunk_time_s", "steps_per_sec"}
    assert set(t.summary()) == set(j.summary())
    with pytest.raises(RuntimeError, match="start"):
        tprof.StepTimer().stop(1)


def test_device_memory_stats_cpu_and_without_a_card(monkeypatch):
    want = jprof.device_memory_stats()  # JAX's CPU device reports nothing
    got = tprof.device_memory_stats("cpu")
    assert len(got) == 1 and set(got[0]) == set(want[0])
    assert {k: v for k, v in got[0].items() if k != "device"} == {
        k: v for k, v in want[0].items() if k != "device"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tprof.device_memory_stats(device)
    with pytest.raises(ValueError, match="unknown device"):
        tprof.device_memory_stats("tpu")


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tprof.trace(str(tmp_path / "t")) as t:
        torch.ones(8).sum()
    (name,) = os.listdir(tmp_path / "t")
    assert name == t.name and name.endswith(".pt.trace.json")
    with open(tmp_path / "t" / name) as f:
        assert json.load(f)["traceEvents"]
    with tprof.trace(str(tmp_path / "u")) as t:
        t.name = "steps-0-2.json"
    assert os.listdir(tmp_path / "u") == ["steps-0-2.json"]


def test_torch_keeps_one_cpu_thread_in_test_processes():
    # tests/torch_cpu.py, imported first by every CPU test file of the port:
    # 6 xdist workers on 8 cores, one torch thread each, and the same for
    # the processes the tests spawn
    assert torch.get_num_threads() == 1
    assert os.environ["OMP_NUM_THREADS"] == "1"
