"""The torch port's composite driver end to end on the CPU, its config
surface against the JAX one, and its import isolation."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import glob
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import evaluation as jev
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models.fields import FieldConfig
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import run_composite
from nerfca_tpu_torch.train import trainer as ttr
from nerfca_tpu_torch.train.step import CompositeHParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(REPO, "configs", "synth-small.txt")
# a 2-phase, 24^3 dataset keeps the CPU build to seconds
FAST_DATA = ["--data_time_range_end", "2", "--synth_vol_size", "24"]


def _jax_train_metric_names():
    """The metric names the JAX step logs, from one tiny JAX loss call."""
    kw = dict(num_early_layers=1, num_filters=8, pos_enc="free_windowed", pos_enc_basis=2)
    cfgs = {"static": jf.FieldConfig(**kw),
            "temp": jf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}
    params = {"static": jf.init_static_field(jax.random.PRNGKey(0), cfgs["static"]),
              "temp": jf.init_temporal_field(jax.random.PRNGKey(1), cfgs["temp"])}
    batch = {"origins": jnp.zeros((2, 3)), "directions": jnp.ones((2, 3)),
             "pixels": jnp.ones(2), "weights": jnp.ones(2), "phases": jnp.zeros(2, jnp.int32),
             "initial_intensities": jnp.full((2,), 2.0)}
    _, m = js.composite_loss_fn(params, batch, jnp.linspace(1.0, 2.0, 4), jnp.int32(0), cfgs,
                                js.CompositeHParams(img_sample_size=2))
    return set(m)


def _jax_eval_metric_names():
    n = 16
    render = {k: jnp.full((n,) if k.startswith("pix") else (n, 4), 0.01)
              for k in ("pix", "static_sigma", "temp_sigma")}
    render["pix"] = jnp.linspace(1.0, 2.0, n)
    render["dists"] = jnp.full((4,), 0.1)
    out = jev.test_metrics(render, jnp.linspace(1.1, 2.1, n), 0, js.CompositeHParams(),
                           img_shape=(4, 4))
    return set(out) | {"test_dyn_psnr", "test_dyn_corr"}


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("run")
    out = run_composite.main([
        "--config", SMALL, "--platform", "cpu", "--n_iters", "2", "--display_every", "3",
        "--static_num_filters", "128", "--temp_num_filters", "128", "--use_pallas", "true",
        "--log_every", "1", "--data_root", str(tmp / "data"), "--log_dir_root", str(tmp / "cases"),
        *FAST_DATA,
    ])
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return out, records


def test_cpu_run_trains_and_evaluates(cpu_run):
    out, records = cpu_run
    train = [r for r in records if "train_loss" in r]
    evals = [r for r in records if "test_image_psnr" in r]
    assert [r["step"] for r in train] == [0, 1, 2]
    assert all(math.isfinite(r["train_loss"]) for r in train)
    assert len(evals) == 1 and evals[0]["step"] == 3
    assert math.isfinite(evals[0]["test_image_psnr"])
    assert out["final_step"] == 3 and out["diverged_at"] is None
    # the kernel path was requested and is in the envelope; on the CPU it
    # runs the plain version
    assert out["setup"]["hp"].use_pallas


def test_cpu_run_logs_the_jax_metric_names(cpu_run):
    _, records = cpu_run
    train = next(r for r in records if "train_loss" in r)
    ev = next(r for r in records if "test_image_psnr" in r)
    assert set(train) == _jax_train_metric_names() | {"step", "_time", "train_time"}
    assert set(ev) == _jax_eval_metric_names() | {"step", "_time"}


def test_platform_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_composite.main(["--config", SMALL, "--n_iters", "1",
                            "--data_root", str(tmp_path / "d"),
                            "--log_dir_root", str(tmp_path / "c")])


@pytest.mark.parametrize("flag,says", [
    ("--early_stop_patience", "a final checkpoint is still saved"),
    ("--best_metric", "always dominate ones below it"),
    ("--sep_corr_threshold", "dyn_corr gate for --best_metric separated_psnr"),
    ("--profile_steps", "torch.profiler trace for the first N steps"),
    ("--pallas_bf16_residuals", "the forward and the loss stay f32"),
    ("--mesh_shape", "ignores it"),
])
def test_help_says_what_unported_flags_do(flag, says):
    action = next(a for a in tcfg.build_parser()._actions if flag in a.option_strings)
    assert says in " ".join(action.help.split())


def test_multi_view_eval_record_carries_the_step(tmp_path):
    # several selection views: the eval record is their mean, and carries
    # the step inside it as the JAX trainer's does (nerfca_tpu/train/
    # trainer.py sets tm["step"])
    out = run_composite.main([
        "--config", SMALL, "--platform", "cpu", "--n_iters", "1", "--display_every", "2",
        "--selection_view", "0,0;90,0", "--data_root", str(tmp_path / "data"),
        "--log_dir_root", str(tmp_path / "cases"), *FAST_DATA,
    ])
    assert out["last_eval"]["step"] == 2
    assert "test_image_psnr_sel1" in out["last_eval"]
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "test_image_psnr" in r]
    assert len(evals) == 1 and evals[0]["step"] == 2


def test_resolve_pallas_support_downgrades_with_warning():
    kw = dict(num_filters=128, pos_enc_basis=4)
    ok = {"static": FieldConfig(**kw),
          "temp": FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}
    hp = CompositeHParams(use_pallas=True)
    assert ttr.resolve_pallas_support(hp, ok) is hp
    fourier = {k: dataclasses.replace(c, pos_enc="fourier", fourier_sigma=2.0)
               for k, c in ok.items()}
    assert ttr.resolve_pallas_support(hp, fourier) is hp  # inside since the kernels take it
    for bad in (dict(num_filters=64), dict(pos_enc="fourier", pos_enc_basis=22)):
        cfgs = dict(ok, static=dataclasses.replace(ok["static"], **bad))
        with pytest.warns(UserWarning, match="envelope"):
            assert not ttr.resolve_pallas_support(hp, cfgs).use_pallas


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.txt"))))
def test_configs_parse_like_the_jax_package(path):
    a = vars(tcfg.parse_args(["--config", path]))
    b = vars(jcfg.parse_args(["--config", path]))
    a.pop("platform"), b.pop("platform")
    assert a == b


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerfca_tpu_torch\n"
        "for m in pkgutil.walk_packages(nerfca_tpu_torch.__path__, 'nerfca_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'nerfca_tpu' or k.startswith('nerfca_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_eval_metrics_match_jax_on_one_render():
    # same render -> same test metrics (1e-5 relative)
    rng = np.random.default_rng(0)
    n, s = 36, 12
    render = {"pix": rng.uniform(1.6, 2.2, n), "static_sigma": rng.uniform(0, 0.02, (n, s)),
              "temp_sigma": rng.uniform(0, 0.02, (n, s)), "dists": np.full(s, 0.1)}
    render = {k: v.astype(np.float32) for k, v in render.items()}
    gt = rng.uniform(1.6, 2.2, n).astype(np.float32)
    hp_t = CompositeHParams(entro_use_weighting=True, dynamic_entro_weight_start=1e-3)
    hp_j = js.CompositeHParams(entro_use_weighting=True, dynamic_entro_weight_start=1e-3)
    from nerfca_tpu_torch.train import evaluation as tev

    a = tev.test_metrics({k: torch.tensor(v) for k, v in render.items()}, torch.tensor(gt),
                         7, hp_t, img_shape=(6, 6))
    b = jev.test_metrics({k: jnp.asarray(v) for k, v in render.items()}, jnp.asarray(gt),
                         7, hp_j, img_shape=(6, 6))
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=0, err_msg=k)
    x, y = rng.random((5, 5)), rng.random((5, 5))
    assert tev.pearson_corr(x, y) == jev.pearson_corr(x, y)
    assert tev.image_ssim(x, y) == jev.image_ssim(x, y)
