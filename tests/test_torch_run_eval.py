"""The torch port's offline eval and render CLIs against the JAX package's:
one JAX param tree saved through each package's checkpoint writer, then
scored and rendered by each package's CLI on the same dataset folder."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.hull import hull_args_record as jax_hull_record
from nerfca_tpu.train import checkpoint as jck
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import evaluation as jev
from nerfca_tpu.train import run_eval as jre
from nerfca_tpu.train import run_render as jrr
from nerfca_tpu.train import step as js
from nerfca_tpu.train.trainer import field_configs_from_args as jax_field_configs
from nerfca_tpu_torch.data.dataset import build_dataset
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import evaluation as tev
from nerfca_tpu_torch.train import run_eval as tre
from nerfca_tpu_torch.train import run_render as trr
from nerfca_tpu_torch.train import step as ts
from tests.test_torch_trainer import FAST_DATA, SMALL

STEP = 150  # half-way through synth-small's window opening


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A dataset folder and one JAX param tree saved by both packages, with
    a hull record that turns the hull off (the command lines below ask for
    it: the record must win in both)."""
    tmp = tmp_path_factory.mktemp("eval")
    data_root = str(tmp / "data")
    argv = ["--config", SMALL, "--data_root", data_root, *FAST_DATA]
    # 40 projector samples per ray keep the build short
    build_dataset(tcfg.parse_args(argv), data_root, projector_samples=40)
    jargs = jcfg.parse_args(argv)
    cfgs = jax_field_configs(jargs)
    params = {"static": jf.init_static_field(jax.random.PRNGKey(3), cfgs["static"]),
              "temp": jf.init_temporal_field(jax.random.PRNGKey(4), cfgs["temp"])}
    run = {"data_name": "SYNTH", "step": STEP, "hull": jax_hull_record(jargs)}
    tx = js.make_optimizer(1e-3, 0.01, 300)
    jck.save_checkpoint(str(tmp / "jax"), js.TrainState(params, tx.init(params),
                                                         jnp.int32(STEP), jax.random.PRNGKey(0)),
                        cfgs, run_metadata=run)
    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in params.items()}
    tcfgs = tck.load_field_configs(str(tmp / "jax"))
    tck.save_checkpoint(str(tmp / "torch"), ts.TrainState(tparams, ts.init_opt_state(tparams),
                                                           STEP, prng.key(0)),
                        tcfgs, run_metadata=run)
    cli = argv + ["--use_motion_hull", "true"]
    return {"jax": str(tmp / "jax"), "torch": str(tmp / "torch"), "cli": cli}


def args_for(saved, pkg, *extra):
    if pkg == "jax":
        return jcfg.parse_args(saved["cli"] + ["--resume_from", saved["jax"], *extra])
    return tcfg.parse_args(saved["cli"] + ["--resume_from", saved["torch"], "--platform", "cpu",
                                           *extra])


@pytest.fixture(scope="module")
def scores(saved):
    out = {}
    for pkg, fn in (("jax", jre.evaluate_checkpoint), ("torch", tre.evaluate_checkpoint)):
        args = args_for(saved, pkg)
        with pytest.warns(UserWarning, match="use_motion_hull"):
            fn(args, write_images=False)
        assert args.use_motion_hull is False  # the checkpoint's record won
        with open(os.path.join(saved[pkg], "eval", "eval_scores.json")) as f:
            out[pkg] = json.load(f)
    return out


def test_eval_scores_have_the_jax_keys(scores):
    j, t = scores["jax"], scores["torch"]
    assert set(t) == set(j)
    assert t["step"] == j["step"] == STEP
    assert [set(r) for r in t["per_view"]] == [set(r) for r in j["per_view"]]
    assert set(t["per_view_angle"]) == set(j["per_view_angle"])
    for key, row in j["per_view_angle"].items():
        assert set(t["per_view_angle"][key]) == set(row)
        assert t["per_view_angle"][key]["n_phases"] == row["n_phases"]


def test_eval_scores_agree_with_jax(scores):
    # per view: PSNRs within 1e-3 dB, SSIMs and dyn_corr within 1e-4 (f32
    # renders of the same params, summed in another order)
    j, t = scores["jax"], scores["torch"]
    assert len(t["per_view"]) == len(j["per_view"]) == 8
    for a, b in zip(t["per_view"], j["per_view"]):
        assert (a["image_id_str"], a["theta"], a["phi"], a["heart_phase"]) == (
            b["image_id_str"], b["theta"], b["phi"], b["heart_phase"])
        for key in ("psnr", "dyn_psnr", "dyn_psnr_masked"):
            assert abs(a[key] - b[key]) <= 1e-3, (key, a[key], b[key])
        for key in ("ssim", "dyn_ssim", "dyn_corr"):
            assert abs(a[key] - b[key]) <= 1e-4, (key, a[key], b[key])
    for key in ("mean_psnr", "mean_dyn_psnr", "mean_dyn_psnr_masked"):
        assert abs(t[key] - j[key]) <= 1e-3, key
    for key in ("mean_ssim", "mean_dyn_ssim", "mean_dyn_corr"):
        assert abs(t[key] - j[key]) <= 1e-4, key


def test_render_views_agree_with_jax(saved):
    # the composite, static and dynamic images within 1e-5 of max_pixel_value
    views = [(-30.0, 30.0, 0), (60.0, -30.0, 1)]
    with pytest.warns(UserWarning, match="use_motion_hull"):
        jres = jrr.render_views(args_for(saved, "jax"), views)
    with pytest.warns(UserWarning, match="use_motion_hull"):
        tres = trr.render_views(args_for(saved, "torch"), views)
    assert tres == jres
    names = sorted(os.listdir(os.path.join(saved["jax"], "renders")))
    npys = [n for n in names if n.endswith(".npy")]
    assert len(npys) == 6
    assert sorted(n for n in os.listdir(os.path.join(saved["torch"], "renders"))
                  if n.endswith(".npy")) == npys
    for n in npys:
        a = np.load(os.path.join(saved["torch"], "renders", n))
        b = np.load(os.path.join(saved["jax"], "renders", n))
        assert a.shape == b.shape == (50, 50)
        assert np.abs(a - b).max() <= 1e-5 * 2.16, n


@pytest.mark.parametrize("argv", [
    ["--render_views=-30,30,0;60,-30,5"],
    ["--render_spin", "5"],
    ["--render_views=0,0,3; 45.5,-10,9;", "--render_spin", "1"],
])
def test_render_cli_builds_the_jax_views(argv, monkeypatch):
    got = {}
    monkeypatch.setattr(jrr, "render_views", lambda args, views: got.setdefault("jax", views))
    monkeypatch.setattr(trr, "render_views", lambda args, views: got.setdefault("torch", views))
    jrr.main(["--config", SMALL, *argv])
    trr.main(["--config", SMALL, *argv])
    assert got["torch"] == got["jax"] and got["jax"]
    assert trr.parse_views("1,2,3;4,5,6") == jrr.parse_views("1,2,3;4,5,6")


def test_render_cli_without_views_exits():
    with pytest.raises(SystemExit, match="nothing to render"):
        trr.main(["--config", SMALL])


def test_eval_requires_a_checkpoint():
    with pytest.raises(ValueError, match="resume_from"):
        tre.evaluate_checkpoint(tcfg.parse_args(["--config", SMALL, "--platform", "cpu"]))


def _masked_cases():
    rng = np.random.default_rng(7)
    vessel = np.zeros((24, 24), np.float32)
    vessel[8:12, 3:20] = rng.uniform(0.5, 1.0, (4, 17))
    return {
        "random": (rng.normal(0, 1, (24, 24)), rng.uniform(0, 2, (24, 24))),
        "vessel": (vessel + rng.normal(0, 0.05, vessel.shape), vessel),
        "empty_render": (np.zeros((24, 24)), vessel),
        "empty_gt": (rng.normal(0, 1, (24, 24)), np.zeros((24, 24))),
        "negative_gt": (rng.normal(0, 1, (24, 24)), -rng.uniform(0, 1, (24, 24))),
        "exact": (vessel, vessel),
    }


@pytest.mark.parametrize("case", sorted(_masked_cases()))
def test_masked_region_psnr_matches_jax(case):
    pred, gt = _masked_cases()[case]
    for dilate in (0, 2):
        a = tev.masked_region_psnr(pred, gt, dilate=dilate)
        b = jev.masked_region_psnr(pred, gt, dilate=dilate)
        assert a == b or (np.isnan(a) and np.isnan(b)), (case, dilate, a, b)
