"""The non-SYNTH data families of the torch port against the JAX package on
the CPU: the XCAT and CCTA acquisition presets and the family dispatch, the
roadmap poses and perspective rays, the phantom series, experiment view
lists, MAGIX-SURR datasets built from reduced surrogate volumes by both
builders (images within the projector's 1e-5, equal jsons), the volume
and dynamic-volume providers, and a short ``train_composite`` on the
MAGIX-SURR data against JAX's. The XCAT-SURR dataset is built in
``tests/test_torch_surrogates.py`` beside the XCAT driver."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import os

import numpy as np
import pytest
import torch

from nerfca_tpu.data import dataset as jds
from nerfca_tpu.data import phantom as jph
from nerfca_tpu.data import views as jvw
from nerfca_tpu.geometry import cone as jcone
from nerfca_tpu.geometry import rays as jrays
from nerfca_tpu.geometry import rotations as jrot
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import trainer as jtr
from nerfca_tpu_torch.data import ccta_surrogate as tcs
from nerfca_tpu_torch.data import dataset as tds
from nerfca_tpu_torch.data import phantom as tph
from nerfca_tpu_torch.data import views as tvw
from nerfca_tpu_torch.geometry import cone as tcone
from nerfca_tpu_torch.geometry import rays as trays
from nerfca_tpu_torch.geometry import rotations as trot
from nerfca_tpu_torch.train import run_composite
from tests.test_torch_geometry_data import _args
from tests.test_torch_surrogates import REPO, SHAPE, SPACING, ZOOMED, assert_same_build, family_args
from tests.test_torch_trainer import SMALL

EXPERIMENT = os.path.join(REPO, "configs", "experiments", "one-frame-resp.json")


@pytest.mark.parametrize("preset", ["xcat_geometry", "ccta_geometry", "synth_geometry"])
@pytest.mark.parametrize("size", [200, 50, 100])
def test_presets_equal_jax(preset, size):
    dims = [512, 512, 401] if preset == "xcat_geometry" else [256, 256, 256]
    if size == 100:
        with pytest.raises(ValueError):
            getattr(tcone, preset)(size, dims)
        return
    got, want = getattr(tcone, preset)(size, dims), getattr(jcone, preset)(size, dims)
    assert got == want and json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("name", ["SYNTH", "SYNTH-FOVHC", "XCAT-SURR", "XCAT-V1", "MAGIX-SURR",
                                  "MAGIX-LCA", "CCTA", "UNKNOWN"])
def test_geometry_for_every_family(name):
    args = _args(data_name=name, data_size=200)
    if name == "UNKNOWN":
        for mod in (tds, jds):
            with pytest.raises(ValueError, match="unknown data_name family"):
                mod._geometry_for(args, (64, 64, 64))
        return
    got = tds._geometry_for(args, (64, 64, 48))
    assert got == jds._geometry_for(args, (64, 64, 48))
    assert got["DSO"] == {"S": 450, "X": 450, "M": 600, "C": 600}[name[0]]


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (30.0, 10.0, 5.0), (-45.0, 60.0, -20.0)])
def test_roadmap_rotations_and_perspective_rays_equal_jax(angles):
    # host numpy poses to 1e-12; the f32 rays within 1e-6
    for k in (trot.rot_x, trot.rot_y, trot.rot_z):
        np.testing.assert_allclose(k(0.7), getattr(jrot, k.__name__)(0.7), atol=1e-12)
    np.testing.assert_allclose(trot.roadmap_rotation(*angles), jrot.roadmap_rotation(*angles),
                               atol=1e-12)
    src, table = [0.0, 0.0, 5.0], (1.0, -2.0, 0.5)
    np.testing.assert_allclose(trot.roadmap_source_matrix(src, *angles, table),
                               jrot.roadmap_source_matrix(src, *angles, table), atol=1e-12)
    o, d = trays.perspective_rays(*angles, src, 12, 8, 4.0, table, device=torch.device("cpu"))
    jo, jd = jrays.perspective_rays(*angles, src, 12, 8, 4.0, table)
    assert o.shape == d.shape == (8, 12, 3) and o.device.type == "cpu"
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)


def test_synthetic_phantom_series_equals_jax():
    got = tph.synthetic_phantom_series(size=12, num_phases=3, lca_val=1.0)
    want = jph.synthetic_phantom_series(size=12, num_phases=3, lca_val=1.0)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[0], got[1])


def test_load_experiment_views_equals_jax(tmp_path):
    got, want = tvw.load_experiment_views(EXPERIMENT), jvw.load_experiment_views(EXPERIMENT)
    path = tmp_path / "sparse.json"  # defaults: no resp_phase, no test views
    path.write_text(json.dumps([{"hrt_phase": 0.3, "train_viewpoints": [[0, 0], [30, 15]]}]))
    got2, want2 = tvw.load_experiment_views(str(path)), jvw.load_experiment_views(str(path))
    for g, w in zip(got + got2, want + want2):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert got2[0]["resp_phase"] == 0 and got2[0]["test_viewpoints"].shape == (0, 2)


@pytest.fixture(scope="module")
def magix(tmp_path_factory):
    """Reduced MAGIX-SURR volumes (10 phases) and both builders' datasets."""
    tmp = tmp_path_factory.mktemp("magix")
    vols = str(tmp / "vols")
    tcs.write_surrogate_case(vols, phases=10, shape=SHAPE, spacing=SPACING, verbose=False)
    args = family_args(data_name="MAGIX-SURR", volume_root=vols)
    return {"vols": vols, "args": args, "tmp": tmp,
            "jax": jds.build_dataset(args, str(tmp / "jax"), projector_samples=64),
            "torch": tds.build_dataset(args, str(tmp / "torch"), projector_samples=64)}


def test_magix_surrogate_dataset_equals_jax(magix):
    names = assert_same_build(magix["jax"], magix["torch"])
    dyn = [n for n in names if n.endswith("-dyn.npy")]
    assert len(dyn) == 10 * 5 and any(np.load(os.path.join(magix["torch"].folder, n)).max() > 0
                                      for n in dyn)
    assert sum(n.endswith("-var.npy") for n in names) == 9  # 4 train + 5 test views
    with open(magix["torch"].general) as f:
        info = json.load(f)
    assert info["DSO"] == 600 * 1e-2 and info["nVoxel"] == list(ZOOMED)


def test_experiment_view_list_builds_equal_to_jax(magix):
    # --use_experiment_name: the json's one phase and its views, named by
    # the experiment, from configs/experiments/ (read from the repo root)
    args = family_args(data_name="MAGIX-SURR", volume_root=magix["vols"],
                       use_experiment_name=True, experiment_name="one-frame-resp")
    tmp = magix["tmp"]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        jp = jds.build_dataset(args, str(tmp / "exp-jax"), projector_samples=64)
        tp = tds.build_dataset(args, str(tmp / "exp-torch"), projector_samples=64)
    finally:
        os.chdir(cwd)
    assert os.path.basename(tp.train) == "train-one-frame-resp.json"
    assert_same_build(jp, tp)
    with open(tp.train) as f, open(tp.test) as g:
        train, test = json.load(f)["frames"], json.load(g)["frames"]
    assert len(train) == len(test) == 4 and {f["heart_phase"] for f in train + test} == {0}
    args.experiment_name = "absent"
    with pytest.raises(FileNotFoundError, match="experiment json"):
        tds.build_dataset(args, str(tmp / "exp-absent"), projector_samples=8)


@pytest.mark.parametrize("name", ["MAGIX-LCA", "XCAT-V1", "CCTA"])
def test_non_synth_without_volumes_raises_file_not_found(tmp_path, name):
    # a mistyped --volume_root must not train on the phantom, in either package
    args = _args(data_name=name, volume_root=str(tmp_path / "missing"))
    for mod in (tds, jds):
        with pytest.raises(FileNotFoundError, match="no volume for phase 0"):
            mod.build_dataset(args, str(tmp_path / mod.__name__), projector_samples=8)
        with pytest.raises(FileNotFoundError):
            mod._default_volume_provider(_args(data_name=name))(3)


def test_non_synth_without_dynamic_volumes_writes_no_dyn(tmp_path):
    # a CCTA case with no dyn_volume_tigre.npy (a real scan): no -dyn.npy
    # from either builder, the rest as ever
    vols = tmp_path / "vols"
    rng = np.random.default_rng(0)
    for phase in (0, 1):
        (vols / str(phase)).mkdir(parents=True)
        np.save(vols / str(phase) / "full_volume_tigre.npy",
                rng.random((16, 16, 16), np.float32) * 0.01)
    args = _args(data_name="MAGIX-LCA", volume_root=str(vols))
    for mod in (tds, jds):
        assert mod._default_dynamic_provider(args)(0) is None
    jp = jds.build_dataset(args, str(tmp_path / "jax"), projector_samples=32)
    tp = tds.build_dataset(args, str(tmp_path / "torch"), projector_samples=32)
    names = assert_same_build(jp, tp)
    assert names and not any(n.endswith("-dyn.npy") for n in names)
    assert tds._default_dynamic_provider(_args())(0) is not None  # SYNTH keeps its vessel


def test_providers_passed_to_build_dataset_are_read(tmp_path):
    # the injected providers, not --volume_root or the phantom, give the
    # volumes (both packages' contract); a provider may return no vessel
    calls = {"vol": [], "dyn": []}

    def volume(phase):
        calls["vol"].append(phase)
        return np.full((12, 12, 12), 0.01 * (phase + 1), np.float32)

    def dynamic(phase):
        calls["dyn"].append(phase)
        return np.full((12, 12, 12), 0.002, np.float32) if phase == 0 else None

    args = _args(data_name="XCAT-V1", volume_root=str(tmp_path / "missing"))
    kw = dict(volume_provider=volume, dynamic_volume_provider=dynamic, projector_samples=32)
    tp = tds.build_dataset(args, str(tmp_path / "torch"), **kw)
    assert calls == {"vol": [0, 1], "dyn": [0, 1]}
    jp = jds.build_dataset(args, str(tmp_path / "jax"), **kw)
    names = assert_same_build(jp, tp)
    dyn = sorted(n for n in names if n.endswith("-dyn.npy"))
    assert dyn and all("hrt=0" in n for n in dyn)
    with open(tp.general) as f:
        assert json.load(f)["nVoxel"] == [12, 12, 12]


def test_train_composite_on_magix_surrogate_follows_jax(magix, tmp_path):
    # three steps of each package's train_composite on the MAGIX-SURR data
    # with the recipe's hull, ray jitter, selection view and best metric,
    # and the eval after them: train losses within 1e-5 relative, the
    # eval's PSNR within 1e-3 dB
    argv = ["--config", SMALL, "--data_name", "MAGIX-SURR", "--data_size", "50",
            "--volume_root", magix["vols"], "--selection_view", "0,0",
            "--data_root", str(magix["tmp"] / "torch"), "--use_motion_hull", "true",
            "--ray_jitter_perc", "1.0", "--best_metric", "separated_psnr",
            "--n_iters", "2", "--display_every", "3", "--log_every", "1"]
    jout = jtr.train_composite(jcfg.parse_args([*argv, "--log_dir_root",
                                                str(tmp_path / "jax")]))
    tout = run_composite.main([*argv, "--platform", "cpu", "--log_dir_root",
                               str(tmp_path / "torch")])
    assert tout["setup"]["hull"] is not None
    recs = {}
    for pkg, out in (("jax", jout), ("torch", tout)):
        with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
            recs[pkg] = [json.loads(line) for line in f]
    j_train = [r for r in recs["jax"] if "train_loss" in r]
    t_train = [r for r in recs["torch"] if "train_loss" in r]
    assert [r["step"] for r in t_train] == [r["step"] for r in j_train] == [0, 1, 2]
    for a, b in zip(t_train, j_train):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-5)
    j_eval = [r for r in recs["jax"] if "test_image_psnr" in r]
    t_eval = [r for r in recs["torch"] if "test_image_psnr" in r]
    assert len(t_eval) == len(j_eval) == 1
    for k in ("test_image_psnr", "test_dyn_corr"):
        assert abs(t_eval[0][k] - j_eval[0][k]) <= 1e-3, k

