"""The torch port's geometry, phantom, views, projector and dataset builder
against the JAX package on the same inputs (CPU)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import argparse
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.data import dataset as jds
from nerfca_tpu.data import loader as jld
from nerfca_tpu.data import phantom as jph
from nerfca_tpu.data import views as jvw
from nerfca_tpu.geometry import cone as jcone
from nerfca_tpu.geometry import rays as jrays
from nerfca_tpu.ops import projector as jproj
from nerfca_tpu_torch.data import dataset as tds
from nerfca_tpu_torch.data import loader as tld
from nerfca_tpu_torch.data import phantom as tph
from nerfca_tpu_torch.data import views as tvw
from nerfca_tpu_torch.geometry import cone as tcone
from nerfca_tpu_torch.geometry import rays as trays
from nerfca_tpu_torch.ops import projector as tproj


def _info(data_size=50, vol=16):
    geo = jcone.ConeGeometry.from_dict(jcone.synth_geometry(data_size, [vol] * 3))
    info = geo.to_info_dict()
    info["near_thresh"], info["far_thresh"] = jcone.get_near_far(geo)
    return info


@pytest.mark.parametrize("angles", [(0.0, 0.0), (-30.0, 30.0), (60.0, -30.0), (90.0, 0.0)])
def test_detector_rays_match(angles):
    # 3-term f32 dot products: the two libraries may round the last bit
    info = _info(200, 128)
    jo, jd = jrays.detector_rays(*angles, 0.0, info)
    to, td = trays.detector_rays(*angles, 0.0, info)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(trays.pose_matrix(*angles, 0.0, 4.5),
                                  jrays.pose_matrix(*angles, 0.0, 4.5))


def test_cone_geometry_identical():
    # same numpy code: exact
    for size in (50, 200):
        for vol in ([16] * 3, [128] * 3):
            assert tcone.synth_geometry(size, vol) == jcone.synth_geometry(size, vol)
            tg = tcone.ConeGeometry.from_dict(tcone.synth_geometry(size, vol))
            jg = jcone.ConeGeometry.from_dict(jcone.synth_geometry(size, vol))
            assert tcone.get_near_far(tg) == jcone.get_near_far(jg)
            assert tg.to_info_dict() == jg.to_info_dict()


def test_flagship_views_count_and_match():
    # the flagship: 10 phases x (4 train + 4 test) views
    kw = dict(limited_range=60.0, step_size=120.0, numb_angles=4,
              time_range_start=0, time_range_end=10)
    tv, jv = tvw.select_views(**kw), jvw.select_views(**kw)
    assert len(tv) == 10
    assert sum(len(p["train_viewpoints"]) + len(p["test_viewpoints"]) for p in tv) == 80
    for a, b in zip(tv, jv):
        assert a["hrt_phase"] == b["hrt_phase"]
        np.testing.assert_array_equal(a["train_viewpoints"], b["train_viewpoints"])
        np.testing.assert_array_equal(a["test_viewpoints"], b["test_viewpoints"])


@pytest.mark.parametrize("phase", [0.0, 0.3, 0.9])
def test_phantom_volumes_identical(phase):
    # same numpy/scipy code: exact
    np.testing.assert_array_equal(tph.synthetic_phantom_volume(16, phase),
                                  jph.synthetic_phantom_volume(16, phase))
    np.testing.assert_array_equal(tph.synthetic_vessel_volume(16, phase),
                                  jph.synthetic_vessel_volume(16, phase))


def test_trilinear_sample_matches_including_far_face():
    # the far face (coordinate n-1) is where f32 rounding puts the clip at
    # n-1 for large n; both must then read the clamped corner with weight 0
    rng = np.random.default_rng(0)
    for n in (16, 128):
        vol = rng.random((n, n, n), dtype=np.float32)
        pts = rng.uniform(-1, n, (4000, 3)).astype(np.float32)
        pts[:50] = n - 1
        a = np.asarray(jproj.trilinear_sample(jnp.asarray(vol), jnp.asarray(pts)))
        b = tproj.trilinear_sample(torch.tensor(vol), torch.tensor(pts)).numpy()
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("angles", [(-30.0, 30.0), (90.0, 0.0)])
def test_project_view_matches(angles):
    # 16^3 volume, 8x8 detector, 64 samples; the depth grids may differ in
    # the last bit (two linspace implementations): 1e-5 absolute
    info = _info(50, 16)
    info["nDetector"] = [8, 8]
    info["dDetector"] = [d * 50 / 8 for d in info["dDetector"]]
    vol = jph.synthetic_phantom_volume(16, 0.2)
    a = np.asarray(jproj.project_view(vol, info, *angles, 0.0, n_samples=64))
    b = tproj.project_view(vol, info, *angles, 0.0, n_samples=64).numpy()
    assert b.shape == (8, 8)
    np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
    li = np.abs(a) + 0.1
    for x, y in zip(tproj.transmission_image(li, 8.67), jproj.transmission_image(li, 8.67)):
        np.testing.assert_array_equal(x, y)


def _args(**kw):
    base = dict(data_name="SYNTH", data_size=50, synth_vol_size=16, data_limited_range=60.0,
                data_step_size=120.0, data_numb_angles=4, data_time_range_start=0,
                data_time_range_end=2, data_limited_range_test=None, data_step_size_test=None,
                use_experiment_name=False, experiment_name=None, volume_root=None,
                selection_view=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ds")
    args = _args()
    jp = jds.build_dataset(args, str(tmp / "jax"), projector_samples=64)
    tp = tds.build_dataset(args, str(tmp / "torch"), projector_samples=64)
    return args, jp, tp


def _rel(frames, root):
    return [{k: (os.path.relpath(v, root) if k.endswith("file_path") else v)
             for k, v in f.items()} for f in frames]


def test_build_dataset_artifacts_match(built):
    # same names and json content; images within 1e-5 (projector tolerance)
    args, jp, tp = built
    assert sorted(os.listdir(tp.folder)) == sorted(os.listdir(jp.folder))
    assert os.path.basename(tp.train) == os.path.basename(jp.train)
    with open(tp.general) as f, open(jp.general) as g:
        assert json.load(f) == json.load(g)
    with open(tp.srcmatrices) as f, open(jp.srcmatrices) as g:
        assert json.load(f) == json.load(g)
    for name in ("train", "test", "evaluate"):
        with open(getattr(tp, name)) as f, open(getattr(jp, name)) as g:
            tf, jf = json.load(f)["frames"], json.load(g)["frames"]
        t_rel, j_rel = _rel(tf, tp.folder), _rel(jf, jp.folder)
        for a, b in zip(t_rel, j_rel):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(a.pop("img_min_max"), b.pop("img_min_max"), atol=1e-5)
            assert a == b
    for fname in os.listdir(jp.folder):
        if fname.endswith(".npy"):
            np.testing.assert_allclose(np.load(os.path.join(tp.folder, fname)),
                                       np.load(os.path.join(jp.folder, fname)), atol=1e-5)


def test_loader_reads_either_dataset(built):
    args, jp, tp = built
    jd = jld.load_dataset(jp, 1.0)
    for paths in (tp, jp):  # the port reads both packages' artifacts
        td = tld.load_dataset(paths, 1.0)
        np.testing.assert_allclose(td.rays, jd.rays, atol=1e-5)
        np.testing.assert_array_equal(td.phases, jd.phases)
        assert td.info == jd.info
        assert len(td.test_frames) == len(jd.test_frames) == 1
    assert os.path.basename(tds.dataset_paths(args, "x").test) == os.path.basename(
        jds.dataset_paths(args, "x").test)


def test_variance_maps_match(tmp_path):
    rng = np.random.default_rng(1)
    integrals = {"-30-30": [rng.random((6, 5)) for _ in range(10)], "60-30": [rng.random((6, 5))]}
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tds.write_variance_maps(integrals, str(tmp_path / "t"))
    jds.write_variance_maps(integrals, str(tmp_path / "j"))
    for key in integrals:
        name = f"image-{key}-var.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "t" / name),
                                      np.load(tmp_path / "j" / name))


def test_selection_view_tag_matches():
    args = _args(selection_view="-30,0;90,0")
    assert vars(tds.dataset_paths(args, "r")) == vars(jds.dataset_paths(args, "r"))
    assert tds.parse_selection_views("1,2") == jds._parse_selection_views("1,2")
