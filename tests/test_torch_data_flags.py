"""The data-build flags of the torch port against the JAX package on the
CPU: ``--volume_root`` volumes read ahead of the phantom, the
``--visualize_geometry`` plot, the MIP renders of ``--only_prepare_data``
(and the projector's ``mip`` mode), and ``exp_param_decay``."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from nerfca_tpu.data import dataset as jds
from nerfca_tpu.data import phantom as jph
from nerfca_tpu.ops import projector as jproj
from nerfca_tpu.ops.schedules import exp_param_decay as jax_exp_decay
from nerfca_tpu_torch.data import dataset as tds
from nerfca_tpu_torch.ops import projector as tproj
from nerfca_tpu_torch.ops.schedules import exp_param_decay
from nerfca_tpu_torch.train import run_composite
from tests.test_torch_geometry_data import _args, _info


def write_volumes(root, full, dyn):
    """``<root>/<phase>/{full,dyn}_volume_tigre.npy`` for phases 0 and 1."""
    for phase in (0, 1):
        os.makedirs(os.path.join(root, str(phase)), exist_ok=True)
        np.save(os.path.join(root, str(phase), "full_volume_tigre.npy"), full(phase))
        np.save(os.path.join(root, str(phase), "dyn_volume_tigre.npy"), dyn(phase))


def build_both(tmp, **kw):
    args = _args(**kw)
    return (args, jds.build_dataset(args, str(tmp / "jax"), projector_samples=64),
            tds.build_dataset(args, str(tmp / "torch"), projector_samples=64))


def assert_same_npy(jp, tp, rtol=0.0, atol=1e-5):
    names = sorted(f for f in os.listdir(jp.folder) if f.endswith(".npy"))
    assert names == sorted(f for f in os.listdir(tp.folder) if f.endswith(".npy"))
    for name in names:
        a, b = np.load(os.path.join(tp.folder, name)), np.load(os.path.join(jp.folder, name))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
    return names


@pytest.mark.parametrize("kind", ["volumes", "zeros"])
def test_volume_root_builds_equal_to_jax(tmp_path, kind):
    # 16^3 volumes on disk, read ahead of the phantom by both builders: the
    # same artifacts, images within the projector's 1e-5; all-zero volumes
    # give all-zero line integrals, so the phantom was not read
    vols = str(tmp_path / "volumes")
    if kind == "volumes":
        write_volumes(vols, lambda p: 0.5 * jph.synthetic_phantom_volume(16, 0.3 + p / 10),
                      lambda p: np.full((16, 16, 16), 0.02 * (p + 1), np.float32))
    else:
        write_volumes(vols, lambda p: np.zeros((16, 16, 16), np.float32),
                      lambda p: np.zeros((16, 16, 16), np.float32))
    args, jp, tp = build_both(tmp_path, volume_root=vols)
    names = assert_same_npy(jp, tp)
    with open(tp.general) as f, open(jp.general) as g:
        assert json.load(f) == json.load(g)
    dyn = [n for n in names if n.endswith("-dyn.npy")]
    assert dyn
    phantom = tds._default_volume_provider(_args())(0)
    for name in dyn:
        li = np.load(os.path.join(tp.folder, name))
        assert (li == 0).all() == (kind == "zeros")
    if kind == "zeros":
        frames = json.load(open(tp.train))["frames"]
        assert all(f["img_min_max"][0] == f["img_min_max"][1] for f in frames)
        assert np.abs(phantom).max() > 0  # what the build would have read
    else:
        got = tds._default_volume_provider(args)(1)
        np.testing.assert_array_equal(got, np.load(os.path.join(vols, "1",
                                                                "full_volume_tigre.npy")))


def test_volume_root_without_a_phase_falls_back_to_the_phantom(tmp_path):
    # only phase 0 on disk: phase 1 comes from the phantom, in both builders
    vols = str(tmp_path / "volumes")
    os.makedirs(os.path.join(vols, "0"))
    np.save(os.path.join(vols, "0", "full_volume_tigre.npy"), np.zeros((16, 16, 16), np.float32))
    args = _args(volume_root=vols)
    np.testing.assert_array_equal(tds._default_volume_provider(args)(1),
                                  jds._default_volume_provider(args)(1))
    np.testing.assert_array_equal(tds._default_dynamic_provider(args)(1),
                                  jds._default_dynamic_provider(args)(1))
    assert (tds._default_volume_provider(args)(0) == 0).all()


def test_visualize_geometry_writes_the_plot(tmp_path):
    _, jp, tp = build_both(tmp_path, visualize_geometry=True)
    for p in (jp, tp):
        path = os.path.join(p.folder, "geometry.png")
        assert os.path.isfile(path) and os.path.getsize(path) > 1000
    _, _, tp2 = build_both(tmp_path / "off")
    assert not os.path.exists(os.path.join(tp2.folder, "geometry.png"))


@pytest.mark.parametrize("angles", [(0.0, 0.0), (-30.0, 30.0), (60.0, -30.0)])
def test_mip_mode_matches_jax(angles):
    info = _info(50, 16)
    info["nDetector"] = [8, 8]
    info["dDetector"] = [d * 50 / 8 for d in info["dDetector"]]
    vol = jph.synthetic_phantom_volume(16, 0.2)
    a = np.asarray(jproj.project_view(vol, info, *angles, 0.0, n_samples=64, mode="mip"))
    b = tproj.project_view(vol, info, *angles, 0.0, n_samples=64, mode="mip").numpy()
    assert b.shape == (8, 8) and a.max() > 0
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * a.max())
    with pytest.raises(ValueError, match="mode"):
        tproj.project_view(vol, info, *angles, 0.0, n_samples=64, mode="sum")


def test_only_prepare_data_writes_the_jax_mip_renders(tmp_path):
    # run_composite --only_prepare_data writes <id>-mip.npy and .png for the
    # test views, within 1e-5 of their scale of JAX's build with write_mip (both at
    # the builders' 1000 projector samples)
    args = _args()
    jp = jds.build_dataset(args, str(tmp_path / "jax"), write_mip=True)
    assert run_composite.main([
        "--data_name", "SYNTH", "--data_size", "50", "--synth_vol_size", "16",
        "--data_limited_range", "60", "--data_step_size", "120", "--data_numb_angles", "4",
        "--data_time_range_start", "0", "--data_time_range_end", "2",
        "--only_prepare_data", "true", "--platform", "cpu",
        "--data_root", str(tmp_path / "torch")]) is None
    tp = tds.dataset_paths(args, str(tmp_path / "torch"))
    mips = sorted(f for f in os.listdir(tp.folder) if f.endswith("-mip.npy"))
    tests = json.load(open(tp.test))["frames"]
    assert mips == sorted(os.path.basename(f["file_path"]).replace(".npy", "-mip.npy")
                          for f in tests)
    for name in mips:
        assert os.path.isfile(os.path.join(tp.folder, name.replace(".npy", ".png")))
        a, b = np.load(os.path.join(tp.folder, name)), np.load(os.path.join(jp.folder, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max(), err_msg=name)
    # a training build writes none
    tq = tds.build_dataset(_args(), str(tmp_path / "plain"), projector_samples=64)
    assert not any(f.endswith("-mip.npy") for f in os.listdir(tq.folder))


@pytest.mark.parametrize("step,start,end,steps,delay", [
    (5, 1.0, 0.01, 100, 10), (0, 1.0, 0.01, 100, 0), (500, 1.0, 0.01, 100, 0),
    (50, 0.3, 0.3, 100, 0), (50, 1.0, 0.01, 101, 0), (37, 1e-12, 1e-10, 300, 20),
    (99, 1e-8, 1e-4, 100, 0), (10, 0.3, 0.3, 100, 20)])
def test_exp_param_decay_matches_jax(step, start, end, steps, delay):
    want = float(jax_exp_decay(jnp.int32(step), start, end, steps, delay_steps=delay))
    np.testing.assert_allclose(exp_param_decay(step, start, end, steps, delay_steps=delay),
                               want, rtol=1e-6, atol=0)
