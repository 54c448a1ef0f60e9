"""The port's host-side volume pipelines against the JAX package's on the
CPU: the CCTA (MAGIX) preprocessing and its HU surrogate, the XCAT driver
contract with both stand-in generators and an XCAT-SURR dataset built on
its output by both builders, volume I/O, ``read_nrrd`` without SimpleITK,
and the native C++ projector against the port's torch projector and JAX's
binding. Each host pipeline makes the same numpy/scipy calls in
both packages, so their outputs are held bit for bit; the projectors within
the 1e-4 of ``tests/test_native.py``."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import os
import sys

import numpy as np
import pytest
import torch

from nerfca_tpu.data import ccta as jccta
from nerfca_tpu.data import ccta_surrogate as jcs
from nerfca_tpu.data import dataset as jds
from nerfca_tpu.data import native as jnative
from nerfca_tpu.data import volume_io as jvio
from nerfca_tpu.data import xcat as jxcat
from nerfca_tpu.data import xcat_surrogate as jxs
from nerfca_tpu.data.phantom import synthetic_phantom_volume
from nerfca_tpu.geometry.cone import MAX_PIXEL_VALUE
from nerfca_tpu_torch.data import ccta as tccta
from nerfca_tpu_torch.data import ccta_surrogate as tcs
from nerfca_tpu_torch.data import dataset as tds
from nerfca_tpu_torch.data import dxcat_surrogate_bin
from nerfca_tpu_torch.data import native as tnative
from nerfca_tpu_torch.data import volume_io as tvio
from nerfca_tpu_torch.data import xcat as txcat
from nerfca_tpu_torch.data import xcat_surrogate as txs
from nerfca_tpu_torch.ops.projector import project_view
from tests.test_torch_geometry_data import _args, _info, _rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# MAGIX-SURR cut from 256 x 256 x 160 at the same spacing, tall enough to
# hold the aorta's base (z > 20 mm), so the flattening step edits it
SHAPE = (48, 48, 32)
ZOOMED = (48, 48, 51)
SPACING = (1.0, 1.0, 1.6)
XCAT_DIMS = (48, 48, 38)  # XCAT-SURR cut from 512 x 512 x 401
XCAT_DVOXEL = 0.25 * 512 / 48  # the same anatomy on the coarser grid
PAR_TEMPLATE = ("0.0\thrt_start_phase_index (cardiac phase at sim start)\n"
                "0.0\tresp_start_phase_index (respiratory phase at sim start)\n"
                "1\tout_frames (number of output frames)\n")


def assert_same_tree(a, b):
    """Equal file names under two directories and equal bytes in each."""
    names = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for n in names:
        with open(os.path.join(a, n), "rb") as f, open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n
    return names


def image_tolerances(paths, eps=1e-5):
    """Per stored image, the change that line integrals each within ``eps``
    make in it: the image is the log-transmission min-max normalized, so
    its pixel and each end of its range move by ``eps`` over the range."""
    tols = {}
    for name in ("train", "test"):
        with open(getattr(paths, name)) as f:
            for fr in json.load(f)["frames"]:
                lo, hi = fr["img_min_max"]
                tols[os.path.basename(fr["file_path"])] = max(eps, 2 * eps / max(hi - lo, 1e-12))
    return tols


def variance_tolerances(paths, eps=1e-5):
    """Per variance map, the change that line integrals each within ``eps``
    can make in it: the map is the across-phase variance of v = exp(-li),
    min-max normalized, so it moves by up to 2 eps max|v - mean v| over
    the variance's range, and by as much again through each of the range's
    two ends. The line integrals are recovered from the stored images."""
    frames = []
    for name in ("train", "test"):
        with open(getattr(paths, name)) as f:
            frames += json.load(f)["frames"]
    by_map = {}
    for fr in frames:
        lo, hi = fr["img_min_max"]
        img = np.load(fr["file_path"]).astype(np.float64) * (hi - lo) + lo
        by_map.setdefault(os.path.basename(fr["weighted_file_path"]), []).append(
            np.exp(-(np.log(MAX_PIXEL_VALUE) - img)))
    tols = {}
    for name, vs in by_map.items():
        v = np.stack(vs)
        var = v.var(axis=0)
        spread = np.abs(v - v.mean(axis=0)).max()
        tols[name] = 3 * 2 * eps * spread / (var.max() - var.min() + 1e-10) + 1e-6
    return tols


def assert_same_build(jp, tp):
    """Both builders' artifacts: the same names, equal jsons (min/max
    within 1e-5), the dynamic line integrals within the projector's 1e-5,
    and each image and variance map within what that 1e-5 can move it by
    (:func:`image_tolerances`, :func:`variance_tolerances`)."""
    assert sorted(os.listdir(tp.folder)) == sorted(os.listdir(jp.folder))
    for name in ("general", "srcmatrices"):
        with open(getattr(tp, name)) as f, open(getattr(jp, name)) as g:
            assert json.load(f) == json.load(g)
    for name in ("train", "test", "evaluate"):
        with open(getattr(tp, name)) as f, open(getattr(jp, name)) as g:
            tf, jf = json.load(f)["frames"], json.load(g)["frames"]
        assert len(tf) == len(jf) > 0
        for a, b in zip(_rel(tf, tp.folder), _rel(jf, jp.folder)):
            np.testing.assert_allclose(a.pop("img_min_max"), b.pop("img_min_max"), atol=1e-5)
            assert a == b
    names = sorted(f for f in os.listdir(jp.folder) if f.endswith(".npy"))
    tol = {**image_tolerances(jp), **variance_tolerances(jp)}
    for name in names:
        np.testing.assert_allclose(np.load(os.path.join(tp.folder, name)),
                                   np.load(os.path.join(jp.folder, name)), rtol=0,
                                   atol=tol.get(name, 1e-5), err_msg=name)
    return names


def family_args(**kw):
    return _args(**{"data_size": 50, "data_time_range_end": 10, "selection_view": "0,0", **kw})


@pytest.mark.parametrize("phase", [0.0, 0.3])
def test_surrogate_ccta_arrays_equal_jax(phase):
    # bit for bit: the same numpy/scipy calls
    got = tcs.surrogate_ccta_arrays(phase, shape=SHAPE, spacing=SPACING, heart_pulse=0.05)
    want = jcs.surrogate_ccta_arrays(phase, shape=SHAPE, spacing=SPACING, heart_pulse=0.05)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].any() and (got[2] == tccta.TOTAL_LABELS["aorta"]).any()


@pytest.mark.parametrize("return_dyn", [False, True])
def test_preprocess_ccta_volume_equals_jax(return_dyn):
    # HU -> mu, the resample by spacing, aorta flattening, EDT conditioning:
    # bit for bit; the rib factor path too
    raw, lca, seg = jcs.surrogate_ccta_arrays(0.2, shape=SHAPE, spacing=SPACING)
    kw = dict(rib_factor=0.8, return_dyn=return_dyn)
    got = tccta.preprocess_ccta_volume(raw, lca, seg, SPACING, **kw)
    want = jccta.preprocess_ccta_volume(raw, lca, seg, SPACING, **kw)
    for g, w in zip(*((got, want) if return_dyn else ((got,), (want,)))):
        assert g.shape == ZOOMED and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tccta.hounsfield_to_attenuation(raw),
                                  jccta.hounsfield_to_attenuation(raw))


def test_write_surrogate_case_equals_jax_and_workers_write_the_same_bytes(tmp_path):
    # two phases: JAX's files, the port's in one process and the port's in
    # two spawned workers are the same bytes
    kw = dict(phases=2, shape=SHAPE, spacing=SPACING, verbose=False)
    jcs.write_surrogate_case(str(tmp_path / "jax"), **kw)
    tcs.write_surrogate_case(str(tmp_path / "one"), **kw)
    tcs.write_surrogate_case(str(tmp_path / "two"), workers=2, **kw)
    names = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "one"))
    assert assert_same_tree(str(tmp_path / "one"), str(tmp_path / "two")) == names
    assert len(names) == 10
    dyn = np.load(tmp_path / "one" / "1" / "dyn_volume_tigre.npy")
    assert dyn.shape == ZOOMED and (dyn > 0).any()


def test_read_nrrd_raises_import_error_without_simpleitk(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "SimpleITK", None)
    with pytest.raises(ImportError, match="SimpleITK"):
        tccta.read_nrrd("absent.nrrd")
    with pytest.raises(ImportError, match="SimpleITK"):
        tccta.preprocess_ccta("raw", "seg", str(tmp_path / "out"), "case", volume_ids=[0])


def test_volume_io_round_trips_and_writes_jax_bytes(tmp_path):
    vol = np.random.default_rng(0).normal(size=(5, 4, 3)).astype(np.float32)
    spacing, origin = (0.5, 1.0, 2.0), (1.0, -2.0, 3.0)
    tvio.save_vtk(str(tmp_path / "t.vtk"), vol, spacing, origin)
    jvio.save_vtk(str(tmp_path / "j.vtk"), vol, spacing, origin)
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path / "j.vtk").read_bytes()
    back, meta = tvio.read_vtk(str(tmp_path / "t.vtk"))
    np.testing.assert_array_equal(back, vol)
    assert meta == {"dimensions": [5, 4, 3], "spacing": list(spacing), "origin": list(origin)}
    np.save(tmp_path / "flat.npy", vol.flatten())
    np.testing.assert_array_equal(tvio.load_volume("flat.npy", vol.shape, str(tmp_path)), vol)
    for img in (vol, np.full((3, 3), 2.0, np.float32)):
        got, want = tvio.normalize(img), jvio.normalize(img)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


@pytest.mark.parametrize("with_arteries", [True, False])
def test_xcat_write_bin_equals_jax(tmp_path, with_arteries):
    # byte for byte at reduced dims; the noarteries run is bitwise the
    # background, the other differs from it only in the vessel
    for pkg, mod in (("jax", jxs), ("torch", txs)):
        mod.write_bin(str(tmp_path / pkg), 0.4, with_arteries, str(tmp_path / f"bg-{pkg}.raw"),
                      dims=XCAT_DIMS, d_voxel_mm=XCAT_DVOXEL)
    got = (tmp_path / "torch_atn_1.bin").read_bytes()
    assert got == (tmp_path / "jax_atn_1.bin").read_bytes()
    assert (tmp_path / "bg-torch.raw").read_bytes() == (tmp_path / "bg-jax.raw").read_bytes()
    vol = np.frombuffer(got, np.float32).reshape(XCAT_DIMS)
    bg = np.fromfile(tmp_path / "bg-torch.raw", np.float32).reshape(XCAT_DIMS)
    moved = vol != bg
    assert moved.any() == with_arteries
    assert (vol[moved] == txs.VAL_VESSEL_RAW).all()


def install_jax_stand_in(xcat_path):
    os.makedirs(xcat_path, exist_ok=True)
    dst = os.path.join(xcat_path, "dxcat1_bin")
    with open(os.path.join(REPO, "scripts", "dxcat_surrogate_bin.py")) as f, open(dst, "w") as g:
        g.write(f.read())
    os.chmod(dst, 0o755)


def run_xcat_driver(xcat_path, install, driver, phases=(0.0, 0.5), dims=XCAT_DIMS):
    """The XCAT driver contract through a stand-in generator installed as
    ``<xcat_path>/dxcat1_bin`` (which reads its dims from the environment):
    each phase's registry entry."""
    install(xcat_path)
    for name in ("volume", "noarteries"):
        with open(os.path.join(xcat_path, f"{name}.samp.par"), "w") as f:
            f.write(PAR_TEMPLATE)
    return [driver.prepare_and_run_xcat(p, 0.0, xcat_path, dimensions=dims) for p in phases]


def test_prepare_and_run_xcat_equals_jax(tmp_path, monkeypatch):
    # the port's driver through the port's stand-in, JAX's driver through
    # scripts/dxcat_surrogate_bin.py: equal registries, equal npys, the
    # bins and the cached background byte for byte
    monkeypatch.setenv("NERFCA_REPO", REPO)
    monkeypatch.setenv("XCAT_SURR_DIMS", ",".join(map(str, XCAT_DIMS)))
    monkeypatch.setenv("XCAT_SURR_DVOXEL", str(XCAT_DVOXEL))
    t_path, j_path = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = run_xcat_driver(t_path, dxcat_surrogate_bin.install, txcat)
    want = run_xcat_driver(j_path, install_jax_stand_in, jxcat)
    assert got == want and [o["id"] for o in got] == [0, 1]
    os.remove(os.path.join(t_path, "dxcat1_bin"))
    os.remove(os.path.join(j_path, "dxcat1_bin"))
    assert_same_tree(t_path, j_path)  # phases.json, par files, bins, npys
    for run in ("0", "1"):
        dyn = np.load(os.path.join(t_path, run, "dyn_volume_tigre.npy"))
        assert dyn.shape == XCAT_DIMS and (dyn == 0.15).any()
    # a phase already in the registry keeps its id and its bins are reused
    again = txcat.prepare_and_run_xcat(0.5, 0.0, t_path, dimensions=XCAT_DIMS)
    assert again == got[1]


def test_xcat_surrogate_dataset_equals_jax(tmp_path, monkeypatch):
    # the XCAT driver through the port's stand-in, phases 0 and 1 (ids 0
    # and 1 in the registry), then both builders on them. The XCAT preset
    # images a region ~30 mm off the volume's center at 0.25 mm a voxel, so
    # the grid is cut to 256 x 256 x 200 (64 mm), not to XCAT_DIMS, which
    # the detector would not see
    dims = (256, 256, 200)
    monkeypatch.setenv("NERFCA_REPO", REPO)
    monkeypatch.setenv("XCAT_SURR_DIMS", ",".join(map(str, dims)))
    monkeypatch.setenv("XCAT_SURR_DVOXEL", str(0.25 * 512 / 256))
    xcat_path = str(tmp_path / "xcat")
    run_xcat_driver(xcat_path, dxcat_surrogate_bin.install, txcat, phases=(0.0, 0.1), dims=dims)
    args = family_args(data_name="XCAT-SURR", volume_root=xcat_path, data_time_range_end=2)
    jp = jds.build_dataset(args, str(tmp_path / "jax"), projector_samples=64)
    tp = tds.build_dataset(args, str(tmp_path / "torch"), projector_samples=64)
    names = assert_same_build(jp, tp)
    assert not any(n.endswith("-var.npy") for n in names)  # fewer than 10 phases
    dyn = [n for n in names if n.endswith("-dyn.npy")]
    assert len(dyn) == 2 * 5 and all(np.load(os.path.join(tp.folder, n)).max() > 0 for n in dyn)
    with open(tp.test) as f:
        assert all(hi > lo for lo, hi in (fr["img_min_max"] for fr in json.load(f)["frames"]))
    with open(tp.general) as f:
        info = json.load(f)
    assert info["offOrigin"] == [0.1, -0.25, 0.25] and info["DSO"] == 4.5


def test_xcat_driver_contract_pieces_equal_jax(tmp_path):
    src = tmp_path / "in.par"
    src.write_text(PAR_TEMPLATE)
    over = {"hrt_start_phase_index": 0.3, "resp_start_phase_index": 0.5}
    txcat.override_param_file(str(src), str(tmp_path / "t.par"), over)
    jxcat.override_param_file(str(src), str(tmp_path / "j.par"), over)
    assert (tmp_path / "t.par").read_text() == (tmp_path / "j.par").read_text()
    with pytest.raises(KeyError):
        txcat.override_param_file(str(src), str(tmp_path / "x.par"), {"absent": 1})
    with pytest.raises(FileNotFoundError):
        txcat.run_xcat_binary(str(tmp_path), "in.par", "out")
    reg = [{"id": 0, "hrt_phase": 0.1, "resp_phase": 0.0}]
    for h in (0.1, 0.10000001, 0.2):
        assert txcat.find_phase_id(reg, h, 0.0) == jxcat.find_phase_id(reg, h, 0.0)
    rng = np.random.default_rng(1)
    full = rng.random((30, 28, 24), np.float32)
    art = np.where(rng.random(full.shape) > 0.9, 0.3, 0.0).astype(np.float32)
    bounds = txcat.LCA_BOUNDS * (np.array([30, 28, 24]) / np.array(txcat.XCAT_DIMENSIONS))[:, None]
    for g, w in zip(txcat.extract_lca(full, art, 0.15, bounds),
                    jxcat.extract_lca(full, art, 0.15, bounds)):
        np.testing.assert_array_equal(g, w)
    lca = txcat.extract_lca(full, art, 0.15, bounds)[1]
    assert txcat.lca_bounding_box_center(lca) == jxcat.lca_bounding_box_center(lca)
    np.testing.assert_array_equal(txcat.extract_artery_volume(full, art),
                                  jxcat.extract_artery_volume(full, art))


@pytest.mark.skipif(not tnative.is_available(), reason="no C++ compiler for the native projector")
@pytest.mark.parametrize("mode", ["ct", "mip"])
def test_native_projector_matches_torch_and_jax(mode):
    # the C++ projector against the port's torch projector on the CPU and
    # against JAX's binding of the same source, atol 1e-4
    vol = synthetic_phantom_volume(size=24, phase=0.4)
    info = _info(50, 24)
    for theta, phi in [(-30.0, 30.0), (0.0, 0.0), (60.0, -30.0)]:
        got = tnative.native_project_view(vol, info, theta, phi, n_samples=96, mode=mode)
        ref = project_view(torch.from_numpy(vol), info, theta, phi, n_samples=96,
                           mode=mode).numpy()
        assert got.shape == (50, 50) and np.abs(got).max() > 0
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=f"{mode} {theta},{phi}")
        if jnative.is_available():
            np.testing.assert_allclose(
                got, jnative.native_project_view(vol, info, theta, phi, n_samples=96, mode=mode),
                atol=1e-4)


def test_native_build_leaves_the_tracked_library_alone():
    # the port builds under build/native/, never in native/
    tracked = os.path.join(REPO, "native", "libcone_projector.so")
    before = os.path.getmtime(tracked) if os.path.exists(tracked) else None
    tnative.is_available()
    assert (os.path.getmtime(tracked) if os.path.exists(tracked) else None) == before
    assert tnative.library_path().parent == tnative.REPO / "build" / "native"


@pytest.mark.skipif(not tnative.is_available(), reason="no C++ compiler for the native projector")
@pytest.mark.parametrize("n", [64, 256])
def test_native_projector_on_the_far_face_reads_the_zeroed_tail(n):
    # a sample on x = n - 1 exactly (the C source reads the +1 corner with
    # weight 0 there): the binding's zeroed tail keeps the value exact,
    # the trilinear value of a unit volume times the depth step
    vol = np.ones((n, 4, 4), np.float32)
    origins = np.array([[(n - 1) / 2, 0.0, 0.0]], np.float32)
    dirs = np.array([[1.0, 0.0, 0.0]], np.float32)
    out = tnative.project_rays(vol, origins, dirs, np.array([0.0, 1.0], np.float32),
                               (1.0, 1.0, 1.0), (0.0, 0.0, 0.0))
    assert out.tolist() == [1.0]
    assert tnative.padded_volume(vol).size == vol.size + 4 * 4 + 4 + 1
