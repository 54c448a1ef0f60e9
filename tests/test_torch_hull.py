"""The torch port's motion hull (``ops/hull.py``) and the gated renderers
against the JAX package on the same numpy inputs (CPU)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.geometry.cone import ConeGeometry, synth_geometry
from nerfca_tpu.geometry.rays import detector_rays
from nerfca_tpu.ops import hull as jh
from nerfca_tpu.ops import render as jre
from nerfca_tpu_torch.ops import hull as th
from nerfca_tpu_torch.ops import render as tre

RES = 12


def hulls(seed=0, res=RES, d=0.25, off=(0.0, 0.1, -0.1)):
    grid = np.random.default_rng(seed).random((res, res, res)).astype(np.float32)
    j = jh.MotionHull(jnp.asarray(grid), jnp.full((3,), d, jnp.float32),
                      jnp.asarray(off, jnp.float32))
    t = th.MotionHull(torch.tensor(grid), torch.full((3,), d), torch.tensor(off))
    return j, t


def world(hull, axis, g):
    """World coordinate (f32) that maps to grid coordinate ``g``."""
    res = hull.grid.shape[axis]
    return np.float32((g - (res - 1) / 2) * float(hull.d_voxel[axis]) + float(hull.off[axis]))


def test_gate_inside_far_face_and_outside():
    # same f32 arithmetic on both sides: 1e-6. Points exactly on the far
    # face base their cell at res-2 (no NaN, no read past the grid); points
    # past it and far outside gate to 0
    jhull, thull = hulls()
    rng = np.random.default_rng(1)
    pts = [rng.uniform(-1.3, 1.3, (3, 50)).astype(np.float32) + np.float32([[0], [0.1], [-0.1]])]
    face = np.stack([[world(thull, 0, RES - 1), world(thull, 0, 0.0), world(thull, 0, RES - 1)],
                     [world(thull, 1, 4.5), world(thull, 1, RES - 1), world(thull, 1, RES - 1)],
                     [world(thull, 2, 2.25), world(thull, 2, 7.0), world(thull, 2, RES - 1)]])
    past = np.float32([[world(thull, 0, RES - 1 + 1e-2), 10.0], [0.1, -10.0], [-0.1, 3.0]])
    pts = np.concatenate(pts + [face, past], axis=1)
    a = np.asarray(jh.hull_gate(jhull, *(jnp.asarray(p) for p in pts)))
    b = th.hull_gate(thull, *(torch.tensor(p) for p in pts)).numpy()
    assert np.isfinite(b).all() and np.isfinite(a).all()
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    np.testing.assert_allclose(b[-3], np.asarray(jhull.grid)[-1, -1, -1], atol=1e-6)  # corner
    assert (b[-2:] == 0).all()


@pytest.mark.parametrize("per_ray", [False, True])
def test_gate_rays_shared_and_per_ray_depths(per_ray):
    jhull, thull = hulls(seed=3)
    rng = np.random.default_rng(4)
    o = rng.normal(0, 0.3, (5, 3)).astype(np.float32)
    d = rng.normal(0, 0.2, (5, 3)).astype(np.float32)
    z = np.sort(rng.uniform(0.0, 1.5, (5, 7) if per_ray else (7,)), axis=-1).astype(np.float32)
    a = np.asarray(jh.hull_gate_rays(jhull, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z)))
    b = th.hull_gate_rays(thull, torch.tensor(o), torch.tensor(d), torch.tensor(z)).numpy()
    assert b.shape == (5, 7)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_project_to_pixels_matches():
    info = ConeGeometry.from_dict(synth_geometry(50, [32, 32, 32])).to_info_dict()
    pts = np.random.default_rng(5).uniform(-0.15, 0.15, (64, 3))
    for theta, phi, larm in [(0.0, 0.0, 0.0), (-30.0, 25.0, 0.0), (90.0, 0.0, 5.0)]:
        for x, y in zip(th._project_to_pixels(pts, theta, phi, larm, info),
                        jh._project_to_pixels(pts, theta, phi, larm, info)):
            np.testing.assert_allclose(x, y, atol=1e-9, rtol=0)


def _ball_frames(tmp_path, info):
    """Variance maps of a moving ball: a pixel's variance ramps from 1 where
    its ray passes within 0.02 of the ball centre to 0 beyond 0.06 (stored
    as var + 1, transposed, as the dataset writes them)."""
    p0 = np.array([0.08, -0.06, 0.05])
    w, h = (int(x) for x in info["nDetector"])
    frames = []
    for i, (theta, phi) in enumerate([(0.0, 0.0), (40.0, 0.0), (-40.0, 10.0), (90.0, 0.0)]):
        o, d = (np.asarray(a).reshape(-1, 3) for a in detector_rays(theta, phi, 0.0, info))
        dn = d / np.linalg.norm(d, axis=1, keepdims=True)
        rel = p0[None, :] - o
        dist = np.linalg.norm(rel - (rel * dn).sum(1, keepdims=True) * dn, axis=1)
        moving = np.clip(1.5 - dist / 0.04, 0.0, 1.0).reshape(w, h)
        path = tmp_path / f"w{i}.npy"
        np.save(path, moving.T.reshape(-1) + 1.0)
        frames.append({"theta": theta, "phi": phi, "larm": 0.0, "weighted_file_path": str(path)})
    return frames


@pytest.mark.parametrize("kw", [dict(res=20, thresh=0.3, dilate=1, sigma=0.5),
                                dict(res=16, thresh=0.05, dilate=0, sigma=0.0)])
def test_build_motion_hull_matches(tmp_path, kw):
    # the same numpy carving on both sides; grids within 1e-6
    info = ConeGeometry.from_dict(synth_geometry(50, [32, 32, 32])).to_info_dict()
    frames = _ball_frames(tmp_path, info)
    a = jh.build_motion_hull(frames, info, **kw)
    b = th.build_motion_hull(frames, info, **kw)
    assert a is not None and b is not None
    assert 0.0 < float((b.grid > 0.5).float().mean()) < 0.5
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6, rtol=0)
    # a missing map means nothing to carve; a rectangular detector is refused
    frames[1]["weighted_file_path"] = str(tmp_path / "missing.npy")
    assert th.build_motion_hull(frames, info, **kw) is None
    with pytest.raises(AssertionError, match="square"):
        th.build_motion_hull(frames, dict(info, nDetector=[50, 20]), **kw)


def test_hull_from_args_and_record():
    args = SimpleNamespace(use_motion_hull=False, hull_res=8, hull_thresh=0.1, hull_dilate=0,
                           hull_sigma=0.0)
    assert th.hull_from_args(args, [], {}) is None
    assert th.HULL_ARG_DEFAULTS == jh.HULL_ARG_DEFAULTS
    trained = SimpleNamespace(use_motion_hull=True, hull_res=64, hull_thresh=0.05,
                              hull_dilate=1, hull_sigma=0.0)
    rec = th.hull_args_record(trained)
    assert rec == jh.hull_args_record(trained)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        th.apply_hull_args_record(args, rec)
    assert any("use_motion_hull" in str(w.message) for w in caught)
    assert vars(args) == rec


@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
def test_gated_renderers_match(act):
    # 1e-6 on log intensities and sigmas
    rng = np.random.default_rng(6)
    raw_s = rng.normal(0, 3, (6, 40, 1)).astype(np.float32)
    raw_t = rng.normal(0, 3, (6, 40, 1)).astype(np.float32)
    gate = rng.random((6, 40)).astype(np.float32)
    gate[2] = 0.0
    i0 = np.full((6,), 2.16, np.float32)
    z = np.sort(rng.uniform(3.6, 5.4, 40)).astype(np.float32)
    j = [jnp.asarray(x) for x in (raw_s, raw_t, i0, z, gate)]
    t = [torch.tensor(x) for x in (raw_s, raw_t, i0, z, gate)]
    a = jre.render_transmission_composite(*j[:4], act, temp_gate=j[4])
    b = tre.render_transmission_composite(*t[:4], act, temp_gate=t[4])
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6, rtol=0)
    a = jre.render_transmission(j[1], j[2], j[3], act, gate=j[4])
    b = tre.render_transmission(t[1], t[2], t[3], act, gate=t[4])
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6, rtol=0)
