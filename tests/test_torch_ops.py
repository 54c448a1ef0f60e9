"""The torch port's encodings, schedules, sampling, rendering and losses
against the JAX package on the same numpy inputs (CPU)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.ops import encoding as jenc
from nerfca_tpu.ops import losses as jlo
from nerfca_tpu.ops import render as jre
from nerfca_tpu.ops import sampling as jsa
from nerfca_tpu.ops import schedules as jsc
from nerfca_tpu_torch.ops import encoding as tenc
from nerfca_tpu_torch.ops import losses as tlo
from nerfca_tpu_torch.ops import render as tre
from nerfca_tpu_torch.ops import sampling as tsa
from nerfca_tpu_torch.ops import schedules as tsc

RNG = np.random.default_rng(0)


def t(a):
    return torch.tensor(np.asarray(a))


def close(a, b, atol=1e-6, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("step", [0, 37, 99, 100, 250])
@pytest.mark.parametrize("window_max", [0.0, 2.5])
def test_free_window(step, window_max):
    # same f32 formula on both sides: 1e-6
    m_j = jenc.free_window_mask(4, step, 100, 1, window_max)
    m_t = tenc.free_window_mask(4, step, 100, 1, window_max)
    close(m_t, m_j)
    close(tenc.free_window_alpha(4, step, 100, 1, window_max),
          jenc.free_window_alpha(4, step, 100, 1, window_max))


@pytest.mark.parametrize("alpha", [0.0, 1.3, 3.9, 10.0])
def test_nerfies_window(alpha):
    close(tenc.nerfies_window(4, alpha), jenc.nerfies_window(4, alpha))
    assert tenc.nerfies_alpha(4, 30, 100) == jenc.nerfies_alpha(4, 30, 100)


@pytest.mark.parametrize("mode,basis", [("none", 0), ("free_windowed", 4),
                                        ("nerfies_windowed", 3), ("free_windowed", 12)])
def test_posenc_matches(mode, basis):
    # the top band at basis 12 is sin(2^11 x): both take the same f32
    # argument, so only the libraries' sin rounding differs (1e-6)
    x = RNG.uniform(-1.2, 1.2, (5, 7, 3)).astype(np.float32)
    window = None if basis == 0 else np.asarray(jenc.free_window_mask(basis, 30, 100, 1))
    a = jenc.posenc(jnp.asarray(x), mode, basis,
                    window=None if window is None else jnp.asarray(window))
    b = tenc.posenc(t(x), mode, basis, window=None if window is None else t(window))
    assert b.shape == a.shape
    close(b, a)
    assert tenc.encoded_feature_count(mode, basis) == jenc.encoded_feature_count(mode, basis)


@pytest.mark.parametrize("step", [0, 10, 40, 150, 1000])
def test_linear_param_decay(step):
    # both evaluate in f32: rel 1e-6
    for args in ((1e-12, 1e-10, 100, 40), (1e-8, 1e-4, 100, 0), (1e-8, 1e-15, 300, 0)):
        close(tsc.linear_param_decay(step, *args),
              jsc.linear_param_decay(jnp.float32(step), *(jnp.float32(a) for a in args)),
              atol=0, rtol=1e-6)


def test_linspace_and_stratify_with_injected_uniforms():
    # the JAX draw is fed to the port as injected uniforms: 1e-6
    z_j = jsa.linspace_depths(3.6, 5.4, 64)
    z_t = tsa.linspace_depths(3.6, 5.4, 64)
    close(z_t, z_j)
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, z_j.shape, dtype=z_j.dtype)
    close(tsa.stratify_depths(t(z_j), t_rand=t(u)), jsa.stratify_depths(key, z_j))
    # per-ray depths take the same path
    zz = jnp.broadcast_to(z_j, (3, 64))
    u2 = jax.random.uniform(key, zz.shape, dtype=zz.dtype)
    close(tsa.stratify_depths(t(zz), t_rand=t(u2)), jsa.stratify_depths(key, zz))


@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
def test_renderers_match(act):
    # 1e-6 on log intensities around 2.2
    raw_s = RNG.normal(0, 3, (6, 40, 1)).astype(np.float32)
    raw_t = RNG.normal(0, 3, (6, 40, 1)).astype(np.float32)
    i0 = np.full((6,), 2.16, np.float32)
    z = np.sort(RNG.uniform(3.6, 5.4, 40)).astype(np.float32)
    a = jre.render_transmission_composite(jnp.asarray(raw_s), jnp.asarray(raw_t),
                                          jnp.asarray(i0), jnp.asarray(z), act)
    b = tre.render_transmission_composite(t(raw_s), t(raw_t), t(i0), t(z), act)
    for x, y in zip(b, a):
        close(x, y)
    a = jre.render_transmission(jnp.asarray(raw_s), jnp.asarray(i0), jnp.asarray(z), act)
    b = tre.render_transmission(t(raw_s), t(i0), t(z), act)
    for x, y in zip(b, a):
        close(x, y)


def test_softplus_matches_above_threshold():
    # torch's F.softplus returns x above 20; the port keeps log(1+e^x)
    x = np.array([-50, -5, 0, 5, 19.9, 20.1, 25, 40, 90], np.float32)
    close(tre.softplus(t(x)), jax.nn.softplus(jnp.asarray(x)), atol=0, rtol=1e-7)


def _sigmas(r=8, s=48, zero_rays=()):
    sig_s = (np.log1p(np.exp(RNG.normal(0, 2, (r, s)))) * 1e-2).astype(np.float32)
    sig_d = (np.log1p(np.exp(RNG.normal(-1, 2, (r, s)))) * 1e-2).astype(np.float32)
    for i in zero_rays:
        sig_d[i] = 0.0
    dists = np.concatenate([np.diff(np.linspace(3.6, 5.4, s)), [1e-10]]).astype(np.float32)
    w = np.where(RNG.random(r) > 0.5, 1.5, 1.0).astype(np.float32)
    return sig_s, sig_d, dists, w


def test_individual_losses_match():
    # f32 sums in different orders: rel 1e-5
    sig_s, sig_d, dists, w = _sigmas()
    rel = dict(atol=0, rtol=1e-5)
    bt, bj = tlo.blend_ratio(t(sig_s), t(sig_d)), jlo.blend_ratio(jnp.asarray(sig_s),
                                                                  jnp.asarray(sig_d))
    for x, y in zip(bt, bj):
        close(x, y, **rel)
    for skew in (1.0, 1.5):
        close(tlo.blendw_entropy_loss(bt[0], skew), jlo.blendw_entropy_loss(bj[0], skew), **rel)
    for kw in (dict(mask_threshold=0.1), dict(mask_threshold=1e-4, use_weighting=True,
                                              weighted_thresh=0.03)):
        a = tlo.ray_entropy_loss(t(sig_d), t(dists), weighted_pixs=t(w), **kw)
        b = jlo.ray_entropy_loss(jnp.asarray(sig_d), jnp.asarray(dists),
                                 weighted_pixs=jnp.asarray(w), **kw)
        for x, y in zip(a, b):
            close(x, y, **rel)
    for kw in (dict(), dict(use_back=True), dict(front_only=True)):
        close(tlo.occlusion_loss(t(sig_d), t(dists), 0.2, **kw),
              jlo.occlusion_loss(jnp.asarray(sig_d), jnp.asarray(dists), 0.2, **kw), **rel)
    close(tlo.weighted_mse(t(sig_s), t(sig_d), t(w[:, None])),
          jlo.weighted_mse(jnp.asarray(sig_s), jnp.asarray(sig_d), jnp.asarray(w[:, None])),
          **rel)


@pytest.mark.parametrize("front_only", [False, True])
def test_composite_losses_match(front_only):
    # rel 1e-5 on every term (the entropy terms are sums of p log p over 48
    # samples and stay inside it at these sizes)
    sig_s, sig_d, dists, w = _sigmas(zero_rays=(2,))
    kw = dict(skewness_val=1.0, entro_mask_thre=1e-4, entro_use_weighting=True,
              entro_weighted_thresh=0.03, occl_reg_perc=0.2, occl_front_only=front_only)
    a = tlo.composite_losses(t(sig_s), t(sig_d), t(dists), t(w), **kw)
    b = jlo.composite_losses(jnp.asarray(sig_s), jnp.asarray(sig_d), jnp.asarray(dists),
                             jnp.asarray(w), **kw)
    assert a._fields == b._fields
    for name in a._fields:
        close(getattr(a, name), getattr(b, name), atol=0, rtol=1e-5)


def test_ray_entropy_zero_ray_grad_finite():
    # mirrors tests/test_losses.py::test_ray_entropy_zero_ray_grad_finite:
    # an all-zero ray kept by the variance mask must not NaN the gradient
    sig = torch.zeros((3, 16))
    sig[1] = torch.rand(16) * 1e-2
    sig.requires_grad_(True)
    dists = torch.full((16,), 0.1)
    loss, _ = tlo.ray_entropy_loss(sig, dists, mask_threshold=1e-4, use_weighting=True,
                                   weighted_pixs=torch.tensor([2.0, 1.0, 2.0]),
                                   weighted_thresh=0.03)
    (g,) = torch.autograd.grad(loss, sig)
    assert torch.isfinite(loss) and torch.isfinite(g).all()
    # the JAX gradient on the same input agrees (rel 1e-4: 1/clip-scale terms)
    gj = jax.grad(lambda s: jlo.ray_entropy_loss(
        s, jnp.asarray(dists.numpy()), mask_threshold=1e-4, use_weighting=True,
        weighted_pixs=jnp.asarray([2.0, 1.0, 2.0]), weighted_thresh=0.03)[0])(
        jnp.asarray(sig.detach().numpy()))
    close(g, gj, atol=1e-6, rtol=1e-4)


def test_clip_ties_take_jax_gradient():
    # jnp.clip passes half the gradient when the value sits on a bound;
    # torch.clamp passes all of it. 1 - 1e-19 == 1.0 in f32, so a blend
    # ratio of exactly 1.0 is such a tie: the first static sigma's favor_s
    # gradient is 16.67 in JAX, and was 33.33 with torch.clamp (rel 1e-5)
    s = np.array([1e-12, 3e-3, 1e-12], np.float32)
    d = np.array([1e-2, 2e-3, 1e-3], np.float32)
    gj = jax.grad(lambda a: jlo.blendw_entropy_loss(jlo.blend_ratio(a, jnp.asarray(d))[0]))(
        jnp.asarray(s))
    st = t(s).requires_grad_(True)
    (gt,) = torch.autograd.grad(tlo.blendw_entropy_loss(tlo.blend_ratio(st, t(d))[0]), st)
    close(gt, gj, atol=0, rtol=1e-5)
    np.testing.assert_allclose(float(gt[0]), 16.666668, rtol=1e-5)
    # the ray-entropy denominator clip, with the ray sum exactly on it
    for sig, dists, clip_thr in ((s[None], d, 1e-19),
                                 (np.full((1, 2), 0.25, np.float32), np.ones(2, np.float32), 0.5)):
        gj = jax.grad(lambda a: jlo.ray_entropy_loss(a, jnp.asarray(dists), mask_threshold=0.0,
                                                     clip_threshold=clip_thr)[0])(
            jnp.asarray(sig))
        st = t(sig).requires_grad_(True)
        (gt,) = torch.autograd.grad(
            tlo.ray_entropy_loss(st, t(dists), mask_threshold=0.0, clip_threshold=clip_thr)[0], st)
        close(gt, gj, atol=1e-12, rtol=1e-5)
