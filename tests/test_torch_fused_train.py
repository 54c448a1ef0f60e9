"""The fused-loss step K3 of the torch port: its plain version against the
JAX kernel ``fused_train_loss_and_grads`` (Pallas in interpret mode) on the
same numpy inputs, and the hand-derived loss cotangents against
``torch.autograd`` of the plain loss. The CUDA kernel itself is checked
against the plain version on the card by ``tests/test_torch_gpu.py``."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu.ops.hull import MotionHull as JHull
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads as jax_k3
from nerfca_tpu.ops.pallas.fused_train import fused_train_supported as jax_supported
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import losses as tlo
from nerfca_tpu_torch.ops.cuda import fused_train as tk3
from nerfca_tpu_torch.ops.hull import MotionHull as THull
from nerfca_tpu_torch.ops.render import output_activation, render_transmission_composite
from nerfca_tpu_torch.train import step as ts

R, S = 4, 37
ENTROPY_TERMS = {"favor_s", "s_entropy", "d_entropy"}
HP = dict(img_sample_size=R, depth_samples_coarse=S, favor_s_weight_start=1e-3,
          favor_s_weight_end=1e-3, dynamic_entro_weight_start=1e-4, dynamic_entro_weight_end=1e-4,
          occl_weight_start=1e-4, occl_weight_end=1e-4, l1_weight_start=1e-6,
          l1_weight_end=1e-6, hyperparam_decay_steps=100, entro_mask_thre=1e-3,
          entro_use_weighting=True, entro_weighted_thresh=0.25, occl_reg_perc=0.2,
          use_pallas=True, use_fused_loss=True)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def cfg_pair(mod):
    kw = dict(num_early_layers=2, num_filters=128, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def problem(seed=0):
    """Numpy inputs: the JAX field init, rays through the origin along -x
    (the hull grids below cover them), weights on both sides of the mask."""
    cs, ct = cfg_pair(jf)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), cs))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), ct))
    rng = np.random.default_rng(seed)
    batch = {
        "origins": np.tile(np.array([[4.5, 0.0, 0.0]], np.float32), (R, 1)),
        "directions": (rng.normal(0, 0.02, (R, 3)) + [-1.0, 0.0, 0.0]).astype(np.float32),
        "phases": rng.integers(0, 10, R).astype(np.int32),
        "pixels": (2.1 + 0.05 * rng.random(R)).astype(np.float32),
        "weights": np.array([1.0, 1.6, 1.1, 2.0], np.float32),
        "initial_intensities": np.full(R, 2.16, np.float32),
    }
    z = np.linspace(3.6, 5.4, S).astype(np.float32)
    return ps, pt, batch, z


def hull_grid(kind):
    if kind == "zero":  # gates every dynamic sample to exactly 0
        return np.zeros((8, 8, 8), np.float32), 2.0
    return (0.2 + 0.8 * np.random.default_rng(9).random((6, 6, 6))).astype(np.float32), 0.5


def run_both(hp_kw=None, total_rays=None, hull=None, step=57):
    ps, pt, b, z = problem()
    hp_kw = dict(HP, **(hp_kw or {}))
    jhp, thp = js.CompositeHParams(**hp_kw), ts.CompositeHParams(**hp_kw)
    w = js.loss_weights(jnp.int32(step), jhp)
    names = ["favor_s", "dynamic_entro", "occl", "l1"] + (["hull_static_l1"] if hull else [])
    lw = np.array([float(w[k]) for k in names], np.float32)
    window = np.asarray(free_window_mask(4, step, 100, 1))
    jh = th = None
    if hull is not None:
        grid, dv = hull_grid(hull)
        jh = JHull(jnp.asarray(grid), jnp.full((3,), dv, jnp.float32), jnp.zeros(3, jnp.float32))
        th = THull(torch.tensor(grid), torch.full((3,), dv), torch.zeros(3))
    cs, ct = cfg_pair(jf)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jout = jax_k3(ps, pt, jb["origins"], jb["directions"], jnp.asarray(z), jb["phases"],
                  jb["pixels"], jb["weights"], jb["initial_intensities"], cs, ct,
                  jnp.asarray(window), jnp.asarray(window), jnp.asarray(lw), jhp,
                  total_rays=total_rays, hull=jh)
    cs, ct = cfg_pair(tf)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tout = tk3.fused_train_loss_and_grads(
        tf.params_from_jax(ps), tf.params_from_jax(pt), tb["origins"], tb["directions"],
        torch.tensor(z), tb["phases"], tb["pixels"], tb["weights"], tb["initial_intensities"],
        cs, ct, torch.tensor(window), torch.tensor(window), torch.tensor(lw), thp,
        total_rays=total_rays, hull=th)
    return jout, tout


def assert_match(jout, tout):
    # loss rel 1e-5; terms rel 2e-5, 1e-4 on the entropy terms (sums of
    # p log p whose log amplifies last-bit differences of p); grads per leaf
    # within 1e-3 of the leaf's scale (the JAX kernel's interpret mode uses
    # a double-angle encoding, tests/test_torch_step.py)
    (jl, jt, jgs, jgt), (tl, tt, tgs, tgt) = jout, tout
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    assert set(tt) == set(jt)
    for k in jt:
        rtol = 1e-4 if k in ENTROPY_TERMS else 2e-5
        np.testing.assert_allclose(float(tt[k]), float(jt[k]), rtol=rtol, atol=1e-12, err_msg=k)
    for jg, tg in ((jgs, tgs), (jgt, tgt)):
        got = tf.params_to_jax(tg)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jg)
        for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                jax.tree_util.tree_leaves(got)):
            b = np.asarray(b)
            assert np.isfinite(a).all(), path
            assert np.abs(a - b).max() <= 1e-3 * max(np.abs(b).max(), 1e-30), path


@pytest.mark.parametrize("case", [
    dict(hp_kw=dict(output_activation="softplus")),
    dict(hp_kw=dict(output_activation="sigmoid")),
    dict(hp_kw=dict(output_activation="clamp")),
    dict(hp_kw=dict(entro_use_weighting=False)),
    dict(hp_kw=dict(occl_front_only=True)),
    dict(total_rays=10),
    dict(hp_kw=dict(hull_static_l1_weight_start=1e-3, hull_static_l1_weight_end=1e-3),
         hull="random"),
    dict(hull="zero"),
], ids=["softplus", "sigmoid", "clamp", "no_weighting", "occl_front_only", "total_rays",
        "hull_static_l1", "zero_hull"])
def test_plain_matches_jax_kernel(case):
    jout, tout = run_both(**case)
    assert_match(jout, tout)
    if case.get("hull") == "zero":
        # every dynamic sample gated to 0: its entropy is exactly 0
        assert float(tout[1]["d_entropy"]) == 0.0
    if case.get("hull") == "random":
        assert float(tout[1]["hull_s_l1"]) > 0.0


def _raw_inputs():
    """Raw densities with a blend ratio of exactly 1.0 (static density
    underflowing next to a dense dynamic sample) and, on ray 3, an empty
    dynamic ray kept by the variance mask (softplus(-200) == 0 in f32)."""
    rng = np.random.default_rng(3)
    raw_s = rng.normal(0, 2, (R, S)).astype(np.float32)
    raw_t = rng.normal(-1, 2, (R, S)).astype(np.float32)
    raw_s[0, 5], raw_t[0, 5] = -60.0, 1.5
    raw_t[3] = -200.0
    _, _, b, z = problem()
    return raw_s, raw_t, b, z


def plain_loss(raw_s, raw_t, b, z, hp, lw, gate=None):
    """The two-kernel path's loss on given raw densities (renderer +
    composite_losses + hull L1), for torch.autograd."""
    pix, s_sig, t_sig, dists = render_transmission_composite(
        raw_s[..., None], raw_t[..., None], b["initial_intensities"], z, hp.output_activation,
        temp_gate=gate)
    losses = tlo.composite_losses(
        s_sig, t_sig, dists, b["weights"], skewness_val=hp.skewness_val,
        entro_mask_thre=hp.entro_mask_thre, entro_use_weighting=hp.entro_use_weighting,
        entro_weighted_thresh=hp.entro_weighted_thresh, occl_reg_perc=hp.occl_reg_perc,
        entro_clip_threshold=hp.entro_clip_threshold, occl_front_only=hp.occl_front_only)
    loss = (torch.mean(tlo.weighted_mse(pix, b["pixels"], b["weights"]))
            + lw[0] * losses.favor_s_loss + lw[1] * losses.dynamic_entropy_loss
            + lw[2] * losses.dynamic_occl_loss + lw[3] * losses.static_l2_loss
            + lw[3] * losses.static_l1_loss)
    if gate is not None:
        loss = loss + lw[4] * torch.mean(torch.sum(s_sig * dists * gate, dim=-1))
    return loss


@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
@pytest.mark.parametrize("gated", [False, True])
def test_cotangents_match_autograd(act, gated):
    # the hand-derived dL/draw against torch.autograd of the plain loss:
    # loss rel 1e-5, each cotangent within 1e-5 of its tensor's scale
    raw_s, raw_t, b, z = _raw_inputs()
    hp = ts.CompositeHParams(**dict(HP, output_activation=act, occl_front_only=gated))
    lw = torch.tensor([1e-2, 1e-3, 1e-3, 1e-4, 1e-3 if gated else 0.0])
    tb = {k: torch.tensor(v) for k, v in b.items()}
    gate = None
    if gated:
        gate = torch.tensor(np.random.default_rng(4).random((R, S)).astype(np.float32))
        gate[1] = 0.0  # an empty dynamic ray through the gate as well
    rs, rt = torch.tensor(raw_s, requires_grad=True), torch.tensor(raw_t, requires_grad=True)
    ref = plain_loss(rs, rt, tb, torch.tensor(z), hp, lw, gate)
    want = torch.autograd.grad(ref, (rs, rt))
    terms, g_s, g_t = tk3.loss_cotangents_plain(
        rs.detach(), rt.detach(), torch.tensor(z), tb["pixels"], tb["weights"],
        tb["initial_intensities"], lw, hp, gate=gate)
    np.testing.assert_allclose(float(terms[tk3.T_LOSS]), float(ref.detach()), rtol=1e-5, atol=0)
    for got, w in zip((g_s, g_t), want):
        assert torch.isfinite(got).all()
        assert float((got - w).abs().max()) <= 1e-5 * float(w.abs().max())
    # the blend ratio really is 1.0 at [0, 5], where the favor term
    # dominates the static cotangent: clip's 0.5 on the bound shows there
    s_sig = output_activation(rs.detach(), act) * 1e-2
    t_sig = output_activation(rt.detach(), act) * 1e-2
    assert float(t_sig[0, 5] / (s_sig[0, 5] + t_sig[0, 5] + 1e-10)) == 1.0
    np.testing.assert_allclose(float(g_s[0, 5]), float(want[0][0, 5]), rtol=1e-5, atol=0)
    assert float(t_sig[3].sum()) == 0.0


def test_envelope_mirrors_jax():
    jcs, jct = cfg_pair(jf)
    tcs, tct = cfg_pair(tf)
    for kw in (dict(), dict(depth_samples_fine=16), dict(static_tv_weight_start=1e-3),
               dict(output_activation="relu"), dict(use_fused_loss=False),
               dict(use_pallas=False)):
        jhp = js.CompositeHParams(**dict(HP, **kw))
        thp = ts.CompositeHParams(**dict(HP, **kw))
        assert tk3.fused_train_supported(tcs, tct, thp) == jax_supported(jcs, jct, jhp), kw
    narrow = dataclasses.replace(tcs, num_filters=64)
    assert not tk3.fused_train_supported(narrow, tct, ts.CompositeHParams(**HP))
    # a ray longer than the kernel keeps in shared memory is outside too
    long_ray = ts.CompositeHParams(**dict(HP, depth_samples_coarse=tk3.MAX_SAMPLES + 1))
    assert not tk3.fused_train_supported(tcs, tct, long_ray)


def test_wrapper_rejects_other_devices():
    meta = torch.device("meta")
    ps, pt, _, _ = problem()
    cs, ct = cfg_pair(tf)
    tps = jax.tree.map(lambda x: x.to(meta), tf.params_from_jax(ps))
    tpt = jax.tree.map(lambda x: x.to(meta), tf.params_from_jax(pt))
    e = torch.empty(R, device=meta)
    with pytest.raises(ValueError):
        tk3.fused_train_loss_and_grads(
            tps, tpt, torch.empty(R, 3, device=meta), torch.empty(R, 3, device=meta),
            torch.empty(S, device=meta), torch.zeros(R, dtype=torch.int32, device=meta),
            e, e, e, cs, ct, None, None, [0.0] * 4, ts.CompositeHParams(**HP))
