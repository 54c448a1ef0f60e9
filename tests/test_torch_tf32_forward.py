"""K1's arithmetic on the CPU, and K3's loss phase on top of it. K1
(``csrc/fused_field.cu::fwd_kernel``) runs the input and hidden layers of
both fields as 3xTF32 products on the tensor cores (the split of
``test_torch_tf32_split.py``) and the output layer in f32; K3 feeds K1's raw
densities to its loss kernel, whose math is ``loss_cotangents_plain``. This
file emulates that forward in torch at the flagship widths (two 4x128
fields, free_windowed basis 12 with every band open, 8-d latents) on a few
rays of 500 samples, feeds its raw densities through
``loss_cotangents_plain``, and holds the raw densities, the loss, each term
and both cotangents against the JAX package on the same numpy inputs: its
jnp fields, its K3 (Pallas in interpret mode) and ``jax.vjp`` of its
renderer and loss battery."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops import losses as jlo
from nerfca_tpu.ops.hull import MotionHull as JHull
from nerfca_tpu.ops.hull import hull_gate_rays as jax_gate
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads as jax_k3
from nerfca_tpu.ops.render import render_transmission_composite
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops.cuda import fused_train as tk3
from nerfca_tpu_torch.ops.encoding import posenc
from nerfca_tpu_torch.ops.hull import MotionHull as THull
from nerfca_tpu_torch.ops.hull import hull_gate_rays as torch_gate
from nerfca_tpu_torch.train import step as ts
from test_torch_tf32_split import mm_3xtf32

R, S = 4, 500  # JAX K3 takes whole tiles of 2 rays at 500 samples
STEP = 57
HP = dict(img_sample_size=R, depth_samples_coarse=S, favor_s_weight_start=1e-3,
          favor_s_weight_end=1e-3, dynamic_entro_weight_start=1e-4, dynamic_entro_weight_end=1e-4,
          occl_weight_start=1e-4, occl_weight_end=1e-4, l1_weight_start=1e-6,
          l1_weight_end=1e-6, hull_static_l1_weight_start=1e-3, hull_static_l1_weight_end=1e-3,
          hyperparam_decay_steps=100, entro_mask_thre=1e-3, entro_use_weighting=True,
          entro_weighted_thresh=0.25, occl_reg_perc=0.2, use_pallas=True, use_fused_loss=True)
# raw densities within RAW_REL of their scale (3xTF32 keeps ~2^-21 of each
# product); loss and each term relative TERM_REL; cotangents within COT_REL
# of their scale. The card gates loss and terms at 1e-3.
RAW_REL, TERM_REL, COT_REL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def cfg_pair(mod):
    kw = dict(num_early_layers=4, num_filters=128, pos_enc="free_windowed", pos_enc_basis=12,
              pos_enc_window_start=1, pos_enc_window_decay_steps=150000)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def problem(seed, hull):
    """Numpy inputs: the JAX field init at the flagship widths, rays through
    the origin along -x with shared jittered depths, and optionally a hull
    grid that covers part of them."""
    cs, ct = cfg_pair(jf)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), cs))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), ct))
    rng = np.random.default_rng(seed)
    b = {
        "origins": np.tile(np.array([[4.5, 0.0, 0.0]], np.float32), (R, 1)),
        "directions": (rng.normal(0, 0.02, (R, 3)) + [-1.0, 0.0, 0.0]).astype(np.float32),
        "phases": rng.integers(0, 10, R).astype(np.int32),
        "pixels": (2.1 + 0.05 * rng.random(R)).astype(np.float32),
        "weights": np.array([1.0, 1.6, 1.1, 2.0], np.float32),
        "initial_intensities": np.full(R, 2.16, np.float32),
    }
    z = np.sort(np.linspace(3.6, 5.4, S) + rng.uniform(0, 1.8 / S, S)).astype(np.float32)
    grid = None
    if hull:
        grid = (0.2 + 0.8 * np.random.default_rng(9).random((6, 6, 6))).astype(np.float32)
    return ps, pt, b, z, grid


def k1_field(params, x):
    """One field as K1 computes it on the encoded (and latent-extended)
    input ``x [N, k0]``: each layer's product in 3xTF32 on top of the bias,
    then the output layer in f32."""
    h = x
    for layer in params["early"]:
        h = torch.relu(layer["b"] + mm_3xtf32(h, layer["w"].t()))
    return h @ params["out"]["w"][0] + params["out"]["b"][0]


def k3_on_k1(ps, pt, b, z, grid, thp, lw):
    """K1's forward emulated in torch, then the loss kernel's math:
    ``(raw_s, raw_t, terms, dL/draw_s, dL/draw_t)``, all ``[R, S]`` but the
    terms."""
    tps, tpt = tf.params_from_jax(ps), tf.params_from_jax(pt)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tz = torch.tensor(z)
    cs, ct = cfg_pair(tf)
    pts = (tb["origins"][:, None, :] + tb["directions"][:, None, :] * tz[None, :, None])
    pts = pts.reshape(-1, 3)
    window = torch.ones(12)
    lat = tpt["latents"][tb["phases"].long().repeat_interleave(S)]
    enc_s = posenc(pts, cs.pos_enc, cs.pos_enc_basis, window=window)
    enc_t = torch.cat([posenc(pts, ct.pos_enc, ct.pos_enc_basis, window=window), lat], dim=-1)
    raw_s = k1_field(tps, enc_s).reshape(R, S)
    raw_t = k1_field(tpt, enc_t).reshape(R, S)
    gate = None
    if grid is not None:
        hull = THull(torch.tensor(grid), torch.full((3,), 0.5), torch.zeros(3))
        gate = torch_gate(hull, tb["origins"], tb["directions"], tz)
    terms, g_s, g_t = tk3.loss_cotangents_plain(
        raw_s, raw_t, tz, tb["pixels"], tb["weights"], tb["initial_intensities"],
        torch.tensor(lw), thp, gate=gate)
    return raw_s, raw_t, terms, g_s, g_t


def jax_reference(ps, pt, b, z, grid, jhp, lw):
    """The JAX package on the same inputs: the jnp fields' raw densities,
    ``jax.vjp`` of its renderer and loss battery at them (the cotangents),
    and its K3's loss and terms."""
    cs, ct = cfg_pair(jf)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jz = jnp.asarray(z)
    window = jnp.ones(12, jnp.float32)
    pts = jb["origins"][:, None, :] + jb["directions"][:, None, :] * jz[None, :, None]
    ph = jnp.broadcast_to(jb["phases"][:, None], (R, S))
    raw_s = jf.apply_static_field(ps, pts, cs, window=window)[..., 0]
    raw_t = jf.apply_temporal_field(pt, pts, ph, ct, window=window)[..., 0]
    jh = gate = None
    if grid is not None:
        jh = JHull(jnp.asarray(grid), jnp.full((3,), 0.5, jnp.float32), jnp.zeros(3, jnp.float32))
        gate = jax_gate(jh, jb["origins"], jb["directions"], jz)

    def loss_of_raw(rs, rt):
        # composite_loss_fn's coarse objective on given raw densities
        pix, s_sig, t_sig, dists = render_transmission_composite(
            rs[..., None], rt[..., None], jb["initial_intensities"], jz, jhp.output_activation,
            temp_gate=gate)
        ls = jlo.composite_losses(
            s_sig, t_sig, dists, jb["weights"], skewness_val=jhp.skewness_val,
            entro_mask_thre=jhp.entro_mask_thre, entro_use_weighting=jhp.entro_use_weighting,
            entro_weighted_thresh=jhp.entro_weighted_thresh, occl_reg_perc=jhp.occl_reg_perc,
            entro_clip_threshold=jhp.entro_clip_threshold, occl_front_only=jhp.occl_front_only)
        loss = (jnp.mean(jlo.weighted_mse(pix, jb["pixels"], jb["weights"]))
                + lw[0] * ls.favor_s_loss + lw[1] * ls.dynamic_entropy_loss
                + lw[2] * ls.dynamic_occl_loss + lw[3] * ls.static_l2_loss
                + lw[3] * ls.static_l1_loss)
        if gate is not None:
            loss = loss + lw[4] * jnp.mean(jnp.sum(s_sig * dists * gate, axis=-1))
        return loss

    loss, vjp = jax.vjp(loss_of_raw, raw_s, raw_t)
    g_s, g_t = vjp(jnp.float32(1.0))
    k3_loss, k3_terms, _, _ = jax_k3(
        ps, pt, jb["origins"], jb["directions"], jz, jb["phases"], jb["pixels"], jb["weights"],
        jb["initial_intensities"], cs, ct, window, window, jnp.asarray(lw), jhp, hull=jh)
    return dict(raw_s=raw_s, raw_t=raw_t, loss=loss, g_s=g_s, g_t=g_t, k3_loss=k3_loss,
                k3_terms=k3_terms)


def within(a, b, rel):
    """Max abs difference of ``a`` (torch) and ``b`` (JAX) within ``rel`` of
    ``b``'s scale."""
    a, b = a.detach().numpy(), np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.mark.parametrize("hull", [False, True], ids=["ungated", "gated"])
def test_tf32_forward_and_loss_match_jax(hull):
    ps, pt, b, z, grid = problem(11, hull)
    jhp, thp = js.CompositeHParams(**HP), ts.CompositeHParams(**HP)
    w = js.loss_weights(jnp.int32(STEP), jhp)
    names = ["favor_s", "dynamic_entro", "occl", "l1"] + (["hull_static_l1"] if hull else [])
    lw = np.array([float(w[k]) for k in names], np.float32)
    raw_s, raw_t, terms, g_s, g_t = k3_on_k1(ps, pt, b, z, grid, thp, lw)
    ref = jax_reference(ps, pt, b, z, grid, jhp, lw)

    assert within(raw_s, ref["raw_s"], RAW_REL)
    assert within(raw_t, ref["raw_t"], RAW_REL)
    loss = float(terms[tk3.T_LOSS])
    np.testing.assert_allclose(loss, float(ref["loss"]), rtol=TERM_REL, atol=0)
    np.testing.assert_allclose(loss, float(ref["k3_loss"]), rtol=TERM_REL, atol=0)
    k3_terms = {k: float(v) for k, v in ref["k3_terms"].items()}
    assert set(k3_terms) == set(tk3.TERM_NAMES)
    for i, name in enumerate(tk3.TERM_NAMES):
        np.testing.assert_allclose(float(terms[i]), k3_terms[name], rtol=TERM_REL, atol=1e-12,
                                   err_msg=name)
    assert (k3_terms["hull_s_l1"] > 0) == hull
    assert within(g_s, ref["g_s"], COT_REL)
    assert within(g_t, ref["g_t"], COT_REL)
