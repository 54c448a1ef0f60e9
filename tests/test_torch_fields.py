"""The torch port's fields against the JAX fields, with the JAX parameters
copied over by ``params_from_jax`` (CPU)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng


def cfgs(basis=4, layers=2, width=128, enc="free_windowed"):
    kw = dict(num_early_layers=layers, num_filters=width, pos_enc=enc, pos_enc_basis=basis,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return (jf.FieldConfig(**kw), jf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw),
            tf.FieldConfig(**kw), tf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw))


def jax_params(cfg_s, cfg_t, seed=0):
    ps = jf.init_static_field(jax.random.PRNGKey(seed), cfg_s)
    pt = jf.init_temporal_field(jax.random.PRNGKey(seed + 1), cfg_t)
    return jax.tree.map(np.asarray, ps), jax.tree.map(np.asarray, pt)


def inputs(r=3, s=20, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (r, s, 3)).astype(np.float32)
    ph = rng.integers(0, 10, (r, s)).astype(np.int32)
    return pts, ph


def test_config_fields_match():
    # the JAX package's fields, then the port's own (tf.PORT_ONLY_DEFAULTS)
    assert [f.name for f in tf.FieldConfig.__dataclass_fields__.values()] == [
        f.name for f in jf.FieldConfig.__dataclass_fields__.values()] + list(
        tf.PORT_ONLY_DEFAULTS)
    _, jt, _, tt = cfgs(basis=12)
    assert tt.encoded_features == jt.encoded_features == 75
    assert tt.input_features == jt.input_features == 83


def test_init_shapes_and_bounds():
    _, _, cs, ct = cfgs(basis=12, layers=4)
    keys = prng.split(prng.key(0))
    ps, pt = tf.init_static_field(keys[0], cs), tf.init_temporal_field(keys[1], ct)
    assert ps["early"][0]["w"].shape == (128, 75)  # [out, in]
    assert pt["early"][0]["w"].shape == (128, 83)
    assert len(pt["early"]) == 5 and pt["out"]["w"].shape == (1, 128)
    assert pt["latents"].shape == (10, 8)
    assert 0.0 <= float(pt["latents"].min()) and float(pt["latents"].max()) < 1.0
    bound = 1 / np.sqrt(83)
    assert float(pt["early"][0]["w"].abs().max()) <= bound
    assert float(pt["early"][0]["b"].abs().max()) <= bound
    assert float(pt["early"][0]["w"].abs().max()) > 0.9 * bound


def test_params_round_trip():
    js, jt_, _, _ = cfgs()
    ps, pt = jax_params(js, jt_)
    back = tf.params_to_jax(tf.params_from_jax(pt))
    flat_a, tree_a = jax.tree_util.tree_flatten(pt)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert tf.params_from_jax(ps)["early"][0]["w"].shape == (128, 27)


@pytest.mark.parametrize("enc,basis", [("free_windowed", 4), ("none", 0), ("nerfies_windowed", 3)])
def test_field_values_match(enc, basis):
    # f32 matmuls in different summation orders: abs 1e-5
    js, jt_, ts, tt = cfgs(basis=basis, enc=enc)
    ps, pt = jax_params(js, jt_)
    pts, ph = inputs()
    w = None if basis == 0 else np.asarray(free_window_mask(basis, 30, 100, 1))
    a_s = jf.apply_static_field(ps, jnp.asarray(pts), js, window=None if w is None else jnp.asarray(w))
    a_t = jf.apply_temporal_field(pt, jnp.asarray(pts), jnp.asarray(ph), jt_,
                                  window=None if w is None else jnp.asarray(w))
    tw = None if w is None else torch.tensor(w)
    b_s = tf.apply_static_field(tf.params_from_jax(ps), torch.tensor(pts), ts, window=tw)
    b_t = tf.apply_temporal_field(tf.params_from_jax(pt), torch.tensor(pts),
                                  torch.tensor(ph), tt, window=tw)
    np.testing.assert_allclose(b_s.detach().numpy(), np.asarray(a_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b_t.detach().numpy(), np.asarray(a_t), atol=1e-5, rtol=0)
    out, inter = tf.apply_mlp(tf.params_from_jax(ps), torch.zeros(2, ts.encoded_features), ts,
                              return_intermediates=True)
    assert out.shape == (2, 1) and len(inter) == 3


def test_field_gradients_match():
    # per leaf: max-abs diff <= 1e-4 x the leaf's own max-abs scale
    js, jt_, ts, tt = cfgs(basis=4, layers=2)
    ps, pt = jax_params(js, jt_, seed=5)
    pts, ph = inputs(seed=2)
    w = np.asarray(free_window_mask(4, 60, 100, 1))

    def jloss(a, b):
        rs = jf.apply_static_field(a, jnp.asarray(pts), js, window=jnp.asarray(w))
        rt = jf.apply_temporal_field(b, jnp.asarray(pts), jnp.asarray(ph), jt_,
                                     window=jnp.asarray(w))
        return jnp.sum(jnp.sin(rs) * 0.3 + rt**2)

    gs_j, gt_j = jax.grad(jloss, argnums=(0, 1))(ps, pt)
    tps, tpt = tf.params_from_jax(ps), tf.params_from_jax(pt)
    leaves = [x for tree in (tps, tpt) for x in jax.tree_util.tree_leaves(tree)]
    for x in leaves:
        x.requires_grad_(True)
    rs = tf.apply_static_field(tps, torch.tensor(pts), ts, window=torch.tensor(w))
    rt = tf.apply_temporal_field(tpt, torch.tensor(pts), torch.tensor(ph), tt,
                                 window=torch.tensor(w))
    torch.sum(torch.sin(rs) * 0.3 + rt**2).backward()
    grads_t = jax.tree.map(lambda x: x.grad, (tps, tpt))
    for gt_tree, gj_tree in ((grads_t[0], gs_j), (grads_t[1], gt_j)):
        got = tf.params_to_jax(gt_tree)
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree_util.tree_leaves(gj_tree)):
            b = np.asarray(b)
            scale = max(float(np.abs(b).max()), 1e-12)
            assert float(np.abs(a - b).max()) <= 1e-4 * scale, path
