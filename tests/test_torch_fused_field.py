"""The K1/K2 module of the torch port: its plain version against the JAX
Pallas kernels (interpret mode) and the JAX jnp fields, and the wrapper's
packing and dispatch. The kernels themselves are checked against the plain
version on the card by ``tests/test_torch_gpu.py``."""

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
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops.cuda import fused_field as tff


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def cfg_pair(basis=4, layers=2, enc="free_windowed", mod=jf):
    kw = dict(num_early_layers=layers, num_filters=128, pos_enc=enc, pos_enc_basis=basis,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def setup(r, s, basis=4, layers=2, seed=0, enc="free_windowed"):
    js, jt = cfg_pair(basis, layers, enc)
    ts, tt = cfg_pair(basis, layers, enc, tf)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), js))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), jt))
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.1, -0.2, -4.5]], np.float32), (r, 1))
    d = np.concatenate([rng.uniform(-0.1, 0.1, (r, 2)), np.ones((r, 1))], 1).astype(np.float32)
    z = np.sort(rng.uniform(3.6, 5.4, (r, s)), axis=1).astype(np.float32)
    ph = rng.integers(0, 10, r).astype(np.int32)
    w = None if basis == 0 else np.asarray(free_window_mask(basis, 60, 100, 1))
    return dict(js=js, jt=jt, ts=ts, tt=tt, ps=ps, pt=pt, o=o, d=d, z=z, ph=ph, w=w)


def jax_fused(c, ps, pt):
    w = None if c["w"] is None else jnp.asarray(c["w"])
    return jff.fused_composite_fields_rays(
        ps, pt, jnp.asarray(c["o"]), jnp.asarray(c["d"]), jnp.asarray(c["z"]),
        jnp.asarray(c["ph"]), c["js"], c["jt"], w, w, tile=128)


def jax_plain(c, ps, pt):
    w = None if c["w"] is None else jnp.asarray(c["w"])
    pts = jnp.asarray(c["o"])[:, None] + jnp.asarray(c["d"])[:, None] * jnp.asarray(c["z"])[..., None]
    php = jnp.broadcast_to(jnp.asarray(c["ph"])[:, None], pts.shape[:2])
    return (jf.apply_static_field(ps, pts, c["js"], window=w),
            jf.apply_temporal_field(pt, pts, php, c["jt"], window=w))


def torch_plain(c, tps, tpt, shared_z=False):
    z = torch.tensor(c["z"][0]) if shared_z else torch.tensor(c["z"])
    w = None if c["w"] is None else torch.tensor(c["w"])
    return tff.fused_composite_fields_rays(
        tps, tpt, torch.tensor(c["o"]), torch.tensor(c["d"]), z, torch.tensor(c["ph"]),
        c["ts"], c["tt"], w, w)


def loss_j(out):
    return jnp.sum(jnp.sin(out[0]) * 0.3 + out[1] ** 2)


def torch_grads(c):
    tps, tpt = tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"])
    leaves = [x for tree in (tps, tpt) for x in jax.tree_util.tree_leaves(tree)]
    for x in leaves:
        x.requires_grad_(True)
    rs, rt = torch_plain(c, tps, tpt)
    torch.sum(torch.sin(rs) * 0.3 + rt**2).backward()
    return (tf.params_to_jax(jax.tree.map(lambda x: x.grad, tps)),
            tf.params_to_jax(jax.tree.map(lambda x: x.grad, tpt)))


def compare_trees(got, want, **tol):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(want)[0], fg, fw):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **tol)


@pytest.mark.parametrize("r,s,enc,basis", [(4, 64, "free_windowed", 4), (3, 33, "free_windowed", 4),
                                           (2, 64, "none", 0)])
def test_plain_forward_matches_pallas_interpret(r, s, enc, basis):
    # the Pallas kernel's own tolerance against jnp (test_pallas.py:77)
    c = setup(r, s, basis=basis, enc=enc)
    a_s, a_t = jax_fused(c, c["ps"], c["pt"])
    b_s, b_t = torch_plain(c, tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"]))
    assert b_s.shape == (r, s, 1) and b_t.shape == (r, s, 1)
    np.testing.assert_allclose(b_s.detach().numpy(), np.asarray(a_s), atol=2e-4, rtol=0)
    np.testing.assert_allclose(b_t.detach().numpy(), np.asarray(a_t), atol=2e-4, rtol=0)


def test_plain_gradients_match_pallas_interpret():
    # the Pallas VJP's own tolerance against jnp (test_pallas.py:141)
    c = setup(2, 64, basis=2, layers=1, seed=7)
    gj = jax.grad(lambda a, b: loss_j(jax_fused(c, a, b)), argnums=(0, 1))(c["ps"], c["pt"])
    compare_trees(torch_grads(c), gj, atol=5e-3, rtol=1e-3)


def test_plain_matches_jnp_fields_tightly():
    # same math as the JAX jnp path: forward abs 1e-5; grads per leaf
    # within 1e-4 of the leaf's scale
    c = setup(3, 40, basis=4, layers=2, seed=3)
    a_s, a_t = jax_plain(c, c["ps"], c["pt"])
    b_s, b_t = torch_plain(c, tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"]))
    np.testing.assert_allclose(b_s.detach().numpy(), np.asarray(a_s), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b_t.detach().numpy(), np.asarray(a_t), atol=1e-5, rtol=0)
    gj = jax.grad(lambda a, b: loss_j(jax_plain(c, a, b)), argnums=(0, 1))(c["ps"], c["pt"])
    for got, want in zip(torch_grads(c), gj):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-12)


def test_shared_depths_equal_per_ray_depths():
    c = setup(3, 16)
    c["z"] = np.tile(c["z"][:1], (3, 1))
    tps, tpt = tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"])
    for a, b in zip(torch_plain(c, tps, tpt), torch_plain(c, tps, tpt, shared_z=True)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_envelope_mirrors_pallas():
    js, _ = cfg_pair()
    ts, _ = cfg_pair(mod=tf)
    # fourier at 6 * 21 = 126 encoded features is inside, at 6 * 22 = 132 outside
    for kw in (dict(), dict(num_filters=64), dict(num_late_layers=2), dict(pos_enc_basis=30),
               dict(pos_enc="none", pos_enc_basis=0), dict(pos_enc="nerfies_windowed"),
               dict(num_time_dim=9, use_time_latents=True), dict(pos_enc="fourier"),
               dict(pos_enc="fourier", pos_enc_basis=21),
               dict(pos_enc="fourier", pos_enc_basis=22)):
        assert tff.kernel_supported(dataclasses.replace(ts, **kw)) == jff.pallas_supported(
            dataclasses.replace(js, **kw)), kw
    assert tff.kernel_supported(dataclasses.replace(ts, pos_enc="fourier"))


def test_gradient_layout_round_trip():
    # K2 returns one flat vector; the wrapper must cut it back into leaves
    c = setup(2, 8, basis=12, layers=4)
    for params, cfg in ((c["ps"], c["ts"]), (c["pt"], c["tt"])):
        tp = tf.params_from_jax(params)
        pack = tff._Pack(cfg, tff._leaves(tp), None, torch.device("cpu"))
        lay = pack.grad_layout(10)
        # every block the kernel updates with float4 stores starts 16-byte aligned
        assert lay["size"] % 4 == 0
        assert all(lay[k][0] % 4 == 0 for k in ("w0", "b0", "wh", "bh", "wo", "lat"))
        flat = torch.zeros(lay["size"])
        want = [torch.randn_like(x) for x in tff._leaves(tp)]
        off, size = lay["w0"]
        flat[off:off + size] = want[0].t().reshape(-1)
        flat[lay["b0"][0]:lay["b0"][0] + 128] = want[1]
        for layer in range(cfg.num_early_layers):
            o = lay["wh"][0] + layer * 128 * 128
            flat[o:o + 128 * 128] = want[2 + 2 * layer].t().reshape(-1)
            o = lay["bh"][0] + layer * 128
            flat[o:o + 128] = want[3 + 2 * layer]
        flat[lay["wo"][0]:lay["wo"][0] + 128] = want[-2].reshape(-1)
        flat[lay["bo"][0]] = want[-1][0]
        got, lat = pack.leaf_grads(flat, 10)
        assert (lat is None) == (not cfg.use_time_latents)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("fault", ["none", "f64_weight", "wrong_in_dim", "short_window"])
def test_kernel_input_checks(fault):
    # the kernels read raw pointers: every parameter must be f32 on the
    # rays' device with the config's shapes, and the window one per band
    c = setup(2, 8)
    tps, tpt = tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"])
    w = torch.tensor(c["w"])
    if fault == "f64_weight":
        tpt["early"][1]["w"] = tpt["early"][1]["w"].double()
    elif fault == "wrong_in_dim":
        tps["early"][0]["w"] = tps["early"][0]["w"][:, :-1]
    elif fault == "short_window":
        w = w[:-1]
    args = (tps, tpt, torch.tensor(c["o"]), torch.tensor(c["d"]), torch.tensor(c["z"]),
            c["ts"], c["tt"], (w, w))
    if fault == "none":
        tff._check_inputs(*args)
    else:
        with pytest.raises(ValueError):
            tff._check_inputs(*args)


def test_wrapper_rejects_other_devices():
    c = setup(2, 8)
    meta = torch.device("meta")
    tps = jax.tree.map(lambda x: x.to(meta), tf.params_from_jax(c["ps"]))
    tpt = jax.tree.map(lambda x: x.to(meta), tf.params_from_jax(c["pt"]))
    with pytest.raises(ValueError):
        tff.fused_composite_fields_rays(
            tps, tpt, torch.empty(2, 3, device=meta), torch.empty(2, 3, device=meta),
            torch.empty(8, device=meta), torch.zeros(2, dtype=torch.int32, device=meta),
            c["ts"], c["tt"], None, None)
