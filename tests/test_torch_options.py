"""Options of the plain path ported with the bf16 slice, against the JAX
package: AdamW (``make_optimizer(weight_decay > 0)``, optax.adamw with the
``w``-leaf mask) and skip/late layers (``num_late_layers > 0``: init, apply
and gradients of the fields, and the trainer on the CPU)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.train import run_composite
from nerfca_tpu_torch.train import step as ts
from tests.test_torch_step import hparams, problem, torch_params
from tests.test_torch_trainer import FAST_DATA, SMALL


def late_cfgs(mod, late=2, enc="free_windowed", basis=4):
    kw = dict(num_early_layers=2, num_late_layers=late, num_filters=64, pos_enc=enc,
              pos_enc_basis=basis, pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def flat_grads(tparams, grads_tree_fn):
    return [grads_tree_fn(name) for name, _ in ts.param_items(tparams)]


def leaf(tree, name):
    node = tree
    for part in name.split("/")[1:]:
        node = node[int(part)] if part.isdigit() else node[part]
    return node


@pytest.mark.parametrize("freeze", [0, 2])
def test_adamw_matches_optax(freeze):
    # three AdamW updates from the SAME grads, with the static freeze gate:
    # params within 1e-6 of optax.adamw's (the Adam test's tolerance), the
    # decay reaching the w leaves alone (JAX's mask)
    params, _, _ = problem(seed=3)
    jtx = js.make_optimizer(1e-3, 0.01, 300, weight_decay=0.1)
    opt = jtx.init(params)
    tparams = torch_params(params)
    ttx = ts.make_optimizer(1e-3, 0.01, 300, weight_decay=0.1)
    topt = ts.init_opt_state(tparams)
    thp = hparams(ts, static_freeze_step=freeze)
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * 1e-4).astype(np.float32),
                             params)
        updates, opt = jtx.update(grads, opt, params)
        gate = 0.0 if (freeze > 0 and step >= freeze) else 1.0
        updates = {k: jax.tree.map(lambda u: u * gate, v) if k.startswith("static") else v
                   for k, v in updates.items()}
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
        tgrads = {k: tf.params_from_jax(v) for k, v in grads.items()}
        flat = [leaf(tgrads[name.split("/")[0]], name) for name, _ in ts.param_items(tparams)]
        ts.adam_update(tparams, topt, flat, ttx, step, thp)
        got = {k: tf.params_to_jax(v) for k, v in tparams.items()}
        for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=str(path))
    assert topt["count"] == 3


def test_adamw_decays_only_weight_matrices():
    # with zero gradients only the decay moves a leaf: every w leaf shrinks
    # by exactly lr * wd * w, every bias and the latent table stay put
    params, _, _ = problem(seed=1)
    tparams = torch_params(params)
    before = {n: t.clone() for n, t in ts.param_items(tparams)}
    tx = ts.make_optimizer(1e-3, 1.0, 300, weight_decay=0.5)
    opt = ts.init_opt_state(tparams)
    zeros = [torch.zeros_like(t) for _, t in ts.param_items(tparams)]
    ts.adam_update(tparams, opt, zeros, tx, 0, hparams(ts))
    for name, t in ts.param_items(tparams):
        if ts.is_decayed(name):
            torch.testing.assert_close(t, before[name] * (1 - 1e-3 * 0.5), atol=1e-9, rtol=1e-6)
        else:
            assert torch.equal(t, before[name]), name


def test_adamw_state_crosses_from_optax():
    # optax.adamw's state after two steps carried into the port: a third
    # update from it equals optax's (1e-6), and the state carried back out
    # holds optax's count and moments
    params, _, _ = problem(seed=2)
    jtx = js.make_optimizer(1e-3, 0.01, 300, weight_decay=0.05)
    opt = jtx.init(params)
    rng = np.random.default_rng(1)
    draws = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 1e-3).astype(np.float32), params)
             for _ in range(3)]
    for g in draws[:2]:
        updates, opt = jtx.update(g, opt, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    tparams = torch_params(params)
    topt = ts.opt_state_from_jax(opt)
    assert topt["count"] == 2
    updates, opt = jtx.update(draws[2], opt, params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    tg = {k: tf.params_from_jax(v) for k, v in draws[2].items()}
    flat = [leaf(tg[n.split("/")[0]], n) for n, _ in ts.param_items(tparams)]
    ts.adam_update(tparams, topt, flat, ts.make_optimizer(1e-3, 0.01, 300, weight_decay=0.05),
                   2, hparams(ts))
    got = {k: tf.params_to_jax(v) for k, v in tparams.items()}
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=str(path))
    back = ts.opt_state_to_jax(topt, tparams)
    adam = next(s for s in opt if hasattr(s, "mu"))
    assert int(back["count"]) == int(adam.count) == 3
    for ours, theirs in ((back["mu"], adam.mu), (back["nu"], adam.nu)):
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-9, rtol=1e-6)


@pytest.mark.parametrize("late", [1, 2])
def test_late_layers_init_bit_for_bit(late):
    # the skip and late layers drawn from the same key as JAX draws them
    cs_j, ct_j = late_cfgs(jf, late)
    cs_t, ct_t = late_cfgs(tf, late)
    for seed, init_j, init_t, cj, ct in ((0, jf.init_static_field, tf.init_static_field, cs_j, cs_t),
                                         (1, jf.init_temporal_field, tf.init_temporal_field, ct_j,
                                          ct_t)):
        want = jax.tree.map(np.asarray, init_j(jax.random.PRNGKey(seed), cj))
        got = tf.params_to_jax(init_t(prng.key(seed), ct))
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        assert len(got["late"]) == late - 1 and got["skip"]["w"].shape == (64 + ct.input_features,
                                                                          64)
        for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_late_layers_apply_and_grads_match(dtype):
    # both fields with the skip path: values within 1e-5 (f32 summation
    # order; in bf16 the mean within 5e-5 of the mean output, as
    # tests/test_torch_bf16.py holds the plain bf16 fields) and gradients
    # within 1e-4 of each leaf's scale (one bf16 ulp, 2^-8, in bf16: both
    # round the gradients to bf16); intermediates: one per layer, skip
    # included
    cs_j, ct_j = late_cfgs(jf)
    cs_t, ct_t = late_cfgs(tf)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(3), cs_j))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(4), ct_j))
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (4, 64, 3)).astype(np.float32)
    ph = rng.integers(0, 10, (4, 64)).astype(np.int32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jloss(a, b):
        rs = jf.apply_static_field(a, jnp.asarray(pts), cs_j, compute_dtype=jdt)
        rt = jf.apply_temporal_field(b, jnp.asarray(pts), jnp.asarray(ph), ct_j, compute_dtype=jdt)
        return jnp.sum(jnp.sin(rs) * 0.3 + rt ** 2), (rs, rt)

    (_, (js_, jt_)), (gs, gt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(ps, pt)
    tps, tpt = tf.params_from_jax(ps), tf.params_from_jax(pt)
    for x in jax.tree_util.tree_leaves((tps, tpt)):
        x.requires_grad_(True)
    rs = tf.apply_static_field(tps, torch.tensor(pts), cs_t, compute_dtype=dtype)
    rt = tf.apply_temporal_field(tpt, torch.tensor(pts), torch.tensor(ph), ct_t,
                                 compute_dtype=dtype)
    torch.sum(torch.sin(rs) * 0.3 + rt ** 2).backward()
    for a, b in ((rs, js_), (rt, jt_)):
        a, b = a.detach().numpy(), np.asarray(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        else:
            assert np.abs(a - b).mean() <= 5e-5 * np.abs(b).mean()
    bound = 1e-4 if dtype == "float32" else 2.0 ** -8
    for tree, want in ((tps, gs), (tpt, gt)):
        got = tf.params_to_jax(jax.tree.map(lambda x: x.grad, tree))
        for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree_util.tree_leaves(got)):
            b = np.asarray(b)
            assert np.abs(a - b).max() <= bound * max(np.abs(b).max(), 1e-30), path
    _, inter = tf.apply_mlp(tps, torch.zeros(2, cs_t.encoded_features), cs_t,
                            return_intermediates=True)
    assert len(inter) == 3 + 2  # input + 2 hidden, skip + 1 late


def test_late_layers_in_param_items_and_back():
    # the Adam leaf order covers the skip and late leaves, and
    # params_from_leaves rebuilds the same tree
    _, ct = late_cfgs(tf)
    params = {"temp": tf.init_temporal_field(prng.key(0), ct)}
    items = ts.param_items(params)
    names = [n for n, _ in items]
    assert {"temp/skip/w", "temp/skip/b", "temp/late/0/w", "temp/late/0/b"} <= set(names)
    rebuilt = ts.params_from_leaves(params, [t for _, t in items])
    assert [n for n, _ in ts.param_items(rebuilt)] == names
    assert all(a is b for (_, a), (_, b) in zip(ts.param_items(rebuilt), items))


def test_run_composite_with_static_late_layers(tmp_path):
    # the CLI on the CPU with --static_num_late_layers 2 and AdamW: outside
    # the kernels' envelope, so --use_pallas falls back to the plain path
    # with a warning; two finite steps and a finite eval
    argv = ["--config", SMALL, "--platform", "cpu", "--n_iters", "1", "--display_every", "2",
            "--log_every", "1", "--static_num_late_layers", "2", "--weight_decay", "1e-4",
            "--use_pallas", "true", "--data_root", str(tmp_path / "data"),
            "--log_dir_root", str(tmp_path / "cases"), *FAST_DATA]
    with pytest.warns(UserWarning, match="envelope"):
        out = run_composite.main(argv)
    params = out["state"].params["static"]
    assert "skip" in params and len(params["late"]) == 1
    assert not out["setup"]["hp"].use_pallas
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train_loss" in r]
    evals = [r for r in records if "test_image_psnr" in r]
    assert len(train) == 2 and all(math.isfinite(r["train_loss"]) for r in train)
    assert len(evals) == 1 and math.isfinite(evals[0]["test_image_psnr"])
