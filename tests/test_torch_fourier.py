"""The ``fourier`` encoding in the torch port against the JAX package, on
the same numpy inputs: ``prng.normal`` against ``jax.random.normal`` bit
for bit, the projection and the field init bit for bit from a seed,
``posenc`` and the fields, the plain twins of K1/K2 (ray form and the
static entry) and of K3 against JAX's Pallas entries in interpret mode,
the buffer's place in the parameter tree (Adam, checkpoints, optax state),
the static and composite steps against JAX's, and ``run_eval`` of a
fourier checkpoint against JAX's. The CUDA kernels' fourier mode is held
against these twins on the card by ``tests/test_torch_gpu.py``."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops import encoding as jenc
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads as jax_k3
from nerfca_tpu.ops.sampling import linspace_depths as j_linspace
from nerfca_tpu.train import checkpoint as jck
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import run_eval as jre
from nerfca_tpu.train import step as js
from nerfca_tpu.train.trainer import field_configs_from_args as jax_field_configs
from nerfca_tpu_torch.data.dataset import build_dataset
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import encoding as tenc
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import fused_field as tff
from nerfca_tpu_torch.ops.cuda import fused_train as tk3
from nerfca_tpu_torch.ops.sampling import linspace_depths
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import run_eval as tre
from nerfca_tpu_torch.train import step as ts
from tests.test_torch_fused_train import HP as K3_HP
from tests.test_torch_fused_train import assert_match
from tests.test_torch_static import ray_table, static_hparams
from tests.test_torch_trainer import FAST_DATA, SMALL
from tests.test_train_step import synthetic_rays

# Tolerances. Bit for bit: the draws, the projection, the init. posenc:
# sin/cos of f32 arguments up to ~40 rad in two libraries, 2e-6 absolute.
# Fields and steps against jnp: forward 1e-5 absolute, loss rel 1e-5, Adam's
# params 1e-6 after one step and 1e-5 after three (test_torch_step.py).
# Against the Pallas kernels in interpret mode, their own tolerances
# (test_pallas.py:77, :141): forward 2e-4, grads 5e-3 absolute + 1e-3
# relative (the kernel forms 2 pi coef x where the plain path forms
# (2 pi x) coef, one f32 rounding apart at arguments of ~40).
POSENC_ATOL = 2e-6
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
FWD_KERNEL_ATOL = 2e-4
GRAD_KERNEL_TOL = dict(atol=5e-3, rtol=1e-3)
SIGMA = 2.0


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def fourier_cfgs(mod, basis=4, layers=2, width=128):
    kw = dict(num_early_layers=layers, num_filters=width, pos_enc="fourier",
              pos_enc_basis=basis, fourier_sigma=SIGMA)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def jax_params(seed=0, **kw):
    cs, ct = fourier_cfgs(jf, **kw)
    return (jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), cs)),
            jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), ct)))


def rays(r, s, seed=0):
    """Rays from -4.5 on z through the unit cube: coordinates in ~[-1, 1]."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.1, -0.2, -4.5]], np.float32), (r, 1))
    d = np.concatenate([rng.uniform(-0.1, 0.1, (r, 2)), np.ones((r, 1))], 1).astype(np.float32)
    z = np.sort(rng.uniform(3.6, 5.4, (r, s)), axis=1).astype(np.float32)
    return o, d, z, rng.integers(0, 10, r).astype(np.int32)


def compare_trees(got, want, **tol):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(want)[0], fg, fw):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **tol)


def torch_grads(trees, fn, cot):
    """Grads of sum(out_i * cot_i) w.r.t. each tree in the JAX layout, a
    zero for the fourier projection (a buffer, as JAX's VJP gives it)."""
    for tree in trees:
        for name, x in ts.param_items({"f": tree}):
            if not ts.is_buffer(name):
                x.requires_grad_(True)
    out = fn(*trees)
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cot)).backward()

    def grad(x):
        return torch.zeros_like(x) if x.grad is None else x.grad

    return [tf.params_to_jax(jax.tree.map(grad, t)) for t in trees], out


# ---------------------------------------------------------------------------
# Draws, projection, encoding, fields


@pytest.mark.parametrize("seed,shape", [(0, (60000,)), (7, (300, 200)), (2 ** 31 - 1, (50000,))])
def test_normal_matches_jax_bitwise(seed, shape):
    # 170,000 draws over three keys: XLA's f32 erf_inv transcribed (Giles'
    # polynomial over Cephes' log1p and log, multiply-adds fused) gives
    # every one of them exactly
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = prng.normal(prng.key(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("basis,sigma", [(1, 2.0), (12, 2.0), (21, 0.5)])
def test_fourier_coefficients_match_jax_bitwise(basis, sigma):
    want = np.asarray(jenc.make_fourier_coefficients(jax.random.PRNGKey(3), basis, sigma))
    got = tenc.make_fourier_coefficients(prng.key(3), basis, sigma).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("basis", [1, 4, 12])
def test_posenc_fourier_matches_jax(basis):
    rng = np.random.default_rng(basis)
    x = rng.uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    coef = np.asarray(jenc.make_fourier_coefficients(jax.random.PRNGKey(1), basis, SIGMA))
    want = np.asarray(jenc.posenc(jnp.asarray(x), "fourier", basis,
                                  fourier_coefficients=jnp.asarray(coef)))
    got = tenc.posenc(torch.tensor(x), "fourier", basis,
                      fourier_coefficients=torch.tensor(coef)).numpy()
    assert got.shape == (5, 7, 6 * basis) == want.shape
    assert tenc.encoded_feature_count("fourier", basis) == 6 * basis
    np.testing.assert_allclose(got, want, atol=POSENC_ATOL, rtol=0)
    with pytest.raises(ValueError):
        tenc.posenc(torch.tensor(x), "fourier", basis)


@pytest.mark.parametrize("kind", ["static", "temp"])
def test_fourier_field_init_matches_jax_bitwise(kind):
    cs, ct = fourier_cfgs(tf, basis=12, width=16)
    js_cfg, jt_cfg = fourier_cfgs(jf, basis=12, width=16)
    if kind == "static":
        want = jf.init_static_field(jax.random.PRNGKey(5), js_cfg)
        got = tf.init_static_field(prng.key(5), cs)
    else:
        want = jf.init_temporal_field(jax.random.PRNGKey(5), jt_cfg)
        got = tf.init_temporal_field(prng.key(5), ct)
    assert got["fourier"].shape == (36,)
    got, want = tf.params_to_jax(got), jax.tree.map(np.asarray, want)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("kind", ["static", "temp"])
def test_fourier_fields_match_jax(kind):
    ps, pt = jax_params(2, width=16)
    cs, ct = fourier_cfgs(tf, width=16)
    js_cfg, jt_cfg = fourier_cfgs(jf, width=16)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (4, 9, 3)).astype(np.float32)
    ph = rng.integers(0, 10, (4, 9)).astype(np.int32)
    if kind == "static":
        want = jf.apply_static_field(ps, jnp.asarray(pts), js_cfg)
        got = tf.apply_static_field(tf.params_from_jax(ps), torch.tensor(pts), cs)
    else:
        want = jf.apply_temporal_field(pt, jnp.asarray(pts), jnp.asarray(ph), jt_cfg)
        got = tf.apply_temporal_field(tf.params_from_jax(pt), torch.tensor(pts),
                                      torch.tensor(ph), ct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_fourier_is_inside_the_kernel_envelopes():
    cs, ct = fourier_cfgs(tf, basis=12)
    assert tff.kernel_supported(cs) and tff.kernel_supported(ct)
    # 6 * 21 = 126 encoded features fit, 6 * 22 = 132 do not (Pallas: 128)
    assert tff.kernel_supported(dataclasses.replace(cs, pos_enc_basis=21))
    assert not tff.kernel_supported(dataclasses.replace(cs, pos_enc_basis=22))
    assert jff.pallas_supported(fourier_cfgs(jf, basis=21)[0])
    assert not jff.pallas_supported(fourier_cfgs(jf, basis=22)[0])
    assert tk3.fused_train_supported(cs, ct, ts.CompositeHParams(**K3_HP))
    assert ts.field_window(cs, 10) is None


# ---------------------------------------------------------------------------
# The entries' plain twins against JAX's Pallas entries (interpret mode)


def test_fourier_ray_form_matches_jax_pallas():
    r, s = 3, 40
    ps, pt = jax_params(3)
    o, d, z, ph = rays(r, s, 3)
    js_cfg, jt_cfg = fourier_cfgs(jf)
    ts_cfg, tt_cfg = fourier_cfgs(tf)
    cot = [np.random.default_rng(4).standard_normal((r, s, 1)).astype(np.float32)
           for _ in range(2)]

    def jax_fn(a, b):
        return jff.fused_composite_fields_rays(a, b, jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(z), jnp.asarray(ph), js_cfg, jt_cfg,
                                               None, None, tile=128)

    want, vjp = jax.vjp(jax_fn, ps, pt)
    want_grads = vjp(tuple(jnp.asarray(c) for c in cot))

    def torch_fn(a, b):
        return tff.fused_composite_fields_rays(a, b, torch.tensor(o), torch.tensor(d),
                                               torch.tensor(z), torch.tensor(ph), ts_cfg, tt_cfg,
                                               None, None)

    grads, got = torch_grads([tf.params_from_jax(ps), tf.params_from_jax(pt)], torch_fn, cot)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=FWD_KERNEL_ATOL,
                                   rtol=0)
    for g, wg in zip(grads, want_grads):
        compare_trees(g, wg, **GRAD_KERNEL_TOL)
        # JAX's kernel returns a zero cotangent for the projection
        np.testing.assert_array_equal(np.asarray(wg["fourier"]), 0.0)


@pytest.mark.parametrize("basis,layers", [(4, 2), (12, 1)])
def test_fourier_static_entry_matches_jax_pallas(basis, layers):
    r, s = 2, 64
    ps, _ = jax_params(5, basis=basis, layers=layers)
    o, d, z, _ = rays(r, s, 5)
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).astype(np.float32)
    js_cfg, _ = fourier_cfgs(jf, basis=basis, layers=layers)
    ts_cfg, _ = fourier_cfgs(tf, basis=basis, layers=layers)
    cot = np.random.default_rng(6).standard_normal((r, s, 1)).astype(np.float32)

    def jax_fn(a):
        return jff.fused_static_field(a, jnp.asarray(pts), js_cfg, None, tile=128)

    want, vjp = jax.vjp(jax_fn, ps)
    (want_grads,) = vjp(jnp.asarray(cot))
    (grads,), (got,) = torch_grads(
        [tf.params_from_jax(ps)],
        lambda a: (tff.fused_static_field(a, torch.tensor(pts), ts_cfg, None),), [cot])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_KERNEL_ATOL,
                               rtol=0)
    compare_trees(grads, want_grads, **GRAD_KERNEL_TOL)


@pytest.mark.parametrize("hull", [False, True])
def test_fourier_k3_matches_jax_pallas(hull):
    from nerfca_tpu.ops.hull import MotionHull as JHull
    from nerfca_tpu_torch.ops.hull import MotionHull as THull
    from tests.test_torch_fused_train import hull_grid, problem

    ps, pt = jax_params(0)
    _, _, b, z = problem()
    step = 57
    jhp, thp = js.CompositeHParams(**K3_HP), ts.CompositeHParams(**K3_HP)
    w = js.loss_weights(jnp.int32(step), jhp)
    names = ["favor_s", "dynamic_entro", "occl", "l1"] + (["hull_static_l1"] if hull else [])
    lw = np.array([float(w[k]) for k in names], np.float32)
    jh = th = None
    if hull:
        grid, dv = hull_grid("random")
        jh = JHull(jnp.asarray(grid), jnp.full((3,), dv, jnp.float32), jnp.zeros(3, jnp.float32))
        th = THull(torch.tensor(grid), torch.full((3,), dv), torch.zeros(3))
    cs, ct = fourier_cfgs(jf)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jout = jax_k3(ps, pt, jb["origins"], jb["directions"], jnp.asarray(z), jb["phases"],
                  jb["pixels"], jb["weights"], jb["initial_intensities"], cs, ct, None, None,
                  jnp.asarray(lw), jhp, hull=jh)
    cs, ct = fourier_cfgs(tf)
    tb = {k: torch.tensor(v) for k, v in b.items()}
    tout = tk3.fused_train_loss_and_grads(
        tf.params_from_jax(ps), tf.params_from_jax(pt), tb["origins"], tb["directions"],
        torch.tensor(z), tb["phases"], tb["pixels"], tb["weights"], tb["initial_intensities"],
        cs, ct, None, None, torch.tensor(lw), thp, hull=th)
    assert_match(jout, tout)
    for g in tout[2:]:
        assert torch.equal(g["fourier"], torch.zeros(12))


# ---------------------------------------------------------------------------
# The projection as a buffer: Adam, checkpoints, optax state, steps


def test_fourier_projection_is_a_buffer(tmp_path):
    ps, pt = jax_params(1, width=16)
    params = {"static": tf.params_from_jax(ps), "temp": tf.params_from_jax(pt)}
    names = [n for n, _ in ts.param_items(params)]
    # the JAX tree's sorted position: after the early layers, before out
    assert names.index("static/fourier") == names.index("static/out/b") - 1
    assert names.index("temp/fourier") < names.index("temp/latents")
    cs, ct = fourier_cfgs(tf, width=16)
    cfgs = {"static": cs, "temp": ct}
    r = 8
    o, d, zz, ph = rays(r, 32, 1)
    batch = {"origins": torch.tensor(o), "directions": torch.tensor(d),
             "phases": torch.tensor(ph), "pixels": torch.full((r,), 2.1),
             "weights": torch.ones(r), "initial_intensities": torch.full((r,), 2.16)}
    hp = ts.CompositeHParams(img_sample_size=r, depth_samples_coarse=32)
    z = torch.tensor(zz[0])
    _, _, grads = ts.composite_grads(params, batch, z, 5, cfgs, hp)
    for (n, _), g in zip(ts.param_items(params), grads):
        assert ts.is_buffer(n) == torch.equal(g, torch.zeros_like(g)), n
    before = {k: params[k]["fourier"].clone() for k in params}
    opt = ts.init_opt_state(params)
    ts.adam_update(params, opt, grads, ts.make_optimizer(1e-3, 0.1, 100), 0, hp)
    for k in params:
        assert torch.equal(params[k]["fourier"], before[k])
    # the optax state of the JAX tree maps onto the port's leaves
    jparams = {"static": ps, "temp": pt}
    jstate = js.make_optimizer(1e-3, 0.1, 100).init(jax.tree.map(jnp.asarray, jparams))
    port_opt = ts.opt_state_from_jax(jstate)
    assert [tuple(t.shape) for t in port_opt["mu"]] == [tuple(t.shape) for _, t in
                                                        ts.param_items(params)]
    back = ts.opt_state_to_jax(port_opt, params)
    assert jax.tree_util.tree_structure(back["mu"]) == jax.tree_util.tree_structure(jparams)
    # a checkpoint round trip keeps the projection
    state = ts.TrainState(params, opt, 1, prng.key(2))
    tck.save_checkpoint(str(tmp_path / "c"), state, cfgs)
    fresh = {"static": tf.init_static_field(prng.key(9), cs),
             "temp": tf.init_temporal_field(prng.key(10), ct)}
    got = tck.load_checkpoint(str(tmp_path / "c"),
                              ts.TrainState(fresh, ts.init_opt_state(fresh), 0, prng.key(0)))
    for (n, a), (_, b) in zip(ts.param_items(got.params), ts.param_items(params)):
        assert torch.equal(a, b), n
    assert tck.load_field_configs(str(tmp_path / "c")) == cfgs


@pytest.mark.parametrize("n_steps,params_atol", [(1, 1e-6), (3, 1e-5)])
def test_fourier_static_steps_match_jax(n_steps, params_atol):
    table = ray_table()
    jc, _ = fourier_cfgs(jf)
    tc, _ = fourier_cfgs(tf)
    key = jax.random.PRNGKey(4)
    jparams = {"static": jf.init_static_field(key, jc)}
    jtx = js.make_optimizer(1e-3, 0.01, 100)
    jstate = js.TrainState(jparams, jtx.init(jparams), jnp.zeros((), jnp.int32), key)
    jstep = jax.jit(js.make_static_train_step(jc, static_hparams(js, False), jtx,
                                              j_linspace(3.6, 5.4, 32), 2.16))
    zero = np.zeros(1, np.int32)
    jd = [jnp.asarray(a) for a in (table, np.zeros(len(table), np.int32), zero, zero)]
    tparams = {"static": tf.init_static_field(prng.key(4), tc)}
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0, prng.key(4))
    tstep = ts.make_static_train_step(tc, static_hparams(ts, True), ts.make_optimizer(
        1e-3, 0.01, 100), linspace_depths(3.6, 5.4, 32), 2.16)
    td = [torch.tensor(table), torch.zeros(len(table), dtype=torch.int64),
          torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)]
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, *jd)
        tm = tstep(tstate, *td)
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]),
                                   rtol=LOSS_RTOL * n_steps, atol=0)
    compare_trees(tf.params_to_jax(tstate.params["static"]),
                  jax.tree.map(np.asarray, jstate.params["static"]), atol=params_atol, rtol=0)
    np.testing.assert_array_equal(tstate.params["static"]["fourier"].numpy(),
                                  np.asarray(jparams["static"]["fourier"]))


@pytest.mark.parametrize("fused", [False, True])
def test_fourier_composite_steps_match_jax(fused):
    # the port's plain path and its K3 twin (CPU tensors) against JAX's
    # plain composite step, two steps from the same seed
    hp_kw = dict(img_sample_size=16, depth_samples_coarse=32, favor_s_weight_start=1e-3,
                 favor_s_weight_end=1e-3, dynamic_entro_weight_start=1e-4,
                 dynamic_entro_weight_end=1e-4, occl_weight_start=1e-4, occl_weight_end=1e-4,
                 l1_weight_start=1e-6, l1_weight_end=1e-6, hyperparam_decay_steps=100)
    jcs, jct = fourier_cfgs(jf)
    tcs, tct = fourier_cfgs(tf)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    jparams = {"static": jf.init_static_field(keys[0], jcs),
               "temp": jf.init_temporal_field(keys[1], jct)}
    jtx = js.make_optimizer(1e-3, 0.01, 100)
    jstate = js.TrainState(jparams, jtx.init(jparams), jnp.zeros((), jnp.int32), keys[2])
    jstep = jax.jit(js.make_composite_train_step({"static": jcs, "temp": jct},
                                                 js.CompositeHParams(**hp_kw), jtx,
                                                 j_linspace(3.6, 5.4, 32), 2.16))
    table, phases = synthetic_rays(128)
    zero = jnp.zeros(1, jnp.int32)
    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in jparams.items()}
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0,
                           np.asarray(jax.random.key_data(keys[2])))
    thp = ts.CompositeHParams(**hp_kw, use_pallas=fused, use_fused_loss=fused)
    tstep = ts.make_composite_train_step({"static": tcs, "temp": tct}, thp,
                                         ts.make_optimizer(1e-3, 0.01, 100),
                                         linspace_depths(3.6, 5.4, 32), 2.16)
    td = [torch.tensor(np.asarray(table)), torch.tensor(np.asarray(phases)).long(),
          torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)]
    for i in range(2):
        jstate, jm = jstep(jstate, table, phases, zero, zero)
        tm = tstep(tstate, *td)
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]),
                                   rtol=2 * LOSS_RTOL, atol=0)
    for k in ("static", "temp"):
        compare_trees(tf.params_to_jax(tstate.params[k]), jax.tree.map(np.asarray,
                                                                       jstate.params[k]),
                      atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# run_eval of a fourier checkpoint


def test_run_eval_scores_a_fourier_checkpoint_as_jax_does(tmp_path):
    data_root = str(tmp_path / "data")
    argv = ["--config", SMALL, "--data_root", data_root, *FAST_DATA,
            "--static_pos_enc", "fourier", "--temp_pos_enc", "fourier",
            "--static_pos_enc_fourier_sigma", "2", "--temp_pos_enc_fourier_sigma", "2"]
    build_dataset(tcfg.parse_args(argv), data_root, projector_samples=40)
    jargs = jcfg.parse_args(argv)
    cfgs = jax_field_configs(jargs)
    params = {"static": jf.init_static_field(jax.random.PRNGKey(3), cfgs["static"]),
              "temp": jf.init_temporal_field(jax.random.PRNGKey(4), cfgs["temp"])}
    run = {"data_name": "SYNTH", "step": 150}
    jck.save_checkpoint(str(tmp_path / "jax"), js.TrainState(
        params, js.make_optimizer(1e-3, 0.01, 300).init(params), jnp.int32(150),
        jax.random.PRNGKey(0)), cfgs, run_metadata=run)
    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in params.items()}
    tcfgs = tck.load_field_configs(str(tmp_path / "jax"))
    assert tcfgs["static"].pos_enc == "fourier" and tcfgs["static"].fourier_sigma == 2.0
    tck.save_checkpoint(str(tmp_path / "torch"), ts.TrainState(
        tparams, ts.init_opt_state(tparams), 150, prng.key(0)), tcfgs, run_metadata=run)
    scores = {}
    for pkg, fn, parse, extra in (("jax", jre.evaluate_checkpoint, jcfg.parse_args, []),
                                  ("torch", tre.evaluate_checkpoint, tcfg.parse_args,
                                   ["--platform", "cpu"])):
        fn(parse(argv + ["--resume_from", str(tmp_path / pkg), *extra]), write_images=False)
        with open(os.path.join(str(tmp_path / pkg), "eval", "eval_scores.json")) as f:
            scores[pkg] = json.load(f)
    for k in ("mean_psnr", "mean_ssim"):
        np.testing.assert_allclose(scores["torch"][k], scores["jax"][k], rtol=1e-4, err_msg=k)
