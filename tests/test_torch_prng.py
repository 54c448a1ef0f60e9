"""The port's host-side copy of jax.random (ops/prng.py) against jax.random,
and what rests on it: the fields' init, the trainer's initial state, one
step's draws, and several train steps that follow the JAX step's."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.sampling import linspace_depths
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import step as js
from nerfca_tpu.train import trainer as jtr
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import step as ts
from nerfca_tpu_torch.train import trainer as ttr
from tests.test_torch_step import cfgs as step_cfgs
from tests.test_torch_trainer import SMALL
from tests.test_train_step import synthetic_rays

SEEDS = [0, 1, 7, 123456789]


def key_data(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_match_jax(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key(seed), key_data(seed))
    for num in (2, 4, 8):
        np.testing.assert_array_equal(prng.split(prng.key(seed), num),
                                      np.asarray(jax.random.split(k, num)))
    for data in (1, 0x71, 2 ** 31 + 5):
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data),
                                      np.asarray(jax.random.fold_in(k, data)))


@pytest.mark.parametrize("shape", [(5,), (500,), (1024, 2), (10, 8), (83, 128)])
def test_bits_and_uniform_match_jax_bitwise(shape):
    for seed in SEEDS:
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(prng.bits(key_data(seed), shape),
                                      np.asarray(jax.random.bits(k, shape, jnp.uint32)))
        np.testing.assert_array_equal(prng.uniform(key_data(seed), shape),
                                      np.asarray(jax.random.uniform(k, shape)))
        # the fields' init bounds: the scaled draw is one fused multiply-add
        bound = np.float32(1.0) / np.sqrt(np.float32(shape[0]))
        got = prng.uniform(key_data(seed), shape, -bound, bound)
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, -bound, bound))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("span", [1, 3, 40, 83870, 316130, 2 ** 31 - 1])
def test_randint_matches_jax(span):
    for seed in SEEDS:
        np.testing.assert_array_equal(
            prng.randint(key_data(seed), (512,), 0, span),
            np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (512,), 0, span)))


def test_bits_segments_equal_separate_draws():
    keys = prng.split(prng.key(5), 3)
    got = prng.bits_segments([(keys[0], 7), (keys[1], 1), (keys[2], 300)])
    want = np.concatenate([prng.bits(keys[0], 7), prng.bits(keys[1], 1),
                           prng.bits(keys[2], 300)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["static", "temp"])
def test_field_init_draws_the_jax_params(kind):
    cfg = step_cfgs(jf)[kind]
    init_j = jf.init_static_field if kind == "static" else jf.init_temporal_field
    init_t = tf.init_static_field if kind == "static" else tf.init_temporal_field
    want = tf.params_from_jax(jax.tree.map(np.asarray, init_j(jax.random.PRNGKey(4), cfg)))
    got = init_t(prng.key(4), step_cfgs(tf)[kind])
    for (name, a), (_, b) in zip(ts.param_items({kind: got}), ts.param_items({kind: want})):
        assert torch.equal(a, b), name


def test_initial_state_is_the_jax_trainers():
    argv = ["--config", SMALL, "--seed", "3"]
    jargs, targs = jcfg.parse_args(argv), tcfg.parse_args(argv)
    jstate = jtr._init_composite_state(jargs, jtr.field_configs_from_args(jargs),
                                       js.make_optimizer(1e-3, 0.01, 300))
    tstate = ttr._init_composite_state(targs, ttr.field_configs_from_args(targs), None,
                                       torch.device("cpu"))
    want = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in jstate.params.items()}
    for (name, a), (_, b) in zip(ts.param_items(tstate.params), ts.param_items(want)):
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(tstate.rng, np.asarray(jax.random.key_data(jstate.rng)))


def test_step_draws_are_the_jax_steps():
    # the next key, the jitter uniforms (from fold_in(k_fine, 1)) and the
    # depth uniforms of nerfca_tpu/train/step.py:663-682
    hp = ts.CompositeHParams(img_sample_size=64, nb_var_rays=20, depth_samples_coarse=48,
                             ray_jitter=1e-3)
    rng = jax.random.PRNGKey(11)
    nxt, k_sample, k_depth, k_fine = jax.random.split(rng, 4)
    new, _, u, t = ts.step_draws(np.asarray(jax.random.key_data(rng)), hp, 30, 70, 100, 48)
    np.testing.assert_array_equal(new, np.asarray(jax.random.key_data(nxt)))
    np.testing.assert_array_equal(u, np.asarray(
        jax.random.uniform(jax.random.fold_in(k_fine, 1), (64, 2))))
    np.testing.assert_array_equal(t, np.asarray(jax.random.uniform(k_depth, (48,))))
    _, _, u, _ = ts.step_draws(np.asarray(jax.random.key_data(rng)),
                               ts.CompositeHParams(img_sample_size=64), 0, 0, 100, 48)
    assert u is None


def test_train_steps_follow_the_jax_steps():
    # six steps of the port's train step and of the JAX train step from the
    # same state and seed (variance split, jitter, a short schedule that
    # crosses the favor delay and the window opening): the losses within
    # 1e-5 relative and the params within 1e-5 of each leaf's scale
    kw = dict(num_early_layers=2, num_filters=16, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=20)
    jcfgs = {"static": jf.FieldConfig(**kw),
             "temp": jf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}
    tcfgs = {"static": tf.FieldConfig(**kw),
             "temp": tf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}
    common = dict(img_sample_size=64, nb_var_rays=32, depth_samples_coarse=32, ray_jitter=1e-3,
                  favor_s_weight_start=1e-3, favor_s_weight_end=1e-2,
                  favor_s_weight_delay_steps=3, dynamic_entro_weight_start=1e-3,
                  occl_weight_start=1e-2, occl_weight_end=1e-1, l1_weight_start=1e-4,
                  hyperparam_decay_steps=10, entro_use_weighting=True,
                  entro_weighted_thresh=0.03, occl_reg_perc=0.2)
    rays, phases = synthetic_rays(512)
    rays = np.asarray(rays).copy()
    rays[:200, 3, :] = 1.5
    var_ids, non_var = np.arange(200), np.arange(200, 512)
    z = linspace_depths(3.6, 5.4, 32)

    jtx = js.make_optimizer(1e-2, 0.1, 10)
    jstep = jax.jit(js.make_composite_train_step(jcfgs, js.CompositeHParams(**common), jtx, z,
                                                 2.16))
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    params = {"static": jf.init_static_field(keys[0], jcfgs["static"]),
              "temp": jf.init_temporal_field(keys[1], jcfgs["temp"])}
    jstate = js.TrainState(params, jtx.init(params), jnp.int32(0), keys[7])

    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in params.items()}
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0,
                           np.asarray(jax.random.key_data(keys[7])))
    tstep = ts.make_composite_train_step(tcfgs, ts.CompositeHParams(**common),
                                         ts.make_optimizer(1e-2, 0.1, 10),
                                         torch.tensor(np.asarray(z)), 2.16)
    args = (torch.tensor(rays), torch.tensor(np.asarray(phases)), torch.tensor(var_ids),
            torch.tensor(non_var))
    for _ in range(6):
        jstate, jm = jstep(jstate, jnp.asarray(rays), phases, jnp.asarray(var_ids, jnp.int32),
                           jnp.asarray(non_var, jnp.int32))
        tm = tstep(tstate, *args)
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tstate.rng, np.asarray(jax.random.key_data(jstate.rng)))
    got = {k: tf.params_to_jax(v) for k, v in tstate.params.items()}
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jstate.params)[0],
                            jax.tree_util.tree_leaves(got)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), path
