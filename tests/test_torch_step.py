"""The torch port's composite train step against the JAX step, one step at
a time on injected batches and depths (torch and JAX random numbers never
agree, so nothing here compares trajectories)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.hull import MotionHull as JHull
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads as jax_k3
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops.hull import MotionHull as THull
from nerfca_tpu_torch.parallel import make_mesh, multihost
from nerfca_tpu_torch.train import step as ts
from tests.test_torch_parallel import free_port

WEIGHTS = {
    # configs/composite.txt's schedule on a short decay
    "shipped": dict(favor_s_weight_start=1e-12, favor_s_weight_end=1e-10,
                    favor_s_weight_delay_steps=10, dynamic_entro_weight_start=1e-10,
                    dynamic_entro_weight_end=1e-8, occl_weight_start=1e-8,
                    occl_weight_end=1e-4, l1_weight_start=1e-8, l1_weight_end=1e-15),
    # weights large enough that every regularizer moves the loss and grads
    "strong": dict(favor_s_weight_start=1e-3, favor_s_weight_end=1e-2,
                   favor_s_weight_delay_steps=10, dynamic_entro_weight_start=1e-3,
                   dynamic_entro_weight_end=1e-2, occl_weight_start=1e-2,
                   occl_weight_end=1e-1, l1_weight_start=1e-4, l1_weight_end=1e-3,
                   static_tv_weight_start=1e-3, static_tv_weight_end=1e-3),
}
ENTROPY_TERMS = {"train_s_entropy_loss", "train_d_entropy_loss", "train_favor_s_loss"}
HULL_L1 = dict(hull_static_l1_weight_start=1e-3, hull_static_l1_weight_end=1e-3)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def hparams(mod, weights="shipped", **kw):
    base = dict(img_sample_size=4, depth_samples_coarse=48, hyperparam_decay_steps=100,
                entro_mask_thre=1e-4, entro_use_weighting=True, entro_weighted_thresh=0.03,
                occl_reg_perc=0.2, **WEIGHTS[weights])
    base.update(kw)
    if mod is js:
        base["pallas_tile"] = 128
    return mod.CompositeHParams(**base)


def cfgs(mod, basis=4, layers=2):
    kw = dict(num_early_layers=layers, num_filters=128, pos_enc="free_windowed",
              pos_enc_basis=basis, pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return {"static": mod.FieldConfig(**kw),
            "temp": mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}


def problem(seed=0, r=4, s=48):
    c = cfgs(jf)
    params = {"static": jf.init_static_field(jax.random.PRNGKey(seed), c["static"]),
              "temp": jf.init_temporal_field(jax.random.PRNGKey(seed + 1), c["temp"])}
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    batch = {
        "origins": np.tile(np.array([[0.05, -0.1, -4.5]], np.float32), (r, 1)),
        "directions": np.concatenate([rng.uniform(-0.08, 0.08, (r, 2)), np.ones((r, 1))],
                                     1).astype(np.float32),
        "pixels": (2.16 - rng.uniform(0, 0.5, r)).astype(np.float32),
        "weights": rng.choice([1.0, 1.5, 2.0], r).astype(np.float32),
        "phases": rng.integers(0, 10, r).astype(np.int32),
        "initial_intensities": np.full((r,), 2.16, np.float32),
    }
    base = np.linspace(3.6, 5.4, s).astype(np.float32)
    mids = 0.5 * (base[1:] + base[:-1])
    lo, hi = np.concatenate([base[:1], mids]), np.concatenate([mids, base[-1:]])
    z = (lo + (hi - lo) * rng.random(s)).astype(np.float32)
    return params, batch, z


def torch_params(params):
    return {k: tf.params_from_jax(v) for k, v in params.items()}


def grads_as_jax(tparams, grads):
    by_id = {id(t): g for (_, t), g in zip(ts.param_items(tparams), grads)}
    return {k: tf.params_to_jax(jax.tree.map(lambda x: by_id[id(x)], v))
            for k, v in tparams.items()}


def hulls(seed=9):
    """The same random gate grid for both packages, covering the rays of
    :func:`problem` (res 6, 0.5 voxels around the origin)."""
    grid = (0.2 + 0.8 * np.random.default_rng(seed).random((6, 6, 6))).astype(np.float32)
    return (JHull(jnp.asarray(grid), jnp.full((3,), 0.5, jnp.float32), jnp.zeros(3, jnp.float32)),
            THull(torch.tensor(grid), torch.full((3,), 0.5), torch.zeros(3)))


def run_both(weights, use_pallas, step=50, hull=False, **kw):
    params, batch, z = problem()
    jh, th = hulls() if hull else (None, None)
    jhp = hparams(js, weights, use_pallas=use_pallas, **kw)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: js.composite_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z), jnp.int32(step), cfgs(jf), jhp, hull=jh),
        has_aux=True)(params)
    tparams = torch_params(params)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    tloss, tm, tg = ts.composite_grads(tparams, tbatch, torch.tensor(z), step, cfgs(tf),
                                       hparams(ts, weights, use_pallas=use_pallas, **kw), hull=th)
    return (float(jloss), jm, jg), (float(tloss), tm, grads_as_jax(tparams, tg))


def assert_metrics_match(jl, jm, tl, tm):
    # rel 1e-5 on the loss and every metric; 1e-4 on the entropy terms (sums
    # of p log p whose log amplifies the last-bit differences of p)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    assert set(tm) == set(jm)
    for k in jm:
        rtol = 1e-4 if k in ENTROPY_TERMS else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=0, err_msg=k)


def assert_grads_match(jg, tg, bound):
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(tg)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= bound * max(np.abs(b).max(), 1e-30), path


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("weights", ["shipped", "strong"])
def test_loss_and_metrics_match(weights, use_pallas):
    (jl, jm, _), (tl, tm, _) = run_both(weights, use_pallas)
    assert_metrics_match(jl, jm, tl, tm)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("weights", ["shipped", "strong"])
def test_grads_match(weights, use_pallas):
    # as the fields: per leaf, max-abs diff <= 1e-4 x the leaf's scale; with
    # the JAX kernel in interpret mode (double-angle encoding) <= 1e-3
    (_, _, jg), (_, _, tg) = run_both(weights, use_pallas)
    assert_grads_match(jg, tg, 1e-3 if use_pallas else 1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_hull_through_composite_loss(use_pallas):
    # the gated dynamic density and the hull-gated static L1 through the
    # two-kernel / plain loss: loss, every metric (train_hull_s_l1 > 0) and
    # grads at the tolerances above
    (jl, jm, jg), (tl, tm, tg) = run_both("strong", use_pallas, hull=True, **HULL_L1)
    assert float(tm["train_hull_s_l1"]) > 0
    assert_metrics_match(jl, jm, tl, tm)
    assert_grads_match(jg, tg, 1e-3 if use_pallas else 1e-4)


@pytest.mark.parametrize("hull", [False, True])
def test_fused_loss_step_matches_jax(hull):
    # the port's fused-loss path (plain K3 on the CPU) against JAX's
    # _fused_loss_metrics_grads (the Pallas K3 in interpret mode): the same
    # metric keys, values as above, grads within 1e-3 of each leaf's scale
    params, batch, z = problem()
    jh, th = hulls() if hull else (None, None)
    kw = dict(use_pallas=True, use_fused_loss=True, **HULL_L1)
    jl, jm, jg = js._fused_loss_metrics_grads(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z), jnp.int32(50),
        cfgs(jf), hparams(js, **kw), None, jax_k3, 2, hull=jh)
    tparams = torch_params(params)
    tl, tm, tg = ts._fused_loss_metrics_grads(
        tparams, {k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(z), 50, cfgs(tf),
        hparams(ts, **kw), hull=th)
    assert (float(tm["train_hull_s_l1"]) > 0) == hull
    assert_metrics_match(float(jl), jm, float(tl), tm)
    assert_grads_match(jg, grads_as_jax(tparams, tg), 1e-3)


def test_fused_loss_outside_envelope_warns_and_takes_two_kernel_path():
    c = cfgs(ts)
    tx = ts.make_optimizer(1e-3, 0.01, 300)
    hp = hparams(ts, "strong", use_pallas=True, use_fused_loss=True)  # static TV on
    with pytest.warns(UserWarning, match="envelope"):
        ts.make_composite_train_step(c, hp, tx, torch.linspace(3.6, 5.4, 48), 2.16)


@pytest.mark.parametrize("step", [0, 5, 10, 60, 100, 400])
def test_schedules_and_windows(step):
    jhp, thp = hparams(js, "shipped"), hparams(ts, "shipped")
    jw, tw = js.loss_weights(jnp.int32(step), jhp), ts.loss_weights(step, thp)
    assert set(jw) == set(tw)
    for k in jw:
        np.testing.assert_allclose(tw[k], float(jw[k]), rtol=1e-6, atol=0, err_msg=k)
    for k in ("static", "temp"):
        np.testing.assert_allclose(ts.field_window(cfgs(ts)[k], step),
                                   js.field_window(cfgs(js)[k], step), atol=1e-6)
        np.testing.assert_allclose(ts.window_alpha(cfgs(ts)[k], step),
                                   float(js.window_alpha(cfgs(js)[k], step)), atol=1e-6)


def test_jitter_directions_with_injected_uniforms():
    rng = np.random.default_rng(4)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (6, 2)), np.ones((6, 1))], 1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    u = np.asarray(jax.random.uniform(key, (6, 2)))
    np.testing.assert_allclose(ts.jitter_directions(torch.tensor(d), 4e-4, u=torch.tensor(u)),
                               js.jitter_directions(key, jnp.asarray(d), 4e-4), atol=1e-6)


@pytest.mark.parametrize("nb_var_rays", [3, 0])
def test_sample_ray_batch_layout(nb_var_rays):
    # the step's draws from a key give the JAX step's batch from that key
    # (nerfca_tpu/train/step.py:663-665), bit for bit, in the same layout
    rays = torch.arange(40 * 12, dtype=torch.float32).reshape(40, 4, 3)
    phases = torch.arange(40, dtype=torch.int32) % 10
    hp = hparams(ts, img_sample_size=8, nb_var_rays=nb_var_rays)
    var_ids = torch.tensor([1, 5, 7])
    non_var = torch.tensor([i for i in range(40) if i not in (1, 5, 7)])
    key = jax.random.PRNGKey(3)
    _, pos, _, _ = ts.step_draws(np.asarray(jax.random.key_data(key)), hp, 3, 37, 40, 48)
    b = ts.sample_ray_batch(rays, phases, var_ids, non_var, torch.tensor(pos), hp)
    jb = js.sample_ray_batch(jax.random.split(key, 4)[1], jnp.asarray(rays.numpy()),
                             jnp.asarray(phases.numpy()), jnp.asarray(var_ids.numpy()),
                             jnp.asarray(non_var.numpy()),
                             hparams(js, img_sample_size=8, nb_var_rays=nb_var_rays))
    for k, v in jb.items():
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(v), err_msg=k)
    idx = (b["origins"][:, 0] / 12).long()
    if nb_var_rays:
        assert set(idx[:3].tolist()) <= {1, 5, 7} and not set(idx[3:].tolist()) & {1, 5, 7}
    torch.testing.assert_close(b["directions"], rays[idx][:, 1])
    torch.testing.assert_close(b["pixels"], rays[idx][:, 2, 0])
    torch.testing.assert_close(b["weights"], rays[idx][:, 3, 0])
    torch.testing.assert_close(b["phases"], phases[idx])


def test_learning_rate_is_optax_linear_schedule():
    tx = ts.make_optimizer(1e-3, 0.01, 300)
    sched = optax.linear_schedule(1e-3, 1e-5, 300)
    for count in (0, 1, 150, 299, 300, 1000):
        np.testing.assert_allclose(tx.learning_rate(count), float(sched(count)), rtol=1e-6)


@pytest.mark.parametrize("freeze", [0, 2])
def test_adam_update_and_static_freeze_match_optax(freeze):
    # given the SAME grads, three updates: params within 1e-6. Past the
    # freeze step the static params stop while their moments keep moving
    # (step.py:700-714), so the temporal params must still match exactly.
    params, _, _ = problem(seed=3)
    tparams = torch_params(params)
    jtx = js.make_optimizer(1e-3, 0.01, 300)
    opt = jtx.init(params)
    ttx = ts.make_optimizer(1e-3, 0.01, 300)
    topt = ts.init_opt_state(tparams)
    thp = hparams(ts, static_freeze_step=freeze)
    rng = np.random.default_rng(5)
    for step in range(3):
        scale = 10.0 ** rng.integers(-9, 0)
        grads = jax.tree.map(lambda p: (rng.normal(size=p.shape) * scale).astype(np.float32),
                             params)
        updates, opt = jtx.update(grads, opt, params)
        gate = 0.0 if (freeze > 0 and step >= freeze) else 1.0
        updates = {k: jax.tree.map(lambda u: u * gate, v) if k.startswith("static") else v
                   for k, v in updates.items()}
        new = optax.apply_updates(params, updates)
        tgrads = [tf.params_from_jax(grads[name.split("/")[0]]) for name, _ in
                  ts.param_items(tparams)]
        flat = []
        for (name, _), gtree in zip(ts.param_items(tparams), tgrads):
            node = gtree
            for part in name.split("/")[1:]:
                node = node[int(part)] if part.isdigit() else node[part]
            flat.append(node)
        before = tf.params_to_jax(tparams["static"])
        ts.adam_update(tparams, topt, flat, ttx, step, thp)
        if freeze and step >= freeze:
            for a, b in zip(jax.tree_util.tree_leaves(tf.params_to_jax(tparams["static"])),
                            jax.tree_util.tree_leaves(before)):
                np.testing.assert_array_equal(a, b)
        params = jax.tree.map(np.asarray, new)
        got = {k: tf.params_to_jax(v) for k, v in tparams.items()}
        for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=str(path))
    assert topt["count"] == 3


def test_unported_options_raise():
    # the fine pass is ported: its step builds, and one step of it follows
    # JAX's (the loss within 1e-5 relative, the same next key); under a
    # data-parallel mesh it takes the autograd path, ported too: the step
    # raises only for a mesh without a 'data' axis
    c = {**cfgs(ts), **{f"{k}_fine": dataclasses.replace(v, num_filters=16)
                        for k, v in cfgs(ts).items()}}
    jc = {**cfgs(js), **{f"{k}_fine": dataclasses.replace(v, num_filters=16)
                         for k, v in cfgs(js).items()}}
    tx, jtx = ts.make_optimizer(1e-3, 0.01, 300), js.make_optimizer(1e-3, 0.01, 300)
    z = np.asarray(np.linspace(3.6, 5.4, 8), np.float32)
    thp = dataclasses.replace(hparams(ts), depth_samples_fine=8, depth_samples_coarse=8)
    jhp = dataclasses.replace(hparams(js), depth_samples_fine=8, depth_samples_coarse=8)
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    params = {"static": jf.init_static_field(keys[0], jc["static"]),
              "temp": jf.init_temporal_field(keys[1], jc["temp"]),
              "static_fine": jf.init_static_field(keys[2], jc["static_fine"]),
              "temp_fine": jf.init_temporal_field(keys[3], jc["temp_fine"])}
    rays = np.zeros((40, 4, 3), np.float32)
    rays[:, 0] = [0.05, -0.1, -4.5]
    rays[:, 1] = [0.01, -0.02, 1.0]
    rays[:, 2], rays[:, 3] = 2.0, 1.0
    rays[:, 1, 0] += np.linspace(-0.05, 0.05, 40, dtype=np.float32)
    phases = (np.arange(40) % 10).astype(np.int32)
    ids = np.arange(40)
    jstate, jm = js.make_composite_train_step(jc, jhp, jtx, jnp.asarray(z), 2.16)(
        js.TrainState(params, jtx.init(params), jnp.int32(0), keys[7]), jnp.asarray(rays),
        jnp.asarray(phases), jnp.asarray(ids, jnp.int32), jnp.asarray(ids, jnp.int32))
    tparams = torch_params(jax.tree.map(np.asarray, params))
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0,
                           np.asarray(jax.random.key_data(keys[7])))
    tm = ts.make_composite_train_step(c, thp, tx, torch.tensor(z), 2.16)(
        tstate, torch.tensor(rays), torch.tensor(phases), torch.tensor(ids), torch.tensor(ids))
    np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
    np.testing.assert_array_equal(tstate.rng, np.asarray(jax.random.key_data(jstate.rng)))
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(axis_names=("depth",), device="cpu")
        with pytest.raises(ValueError, match="'data'"):
            ts.make_composite_train_step(c, thp, tx, torch.tensor(z), 2.16, mesh=mesh)
    finally:
        dist.destroy_process_group()


def test_trainer_fused_loss_with_hull_runs_finite(tmp_path, capsys):
    # the CLI path on the CPU: --use_fused_loss with the motion hull carved
    # from a 10-phase SYNTH build (small volume projected with 40 samples per
    # ray to keep the build short; 2 steps of 32 rays x 32 samples, 128-wide
    # fields); both steps and the eval end finite
    import json
    import math
    import os

    from nerfca_tpu_torch.data.dataset import build_dataset
    from nerfca_tpu_torch.train import run_composite
    from nerfca_tpu_torch.train.config import parse_args

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    argv = [
        "--config", os.path.join(repo, "configs", "synth-small.txt"), "--platform", "cpu",
        "--use_pallas", "true", "--use_fused_loss", "true", "--use_motion_hull", "true",
        "--hull_res", "16", "--synth_vol_size", "20", "--depth_samples_per_ray_coarse", "32",
        "--img_sample_size", "32", "--static_num_filters", "128", "--temp_num_filters", "128",
        "--n_iters", "1", "--display_every", "2", "--log_every", "1",
        "--data_root", str(tmp_path / "data"), "--log_dir_root", str(tmp_path / "cases")]
    build_dataset(parse_args(argv), str(tmp_path / "data"), projector_samples=40)
    out = run_composite.main(argv)
    assert "motion hull carved: res=16" in capsys.readouterr().out
    assert out["setup"]["hull"] is not None and out["setup"]["hp"].use_fused_loss
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train_loss" in r]
    evals = [r for r in records if "test_image_psnr" in r]
    assert len(train) == 2 and all(math.isfinite(r["train_loss"]) for r in train)
    # the fused path's metric set: no static-TV entries, the real hull L1
    assert "train_static_tv" not in train[0] and train[0]["train_hull_s_l1"] > 0
    assert len(evals) == 1 and math.isfinite(evals[0]["test_image_psnr"])
