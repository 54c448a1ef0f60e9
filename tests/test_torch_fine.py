"""The torch port's fine pass (hierarchical sampling) against the JAX
package on the CPU: ``sample_pdf`` and its uniforms, the fine forward, the
kernels' twin at per-ray depths against JAX's Pallas ray entry (interpret
mode), one fine step's loss and gradients, train steps, the fine
initialisation and eval depths, the eval's fine terms, ``run_eval``'s fine
scores, checkpoints with fine leaves, a short ``train_composite`` and the
envelope rule that lets the coarse pair decide."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import functools
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops import sampling as jsm
from nerfca_tpu.train import checkpoint as jck
from nerfca_tpu.train import config as jcfg
from nerfca_tpu.train import evaluation as jev
from nerfca_tpu.train import run_eval as jre
from nerfca_tpu.train import step as js
from nerfca_tpu.train import trainer as jtr
from nerfca_tpu_torch.data.dataset import build_dataset
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops import sampling as tsm
from nerfca_tpu_torch.ops.cuda import fused_field as tff
from nerfca_tpu_torch.parallel import make_mesh, multihost
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import evaluation as tev
from nerfca_tpu_torch.train import run_composite
from nerfca_tpu_torch.train import run_eval as tre
from nerfca_tpu_torch.train import step as ts
from nerfca_tpu_torch.train import trainer as ttr
from tests.test_torch_parallel import free_port
from tests.test_torch_step import WEIGHTS, grads_as_jax, hparams, hulls, problem, torch_params
from tests.test_torch_trainer import FAST_DATA, SMALL

F = 8  # fine samples per ray
# the port's fine depths move with the last bits of the coarse density:
# sample_pdf's weights are differences of adjacent total sigmas, so a
# 2e-9 difference in a sigma of 1e-2 moved one fine depth by 1.1e-5
# (measured at problem()'s inputs); depths and dists are held at 1e-5 of
# the far depth
DEPTH_ATOL = 1e-5 * 5.4
FINE_ARGV = ["--depth_samples_per_ray_fine", str(F), "--static_num_filters_fine", "16",
             "--temp_num_filters_fine", "16"]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def fine_cfgs(mod, fine_width):
    kw = dict(num_early_layers=2, num_filters=128, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    c = {"static": mod.FieldConfig(**kw),
         "temp": mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)}
    c["static_fine"] = dataclasses.replace(c["static"], num_filters=fine_width)
    c["temp_fine"] = dataclasses.replace(c["temp"], num_filters=fine_width)
    return c


def fine_problem(fine_width, seed=0):
    """test_torch_step's problem (4 rays x 48 coarse samples) with a fine
    pair of ``fine_width`` and the key the fine uniforms come from."""
    params, batch, z = problem(seed)
    c = fine_cfgs(jf, fine_width)
    params["static_fine"] = jax.tree.map(
        np.asarray, jf.init_static_field(jax.random.PRNGKey(seed + 5), c["static_fine"]))
    params["temp_fine"] = jax.tree.map(
        np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 6), c["temp_fine"]))
    return params, batch, z, jax.random.PRNGKey(seed + 3)


def key_of(jkey):
    return np.asarray(jax.random.key_data(jkey))


# ---------------------------------------------------------------------------
# sample_pdf and its uniforms


def pdf_case(case, r=4, b=48, seed=0):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(3.6, 5.4, (r, b)), axis=1).astype(np.float32)
    w = (rng.random((r, b - 1)) ** 4).astype(np.float32)
    u = rng.random((r, F)).astype(np.float32)
    if case == "guard":
        # one interval holds almost all the mass: the others' CDF steps are
        # below 1e-5, so the denominator guard takes them
        w[:] = 0.0
        w[:, 5] = 1e6
        u[:, :4] = np.linspace(0.2, 0.9, 4)
        u[:, 4:] = np.array([0.99999, 0.999995, 0.9999995, 0.0])
    elif case == "clamp":
        # u at 0 and at (or past) the CDF's last entry: the below / above
        # indices clamp into the grid and into bins
        u[:, 0], u[:, 1], u[:, 2] = 0.0, 1.0, 0.99999994
    return bins, w, u


@pytest.mark.parametrize("case", ["random", "guard", "clamp"])
def test_sample_pdf_matches_jax(case):
    # injected uniforms; the CDF is summed in another order in the two
    # packages, so within 1e-6 relative
    bins, w, u = pdf_case(case)
    want = np.asarray(jsm.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), F,
                                     u=jnp.asarray(u)))
    got = tsm.sample_pdf(None, torch.tensor(bins), torch.tensor(w), F, u=torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_sample_pdf_draws_jax_uniforms_from_its_key():
    bins, w, _ = pdf_case("random")
    key = jax.random.PRNGKey(7)
    want = np.asarray(jsm.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), F))
    got = tsm.sample_pdf(key_of(key), torch.tensor(bins), torch.tensor(w), F)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_fine_uniforms_are_k_fine_bit_for_bit():
    # the step's k_fine is the fourth of four keys (nerfca_tpu/train/
    # step.py:663); sample_pdf draws uniform(k_fine, (n, F))
    rng = jax.random.PRNGKey(11)
    k_fine = jax.random.split(rng, 4)[3]
    hp = ts.CompositeHParams(img_sample_size=64, depth_samples_fine=F)
    np.testing.assert_array_equal(ts.fine_uniforms(key_of(rng), hp),
                                  np.asarray(jax.random.uniform(k_fine, (64, F))))


# ---------------------------------------------------------------------------
# The fine forward and the kernels' twin at per-ray depths


@pytest.mark.parametrize("hull", [False, True])
def test_fine_forward_matches_jax(hull):
    # plain fields: the renders and sigmas of both passes within 1e-5 of
    # their scale, the dists at DEPTH_ATOL
    params, batch, z, key = fine_problem(32)
    jh, th = hulls() if hull else (None, None)
    jc, tc = fine_cfgs(jf, 32), fine_cfgs(tf, 32)
    jhp, thp = hparams(js, depth_samples_fine=F), hparams(ts, depth_samples_fine=F)
    want = js.composite_forward(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        {k: js.field_window(jc[k], 50) for k in ("static", "temp")}, jc, jhp, key, hull=jh)
    u = torch.from_numpy(prng.uniform(key_of(key), (4, F)))
    got = ts.composite_forward(
        torch_params(params), {k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(z),
        {k: ts.field_window(tc[k], 50) for k in ("static", "temp")}, tc, thp, hull=th,
        u_fine=u)
    for name in ("pix", "static_sigma", "temp_sigma", "dists"):
        for pass_name in ("coarse", "fine"):
            a, b = got[f"{name}_{pass_name}"].detach().numpy(), np.asarray(
                want[f"{name}_{pass_name}"])
            atol = DEPTH_ATOL if name == "dists" else 1e-5 * np.abs(b).max()
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{name}_{pass_name}")


def per_ray_depths(seed=0, r=4, s=48):
    """Sorted per-ray depths as the fine pass builds them: stratified
    coarse depths and sample_pdf's draws."""
    bins, w, u = pdf_case("random", r, s, seed)
    z_pdf = tsm.sample_pdf(None, torch.tensor(bins), torch.tensor(w), F, u=torch.tensor(u))
    return torch.sort(torch.cat([z_pdf, torch.tensor(bins)], -1), -1).values.numpy()


def test_twin_at_per_ray_depths_matches_pallas_ray_entry():
    # the twin of K1/K2 with per-ray [R, S + F] depths against JAX's Pallas
    # ray entry in interpret mode: raw densities and every gradient leaf
    # within 1e-5 of its scale
    c = fine_cfgs(jf, 128)
    tcfg_ = fine_cfgs(tf, 128)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(1), c["static"]))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(2), c["temp"]))
    params, batch, _ = problem()
    z = per_ray_depths()
    win = np.asarray(js.field_window(c["static"], 50))
    g = np.random.default_rng(3).standard_normal((2, 4, z.shape[1], 1)).astype(np.float32)

    def jax_loss(p_s, p_t):
        a, b = jff.fused_composite_fields_rays(
            p_s, p_t, jnp.asarray(batch["origins"]), jnp.asarray(batch["directions"]),
            jnp.asarray(z), jnp.asarray(batch["phases"]), c["static"], c["temp"],
            jnp.asarray(win), jnp.asarray(win), tile=128)
        return jnp.sum(a * g[0]) + jnp.sum(b * g[1]), (a, b)

    (_, (ja, jb)), (jgs, jgt) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(ps, pt)
    tp = {"static": tf.params_from_jax(ps), "temp": tf.params_from_jax(pt)}
    ts._require_grads(tp)
    ta, tb = tff.fused_composite_fields_rays(
        tp["static"], tp["temp"], torch.tensor(batch["origins"]),
        torch.tensor(batch["directions"]), torch.tensor(z), torch.tensor(batch["phases"]),
        tcfg_["static"], tcfg_["temp"], torch.tensor(win), torch.tensor(win))
    for x, y in ((ta, ja), (tb, jb)):
        y = np.asarray(y)
        np.testing.assert_allclose(x.detach().numpy(), y, atol=1e-5 * np.abs(y).max(), rtol=0)
    loss = (ta * torch.tensor(g[0])).sum() + (tb * torch.tensor(g[1])).sum()
    tg = grads_as_jax(tp, ts._grads_of(loss, tp))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path({"static": jgs, "temp": jgt})[0],
                            jax.tree_util.tree_leaves(tg)):
        b = np.asarray(b)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), path


# ---------------------------------------------------------------------------
# One fine step, and train steps


def run_fine_both(weights, use_pallas, fine_width, hull=False):
    params, batch, z, key = fine_problem(fine_width)
    jh, th = hulls() if hull else (None, None)
    kw = dict(use_pallas=use_pallas, depth_samples_fine=F, static_tv_weight_start=0.0,
              static_tv_weight_end=0.0)
    jc = fine_cfgs(jf, fine_width)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: js.composite_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z), jnp.int32(50), jc,
                                       hparams(js, weights, **kw), rng=key, hull=jh),
        has_aux=True)(params)
    tp = torch_params(params)
    u = torch.from_numpy(prng.uniform(key_of(key), (4, F)))
    tl, tm, tg = ts.composite_grads(tp, {k: torch.tensor(v) for k, v in batch.items()},
                                    torch.tensor(z), 50, fine_cfgs(tf, fine_width),
                                    hparams(ts, weights, **kw), hull=th, u_fine=u)
    return (float(jl), jm, jg), (float(tl), tm, grads_as_jax(tp, tg))


def leaf_errors(jg, tg):
    return {jax.tree_util.keystr(path): float(np.abs(a - np.asarray(b)).max()
                                              / max(np.abs(np.asarray(b)).max(), 1e-30))
            for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                    jax.tree_util.tree_leaves(tg))}


def split_errors(errs):
    """(the fine pair's leaves, the coarse pair's) of :func:`leaf_errors`."""
    fine = {k: v for k, v in errs.items() if "_fine" in k}
    return fine, {k: v for k, v in errs.items() if k not in fine}


# The coarse pair's gradients carry the fine loss's derivative through
# sample_pdf, whose weights are differences of nearly equal adjacent
# sigmas: f32 rounding noise in the coarse sigmas moves them by more than
# 1e-4 of a leaf in any f32 implementation (held below by
# test_coarse_gradients_carry_the_rounding_of_the_coarse_sigmas). They are
# held at COARSE_REL of their scale (measured against JAX: 1.2e-4 with the
# hull), the fine pair's at 1e-4.
COARSE_REL = 1e-3


@pytest.mark.parametrize("route", [
    # (use_pallas, fine width): plain; K1/K2 on both pairs (the port's twin,
    # JAX's Pallas entries); K1/K2 coarse with a fine pair outside the
    # envelope, which runs plain
    (False, 32), (True, 128), (True, 32)])
@pytest.mark.parametrize("hull", [False, True])
def test_fine_step_matches_jax(route, hull):
    # the shipped loss schedule: the loss and every metric within 1e-5
    # relative (1e-4 for the entropy terms, as the coarse step), the fine
    # pair's gradient leaves within 1e-4 of their scale, the coarse pair's
    # within COARSE_REL
    (jl, jm, jg), (tl, tm, tg) = run_fine_both("shipped", *route, hull=hull)
    assert set(tm) == set(jm) and "train_pixel_loss_fine" in tm
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    for k in jm:
        rtol = 1e-4 if "entropy" in k or "favor" in k else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=0, err_msg=k)
    errs = leaf_errors(jg, tg)
    assert len(errs) == len(ts.param_items(torch_params(fine_problem(route[1])[0])))
    fine, coarse = split_errors(errs)
    assert fine and max(fine.values()) <= 1e-4, fine
    assert max(coarse.values()) <= COARSE_REL, coarse


def test_fine_step_strong_weights():
    # regularizer weights large enough that the fine regularizers move the
    # coarse pair strongly through the fine depths: the loss within 1e-5,
    # the fine pair's leaves within 1e-4 of their scale; the coarse pair's
    # (measured 4.5e-3 against JAX, 1.0e-3 from half an ulp of noise on
    # the coarse sigmas in the port alone) within 1e-2
    (jl, _, jg), (tl, _, tg) = run_fine_both("strong", False, 32)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    fine, coarse = split_errors(leaf_errors(jg, tg))
    assert fine and max(fine.values()) <= 1e-4, fine
    assert max(coarse.values()) <= 1e-2, coarse


def test_coarse_gradients_carry_the_rounding_of_the_coarse_sigmas(monkeypatch):
    # why the coarse pair is held at COARSE_REL: half an ulp of random noise
    # on the coarse sigmas (what another f32 summation order gives) moves
    # the port's own coarse gradients by more than 1e-4 of a leaf, and the
    # fine pair's by less
    params, batch, z, key = fine_problem(32)
    u = torch.from_numpy(prng.uniform(key_of(key), (4, F)))
    render = ts.render_transmission_composite
    gen = torch.Generator().manual_seed(1)

    def noisy_render(s_raw, t_raw, i0, depths, *a, **k):
        pix, s_sig, t_sig, dists = render(s_raw, t_raw, i0, depths, *a, **k)
        if depths.shape[-1] == z.shape[0]:  # the coarse pass
            s_sig = s_sig * (1 + 6e-8 * torch.randn(s_sig.shape, generator=gen))
            t_sig = t_sig * (1 + 6e-8 * torch.randn(t_sig.shape, generator=gen))
        return pix, s_sig, t_sig, dists

    grads = []
    for noise in (False, True):
        if noise:
            monkeypatch.setattr(ts, "render_transmission_composite", noisy_render)
        tp = torch_params(params)
        _, _, g = ts.composite_grads(
            tp, {k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(z), 50,
            fine_cfgs(tf, 32), hparams(ts, use_pallas=False, depth_samples_fine=F),
            hull=hulls()[1], u_fine=u)
        grads.append(grads_as_jax(tp, g))
    fine, coarse = split_errors(leaf_errors(grads[0], grads[1]))
    assert max(coarse.values()) > 1e-4 > max(fine.values()), (coarse, fine)


def test_fine_train_steps_follow_jax():
    # three fine steps through make_composite_train_step from the same
    # state and key (the variance split, k_fine's uniforms, the static
    # freeze from step 1 on both static groups): losses within 1e-5
    # relative, the same key, the fine pair's params within 1e-5 of each
    # leaf's scale and the coarse pair's within COARSE_REL (Adam's first
    # steps move each element by about the LR whatever its gradient's size,
    # so the coarse gradients' rounding spread shows in the params: 2e-4
    # measured); the frozen static and static_fine params keep their
    # step-1 values
    jc, tc = fine_cfgs(jf, 16), fine_cfgs(tf, 16)
    kw = dict(img_sample_size=32, nb_var_rays=16, depth_samples_coarse=24,
              depth_samples_fine=F, static_freeze_step=1, hyperparam_decay_steps=10,
              **WEIGHTS["shipped"])
    rng = np.random.default_rng(0)
    n = 200
    rays = np.zeros((n, 4, 3), np.float32)
    rays[:, 0] = [0.05, -0.1, -4.5]
    rays[:, 1, :2] = rng.uniform(-0.08, 0.08, (n, 2))
    rays[:, 1, 2] = 1.0
    rays[:, 2] = (2.16 - rng.uniform(0, 0.5, n))[:, None]
    rays[:, 3] = 1.0
    rays[:80, 3] = 1.5
    phases = rng.integers(0, 10, n).astype(np.int32)
    var_ids, non_var = np.arange(80), np.arange(80, n)
    z = np.asarray(jsm.linspace_depths(3.6, 5.4, 24))
    jtx = js.make_optimizer(1e-3, 0.1, 10)
    jstep = jax.jit(js.make_composite_train_step(jc, js.CompositeHParams(**kw), jtx, z, 2.16))
    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    params = {"static": jf.init_static_field(keys[0], jc["static"]),
              "temp": jf.init_temporal_field(keys[1], jc["temp"]),
              "static_fine": jf.init_static_field(keys[2], jc["static_fine"]),
              "temp_fine": jf.init_temporal_field(keys[3], jc["temp_fine"])}
    jstate = js.TrainState(params, jtx.init(params), jnp.int32(0), keys[7])
    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in params.items()}
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0, key_of(keys[7]))
    tstep = ts.make_composite_train_step(tc, ts.CompositeHParams(**kw),
                                         ts.make_optimizer(1e-3, 0.1, 10), torch.tensor(z), 2.16)
    targs = (torch.tensor(rays), torch.tensor(phases), torch.tensor(var_ids),
             torch.tensor(non_var))
    frozen = None
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(rays), phases, jnp.asarray(var_ids, jnp.int32),
                           jnp.asarray(non_var, jnp.int32))
        tm = tstep(tstate, *targs)
        np.testing.assert_allclose(float(tm["train_loss"]), float(jm["train_loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["train_pixel_loss_fine"]),
                                   float(jm["train_pixel_loss_fine"]), rtol=1e-5)
        static = {k: tf.params_to_jax(tstate.params[k]) for k in ("static", "static_fine")}
        if i == 0:
            frozen = static
        else:
            for a, b in zip(jax.tree_util.tree_leaves(static), jax.tree_util.tree_leaves(frozen)):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tstate.rng, key_of(jstate.rng))
    got = {k: tf.params_to_jax(v) for k, v in tstate.params.items()}
    fine, coarse = split_errors(leaf_errors(jstate.params, got))
    assert max(fine.values()) <= 1e-5, fine
    assert max(coarse.values()) <= COARSE_REL, coarse


def test_fine_under_a_mesh_raises():
    # the fine pass runs under a data-parallel mesh (its max over the batch
    # and ray 0's depths through the mesh's 'data' axis; at world 1 bit for
    # bit the unsharded step, tests/test_torch_parallel.py, and against
    # JAX's on two ranks, tests/test_torch_parallel_autograd.py): a mesh
    # without that axis raises when the step is built, before any step
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="gloo")
    try:
        step = functools.partial(ts.make_composite_train_step, fine_cfgs(tf, 16),
                                 hparams(ts, depth_samples_fine=F),
                                 ts.make_optimizer(1e-3, 0.01, 300),
                                 torch.linspace(3.6, 5.4, 48), 2.16)
        with pytest.raises(ValueError, match="'data'"):
            step(mesh=make_mesh(axis_names=("depth",), device="cpu"))
        step(mesh=make_mesh(device="cpu"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The trainer: configs, init, eval depths, the envelope rule


def test_fine_configs_init_and_eval_depths_are_jax():
    # the fine configs as JAX's, their params from keys 2 and 3 of the
    # 8-way split bit for bit, the fine eval grid from PRNGKey(seed + 2)
    targs, jargs = (mod.parse_args(["--config", SMALL, *FINE_ARGV]) for mod in (tcfg, jcfg))
    tc, jc = ttr.field_configs_from_args(targs), jtr.field_configs_from_args(jargs)
    assert sorted(tc) == sorted(jc) == ["static", "static_fine", "temp", "temp_fine"]
    for k in jc:  # and the port's own keys at their defaults
        assert dataclasses.asdict(tc[k]) == {**dataclasses.asdict(jc[k]),
                                             **tf.PORT_ONLY_DEFAULTS}
    tstate = ttr._init_composite_state(targs, tc, None, torch.device("cpu"))
    jstate = jtr._init_composite_state(jargs, jc, js.make_optimizer(1e-3, 0.01, 300))
    got = {k: tf.params_to_jax(v) for k, v in tstate.params.items()}
    assert sorted(got) == sorted(jstate.params)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    info = {"near_thresh": 3.6, "far_thresh": 5.4}
    want = jsm.stratify_depths(jax.random.PRNGKey(targs.seed + 2),
                               jsm.linspace_depths(3.6, 5.4, F))
    np.testing.assert_array_equal(ttr.eval_depths(info, F, targs.seed + 2, "cpu").numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("fine,coarse,use_pallas", [
    (128, 128, True), (64, 128, True), (128, 64, False), (64, 64, False)])
def test_envelope_rule_coarse_pair_decides(fine, coarse, use_pallas):
    # JAX's rule: the coarse pair decides use_pallas and use_fused_loss; a
    # fine pair outside the envelope only warns and runs plain
    kw = dict(num_early_layers=2, pos_enc="free_windowed", pos_enc_basis=4)
    c = {}
    for mod, out in ((tf, "t"), (jf, "j")):
        base = {"static": mod.FieldConfig(num_filters=coarse, **kw),
                "temp": mod.FieldConfig(num_filters=coarse, use_time_latents=True,
                                        num_time_dim=8, **kw)}
        base.update({f"{k}_fine": dataclasses.replace(v, num_filters=fine)
                     for k, v in base.items()})
        c[out] = base
    thp = ts.CompositeHParams(use_pallas=True, use_fused_loss=True, depth_samples_fine=F)
    jhp = js.CompositeHParams(use_pallas=True, use_fused_loss=True, depth_samples_fine=F)
    out = {}
    for name, fn, hp in (("torch", ttr.resolve_pallas_support, thp),
                         ("jax", jtr.resolve_pallas_support, jhp)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = fn(hp, c[name[0]])
        out[name] = (got.use_pallas, got.use_fused_loss, len(caught))
    warned = int((fine, coarse) != (128, 128))
    assert out["torch"] == out["jax"] == (use_pallas, use_pallas, warned)


# ---------------------------------------------------------------------------
# Eval, run_eval and checkpoints


@pytest.mark.parametrize("hull", [False, True])
def test_eval_fine_terms_match_jax(hull):
    # render_test_view with the fine grid (16 rays in tiles of 8 for the
    # port, of 16 for JAX): every render within 1e-5 of I0, every test
    # metric within 1e-5 relative (1e-4 for the entropy terms), the fine
    # terms added to test_loss
    params, _, _, _ = fine_problem(128)
    jh, th = hulls() if hull else (None, None)
    rng = np.random.default_rng(4)
    n = 16
    o = np.tile(np.array([[0.05, -0.1, -4.5]], np.float32), (n, 1))
    d = np.concatenate([rng.uniform(-0.08, 0.08, (n, 2)), np.ones((n, 1))], 1).astype(np.float32)
    ph = rng.integers(0, 10, n).astype(np.int32)
    img = (2.16 - rng.uniform(0, 0.5, n)).astype(np.float32)
    z = np.asarray(jsm.linspace_depths(3.6, 5.4, 32))
    zf = np.asarray(jsm.stratify_depths(jax.random.PRNGKey(2), jsm.linspace_depths(3.6, 5.4, F)))
    jc, tc = fine_cfgs(jf, 128), fine_cfgs(tf, 128)
    jhp, thp = hparams(js, use_pallas=True), hparams(ts, use_pallas=True)
    want = jev.render_test_view(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ph),
                                jnp.asarray(z), 50, jc, jhp, 2.16, tile=16,
                                depth_values_fine=jnp.asarray(zf), hull=jh)
    got = tev.render_test_view(torch_params(params), torch.tensor(o), torch.tensor(d),
                               torch.tensor(ph), torch.tensor(z), 50, tc, thp, 2.16, tile=8,
                               depth_values_fine=torch.tensor(zf), hull=th)
    assert set(got) == set(want)
    for k in ("pix", "pix_fine", "pix_static", "pix_temp"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5 * 2.16,
                                   rtol=0, err_msg=k)
    jm = jev.test_metrics(want, jnp.asarray(img), 50, jhp, img_shape=(4, 4))
    tm = tev.test_metrics(got, torch.tensor(img), 50, thp, img_shape=(4, 4))
    assert set(tm) == set(jm) and "test_image_psnr_fine" in tm
    for k in jm:
        rtol = 1e-4 if "entropy" in k or "favor" in k else 1e-5
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-6, err_msg=k)
    no_fine = tev.test_metrics({k: v for k, v in got.items() if "fine" not in k},
                               torch.tensor(img), 50, thp)
    assert tm["test_loss"] > no_fine["test_loss"]


@pytest.fixture(scope="module")
def fine_checkpoints(tmp_path_factory):
    """A synth-small dataset and one JAX param tree with fine models, saved
    through both packages' checkpoint writers."""
    tmp = tmp_path_factory.mktemp("fine-eval")
    data_root = str(tmp / "data")
    argv = ["--config", SMALL, *FINE_ARGV, "--data_root", data_root, *FAST_DATA]
    build_dataset(tcfg.parse_args(argv), data_root, projector_samples=40)
    jargs = jcfg.parse_args(argv)
    cfgs = jtr.field_configs_from_args(jargs)
    tx = js.make_optimizer(1e-3, 0.01, 300)
    state = jtr._init_composite_state(jargs, cfgs, tx)
    state = state._replace(step=jnp.int32(150))
    run = {"data_name": "SYNTH", "step": 150}
    jck.save_checkpoint(str(tmp / "jax"), state, cfgs, run_metadata=run)
    tparams = {k: tf.params_from_jax(jax.tree.map(np.asarray, v)) for k, v in state.params.items()}
    tck.save_checkpoint(str(tmp / "torch"),
                        ts.TrainState(tparams, ts.init_opt_state(tparams), 150, prng.key(0)),
                        tck.load_field_configs(str(tmp / "jax")), run_metadata=run)
    return {"argv": argv, "jax": str(tmp / "jax"), "torch": str(tmp / "torch"),
            "params": tparams}


def test_run_eval_scores_fine_like_jax(fine_checkpoints):
    # per view psnr_fine within 1e-3 dB and ssim_fine within 1e-4 of JAX's
    # CLI on the same checkpoint; without the fine flag neither scores them
    fc = fine_checkpoints
    out = {}
    for pkg, fn, cfg_mod, extra in (("jax", jre.evaluate_checkpoint, jcfg, []),
                                    ("torch", tre.evaluate_checkpoint, tcfg,
                                     ["--platform", "cpu"])):
        fn(cfg_mod.parse_args(fc["argv"] + ["--resume_from", fc[pkg], *extra]),
           write_images=False)
        with open(os.path.join(fc[pkg], "eval", "eval_scores.json")) as f:
            out[pkg] = json.load(f)
    j, t = out["jax"], out["torch"]
    assert len(t["per_view"]) == len(j["per_view"]) > 0
    for a, b in zip(t["per_view"], j["per_view"]):
        assert set(a) == set(b) and "psnr_fine" in a
        assert abs(a["psnr_fine"] - b["psnr_fine"]) <= 1e-3
        assert abs(a["ssim_fine"] - b["ssim_fine"]) <= 1e-4
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
    coarse = tre.evaluate_checkpoint(tcfg.parse_args(
        fc["argv"] + ["--resume_from", fc["torch"], "--platform", "cpu",
                      "--depth_samples_per_ray_fine", "0"]), write_images=False)
    assert "psnr_fine" not in coarse["per_view"][0]


def test_checkpoint_with_fine_leaves_round_trips(fine_checkpoints, tmp_path):
    # the JAX checkpoint's fine leaves load by name into the port's state,
    # and the port's save / load round trip keeps every leaf bit for bit
    fc = fine_checkpoints
    args = tcfg.parse_args(fc["argv"])
    cfgs = ttr.field_configs_from_args(args)
    example = ttr._init_composite_state(args, cfgs, None, torch.device("cpu"))
    loaded = tck.load_checkpoint(fc["torch"], example)
    names = [n for n, _ in ts.param_items(loaded.params)]
    assert any(n.startswith("static_fine/") for n in names)
    assert any(n.startswith("temp_fine/") for n in names)
    for (n, a), (_, b) in zip(ts.param_items(loaded.params), ts.param_items(fc["params"])):
        assert torch.equal(a, b), n
    loaded.opt_state["mu"] = [torch.full_like(t, 0.5) for t in loaded.opt_state["mu"]]
    tck.save_checkpoint(str(tmp_path), loaded, cfgs)
    again = tck.load_checkpoint(str(tmp_path), example)
    for a, b in zip(again.opt_state["mu"], loaded.opt_state["mu"]):
        assert torch.equal(a, b)
    assert tck.load_field_configs(str(tmp_path)) == cfgs


def test_train_composite_with_fine_pass_follows_jax(fine_checkpoints, tmp_path):
    # three steps of each package's train_composite with the fine pass on
    # the same dataset, and the eval after them: train losses within 1e-5
    # relative, the fine pixel loss too, the eval's fine PSNR within 1e-3 dB
    argv = fine_checkpoints["argv"] + ["--n_iters", "2", "--display_every", "3",
                                       "--log_every", "1"]
    jout = jtr.train_composite(jcfg.parse_args([*argv, "--log_dir_root",
                                                str(tmp_path / "jax")]))
    tout = run_composite.main([*argv, "--platform", "cpu", "--log_dir_root",
                               str(tmp_path / "torch")])
    recs = {}
    for pkg, out in (("jax", jout), ("torch", tout)):
        with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
            recs[pkg] = [json.loads(line) for line in f]
    j_train = [r for r in recs["jax"] if "train_loss" in r]
    t_train = [r for r in recs["torch"] if "train_loss" in r]
    assert [r["step"] for r in t_train] == [r["step"] for r in j_train] == [0, 1, 2]
    for a, b in zip(t_train, j_train):
        for k in ("train_loss", "train_pixel_loss_fine", "train_pixel_loss_coarse"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    j_eval = [r for r in recs["jax"] if "test_image_psnr_fine" in r]
    t_eval = [r for r in recs["torch"] if "test_image_psnr_fine" in r]
    assert len(t_eval) == len(j_eval) == 1
    for k in ("test_image_psnr", "test_image_psnr_fine"):
        assert abs(t_eval[0][k] - j_eval[0][k]) <= 1e-3, k
