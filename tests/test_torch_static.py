"""The static 3-D method of the torch port (``run_nerf``) against the JAX
package: the point-form and static field entries' plain twins against the
Pallas kernels (interpret mode), the static step's key split bit for bit,
its loss, metrics and Adam steps, the static eval view, and a tiny
``train_static`` run with its checkpoints and a bitwise resume. The
one-field kernels themselves are checked against the twins on the card by
``tests/test_torch_gpu.py``."""

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
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu.ops.sampling import linspace_depths as j_linspace
from nerfca_tpu.train import evaluation as jev
from nerfca_tpu.train import step as js
from nerfca_tpu.train import trainer as jtr
from nerfca_tpu.train.config import parse_args as j_parse_args
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import fused_field as tff
from nerfca_tpu_torch.ops.sampling import linspace_depths
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import evaluation as tev
from nerfca_tpu_torch.train import run_nerf
from nerfca_tpu_torch.train import step as ts
from nerfca_tpu_torch.train import trainer as ttr
from tests.test_torch_checkpoint import assert_states_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_3D = os.path.join(REPO, "configs", "3d.txt")
# Tolerances. Against the Pallas kernels in interpret mode, their own
# tolerances against jnp (test_pallas.py:77, :141): forward abs 2e-4,
# gradients abs 5e-3 + rel 1e-3. Against the jnp path (the same math in
# another library): forward abs 1e-5, loss and metrics rel 1e-5, Adam's
# params abs 1e-6 after one step and 1e-5 after three (test_torch_step.py).
FWD_KERNEL_ATOL = 2e-4
GRAD_KERNEL_TOL = dict(atol=5e-3, rtol=1e-3)
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def field_cfgs(mod, basis=4, layers=2):
    kw = dict(num_early_layers=layers, num_filters=128, pos_enc="free_windowed",
              pos_enc_basis=basis, pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    return mod.FieldConfig(**kw), mod.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)


def field_params(seed=0, basis=4, layers=2):
    cs, ct = field_cfgs(jf, basis, layers)
    return (jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), cs)),
            jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), ct)))


def points_and_phases(r, s, seed=0):
    rng = np.random.default_rng(seed)
    o = np.array([0.1, -0.2, -4.5], np.float32)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (r, 2)), np.ones((r, 1))], 1)
    z = np.sort(rng.uniform(3.6, 5.4, (r, s)), axis=1)
    pts = (o + d[:, None, :] * z[..., None]).astype(np.float32)
    return pts, rng.integers(0, 10, (r, s)).astype(np.int32)


def window(basis=4, step=60):
    return np.asarray(free_window_mask(basis, step, 100, 1))


def compare_trees(got, want, **tol):
    fg, tg = jax.tree_util.tree_flatten(got)
    fw, tw = jax.tree_util.tree_flatten(want)
    assert tg == tw
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(want)[0], fg, fw):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **tol)


def torch_field_grads(trees, fn, cot):
    """Grads of sum(out_i * cot_i) w.r.t. each tree, in the JAX layout."""
    leaves = [x for tree in trees for x in jax.tree_util.tree_leaves(tree)]
    for x in leaves:
        x.requires_grad_(True)
    out = fn(*trees)
    sum((o * torch.tensor(c)).sum() for o, c in zip(out, cot)).backward()
    return [tf.params_to_jax(jax.tree.map(lambda x: x.grad, t)) for t in trees], out


# ---------------------------------------------------------------------------
# The entries' plain twins against the JAX entries (Pallas, interpret mode)


def test_point_form_matches_jax_pallas():
    # r=2, s=64: a point count that fills no whole Pallas tile (128)
    r, s = 2, 64
    ps, pt = field_params(3)
    pts, ph = points_and_phases(r, s, 3)
    w = window()
    js_cfg, jt_cfg = field_cfgs(jf)
    ts_cfg, tt_cfg = field_cfgs(tf)
    cot = [np.random.default_rng(4).standard_normal((r, s, 1)).astype(np.float32)
           for _ in range(2)]

    def jax_fn(a, b):
        return jff.fused_composite_fields(a, b, jnp.asarray(pts), jnp.asarray(ph), js_cfg,
                                          jt_cfg, jnp.asarray(w), jnp.asarray(w), tile=128)

    want, vjp = jax.vjp(jax_fn, ps, pt)
    want_grads = vjp(tuple(jnp.asarray(c) for c in cot))

    def torch_fn(a, b):
        # on CPU tensors the entry takes its plain twin
        return tff.fused_composite_fields(a, b, torch.tensor(pts), torch.tensor(ph), ts_cfg,
                                          tt_cfg, torch.tensor(w), torch.tensor(w))

    grads, got = torch_field_grads([tf.params_from_jax(ps), tf.params_from_jax(pt)], torch_fn,
                                   cot)
    for a, b in zip(got, want):
        assert a.shape == (r, s, 1)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=FWD_KERNEL_ATOL,
                                   rtol=0)
    for g, wg in zip(grads, want_grads):
        compare_trees(g, wg, **GRAD_KERNEL_TOL)


@pytest.mark.parametrize("layers,basis", [(2, 4), (1, 0)])
def test_static_field_matches_jax_pallas(layers, basis):
    r, s = 2, 64
    ps, _ = field_params(5, basis, layers)
    pts, _ = points_and_phases(r, s, 5)
    js_cfg, _ = field_cfgs(jf, basis, layers)
    ts_cfg, _ = field_cfgs(tf, basis, layers)
    if basis == 0:
        js_cfg = dataclasses.replace(js_cfg, pos_enc="none")
        ts_cfg = dataclasses.replace(ts_cfg, pos_enc="none")
    w = window(basis) if basis else None
    cot = np.random.default_rng(6).standard_normal((r, s, 1)).astype(np.float32)

    def jax_fn(a):
        return jff.fused_static_field(a, jnp.asarray(pts), js_cfg,
                                      None if w is None else jnp.asarray(w), tile=128)

    want, vjp = jax.vjp(jax_fn, ps)
    (want_grads,) = vjp(jnp.asarray(cot))
    tw = None if w is None else torch.tensor(w)
    (grads,), (got,) = torch_field_grads(
        [tf.params_from_jax(ps)],
        lambda a: (tff.fused_static_field(a, torch.tensor(pts), ts_cfg, tw),), [cot])
    assert got.shape == (r, s, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_KERNEL_ATOL,
                               rtol=0)
    compare_trees(grads, want_grads, **GRAD_KERNEL_TOL)
    # the twin is the jnp static field, to f32 rounding
    jnp_out = jf.apply_static_field(ps, jnp.asarray(pts), js_cfg,
                                    window=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jnp_out), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_evaluate_composite_matches_jax(use_pallas):
    r, s = 2, 64
    ps, pt = field_params(8)
    pts, ph = points_and_phases(r, s, 8)
    w = window()
    jc = dict(zip(("static", "temp"), field_cfgs(jf)))
    tc = dict(zip(("static", "temp"), field_cfgs(tf)))
    jhp = js.CompositeHParams(use_pallas=use_pallas, pallas_tile=128)
    a = js.evaluate_composite({"static": ps, "temp": pt}, jnp.asarray(pts), jnp.asarray(ph), jc,
                              {"static": jnp.asarray(w), "temp": jnp.asarray(w)}, jhp)
    b = ts.evaluate_composite({"static": tf.params_from_jax(ps), "temp": tf.params_from_jax(pt)},
                              torch.tensor(pts), torch.tensor(ph), tc,
                              {"static": torch.tensor(w), "temp": torch.tensor(w)},
                              ts.CompositeHParams(use_pallas=use_pallas))
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y),
                                   atol=FWD_KERNEL_ATOL if use_pallas else FWD_ATOL, rtol=0)


def test_entries_raise_off_cpu_and_cuda():
    cfg, _ = field_cfgs(tf)
    params = tf.init_static_field(prng.key(0), cfg)
    with pytest.raises(ValueError, match="no field kernel"):
        tff.fused_static_field(params, torch.zeros(1, 2, 3, device="meta"), cfg, None)


# ---------------------------------------------------------------------------
# The static step


@pytest.mark.parametrize("nv", [0, 3])
def test_static_step_draws_match_jax_bitwise(nv):
    n, n_var, n_non, n_rays, n_samples = 16, 7, 30, 37, 48
    rng, k_sample, k_depth = jax.random.split(jax.random.PRNGKey(11), 3)
    if nv:
        k1, k2 = jax.random.split(k_sample)
        want_pos = np.concatenate([np.asarray(jax.random.randint(k1, (nv,), 0, n_var)),
                                   np.asarray(jax.random.randint(k2, (n - nv,), 0, n_non))])
    else:
        want_pos = np.asarray(jax.random.randint(k_sample, (n,), 0, n_rays))
    want_t = np.asarray(jax.random.uniform(k_depth, (n_samples,)))
    hp = ts.CompositeHParams(img_sample_size=n, nb_var_rays=nv)
    got_rng, got_pos, got_t = ts.static_step_draws(prng.key(11), hp, n_var, n_non, n_rays,
                                                   n_samples)
    np.testing.assert_array_equal(got_rng, np.asarray(rng))
    np.testing.assert_array_equal(got_pos, want_pos)
    np.testing.assert_array_equal(got_t.view(np.uint32), want_t.view(np.uint32))


def ray_table(n_rays=40, seed=5):
    """A ``[N, 4, 3]`` ray table (origin, direction, pixel, weight) with
    some weights above the high-variance threshold."""
    rng = np.random.default_rng(seed)
    o = np.array([0.1, -0.2, -4.5]) + rng.uniform(-0.05, 0.05, (n_rays, 3))
    d = np.concatenate([rng.uniform(-0.1, 0.1, (n_rays, 2)), np.ones((n_rays, 1))], 1)
    pix = 2.16 - 0.5 * rng.uniform(size=n_rays)
    w = 1.0 + 0.2 * rng.uniform(size=n_rays)
    rays = np.stack([o, d, np.repeat(pix[:, None], 3, 1), np.repeat(w[:, None], 3, 1)], 1)
    return rays.astype(np.float32)


def static_hparams(mod, use_pallas, **kw):
    base = dict(img_sample_size=8, depth_samples_coarse=32, occl_weight_start=1e-2,
                occl_reg_perc=0.2, use_pallas=use_pallas)
    base.update(kw)
    return mod.StaticHParams(**base)


@pytest.mark.parametrize("jax_pallas", [False, True])
def test_static_loss_and_metrics_match_jax(jax_pallas):
    rays = ray_table()
    ps, _ = field_params(2)
    jc, _ = field_cfgs(jf)
    tc, _ = field_cfgs(tf)
    z = np.asarray(j_linspace(3.6, 5.4, 32))
    batch = {"origins": rays[:8, 0], "directions": rays[:8, 1], "pixels": rays[:8, 2, 0],
             "weights": rays[:8, 3, 0], "initial_intensities": np.full(8, 2.16, np.float32)}
    jl, jm = js.static_loss_fn({"static": ps}, {k: jnp.asarray(v) for k, v in batch.items()},
                               jnp.asarray(z), 60, jc, static_hparams(js, jax_pallas))
    tl, tm = ts.static_loss_fn({"static": tf.params_from_jax(ps)},
                               {k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(z),
                               60, tc, static_hparams(ts, True))
    assert set(tm) == set(jm)
    rtol = 1e-4 if jax_pallas else LOSS_RTOL  # the kernel's f32 sums differ further
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol, atol=0)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=0, err_msg=k)


def run_steps(n_steps, nv):
    """``n_steps`` of the JAX static step and of the port's from the same
    seed on the same ray table; returns both states and metric lists."""
    rays = ray_table()
    var_ids, non_var_ids = ttr._variance_ray_split(rays, 10)
    assert len(var_ids) and len(non_var_ids)
    jc, _ = field_cfgs(jf)
    tc, _ = field_cfgs(tf)
    key = jax.random.PRNGKey(4)
    jparams = {"static": jf.init_static_field(key, jc)}
    jtx = js.make_optimizer(1e-3, 0.01, 100)
    jstate = js.TrainState(jparams, jtx.init(jparams), jnp.zeros((), jnp.int32), key)
    jz = j_linspace(3.6, 5.4, 32)
    jstep = jax.jit(js.make_static_train_step(jc, static_hparams(js, False, nb_var_rays=nv), jtx,
                                              jz, 2.16))
    jd = [jnp.asarray(a) for a in (rays, np.zeros(len(rays), np.int32), var_ids, non_var_ids)]
    tparams = {"static": tf.params_from_jax(jax.tree.map(np.asarray, jparams["static"]))}
    tstate = ts.TrainState(tparams, ts.init_opt_state(tparams), 0, prng.key(4))
    tstep = ts.make_static_train_step(tc, static_hparams(ts, True, nb_var_rays=nv),
                                      ts.make_optimizer(1e-3, 0.01, 100),
                                      linspace_depths(3.6, 5.4, 32), 2.16)
    td = [torch.tensor(rays), torch.zeros(len(rays), dtype=torch.int64),
          torch.tensor(var_ids), torch.tensor(non_var_ids)]
    jms, tms = [], []
    for _ in range(n_steps):
        jstate, jm = jstep(jstate, *jd)
        jms.append(jm)
        tms.append(tstep(tstate, *td))
    return jstate, tstate, jms, tms


@pytest.mark.parametrize("n_steps,nv,params_atol", [(1, 0, 1e-6), (1, 2, 1e-6), (3, 2, 1e-5)])
def test_static_train_steps_match_jax(n_steps, nv, params_atol):
    jstate, tstate, jms, tms = run_steps(n_steps, nv)
    for jm, tm in zip(jms, tms):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL * n_steps,
                                       atol=0, err_msg=k)
    assert tstate.step == int(jstate.step) == n_steps
    np.testing.assert_array_equal(tstate.rng, np.asarray(jstate.rng))
    compare_trees(tf.params_to_jax(tstate.params["static"]),
                  jax.tree.map(np.asarray, jstate.params["static"]), atol=params_atol, rtol=0)


def test_render_static_test_view_matches_jax():
    rays = ray_table(50, seed=9)
    ps, _ = field_params(1)
    jc, _ = field_cfgs(jf)
    tc, _ = field_cfgs(tf)
    z = np.asarray(j_linspace(3.6, 5.4, 32))
    # a tile of 16 rays leaves a partial last tile
    want = jev.render_static_test_view({"static": ps}, jnp.asarray(rays[:, 0]),
                                       jnp.asarray(rays[:, 1]), jnp.asarray(z), 60, jc,
                                       static_hparams(js, False), 2.16, tile=16)
    got = tev.render_static_test_view({"static": tf.params_from_jax(ps)},
                                      torch.tensor(rays[:, 0]), torch.tensor(rays[:, 1]),
                                      torch.tensor(z), 60, tc, static_hparams(ts, True), 2.16,
                                      tile=16)
    np.testing.assert_allclose(got["pix_static"].numpy(), np.asarray(want["pix_static"]),
                               atol=FWD_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The driver and the CLI


def test_static_hparams_and_support_match_jax():
    argv = ["--config", CONFIG_3D, "--var_sample_perc", "25"]
    a = dataclasses.asdict(ttr.static_hparams_from_args(tcfg.parse_args(argv)))
    b = dataclasses.asdict(jtr.static_hparams_from_args(j_parse_args(argv)))
    assert a == b
    cfg = ttr.static_config_from_args(tcfg.parse_args(["--config", CONFIG_3D]))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jtr.field_configs_from_args(j_parse_args(["--config", CONFIG_3D]))["static"])
    hp = ts.StaticHParams(use_pallas=True)
    assert ttr.resolve_pallas_support(hp, cfg) is hp
    with pytest.warns(UserWarning, match="envelope"):
        assert not ttr.resolve_pallas_support(
            hp, dataclasses.replace(cfg, num_filters=64)).use_pallas


# test_trainer_integration.py::test_static_driver's sizes, steps and logging
TINY = ["--config", CONFIG_3D, "--data_name", "SYNTH", "--data_size", "50",
        "--synth_vol_size", "20", "--data_step_size", "120", "--data_numb_angles", "4",
        "--depth_samples_per_ray_coarse", "48", "--img_sample_size", "64",
        "--static_num_filters", "16", "--static_num_early_layers", "2",
        "--steps_per_chunk", "20", "--n_iters", "60", "--display_every", "60",
        "--save_every", "60", "--log_every", "20"]


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    # run_nerf's --only_prepare_data builds the single-phase dataset that
    # both packages' trainers then read
    root = str(tmp_path_factory.mktemp("data"))
    assert run_nerf.main([*TINY, "--platform", "cpu", "--only_prepare_data", "true",
                          "--data_root", root]) is None
    return root


def records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def tiny_runs(tiny_data, tmp_path_factory):
    cases = tmp_path_factory.mktemp("cases")
    argv = [*TINY, "--data_root", tiny_data]
    jout = jtr.train_static(j_parse_args([*argv, "--log_dir_root", str(cases / "jax")]))
    tout = run_nerf.main([*argv, "--platform", "cpu", "--log_dir_root", str(cases / "torch")])
    return jout, tout


def test_only_prepare_data_builds_one_phase(tiny_data):
    args = tcfg.parse_args([*TINY, "--data_root", tiny_data])
    args.data_time_range_end = args.data_time_range_start + 1
    paths = ttr.dataset_paths(args, tiny_data)
    assert os.path.isfile(paths.general) and os.path.isfile(paths.train)
    with open(paths.train) as f:
        frames = json.load(f)["frames"]
    assert frames and {fr["heart_phase"] for fr in frames} == {0}


def test_sweep_raises(tmp_path):
    # sweeps are ported: run_nerf runs one through train_static, and an
    # override that would truncate an int flag raises before any training,
    # as JAX's overwrite_args refuses it
    sweep = tmp_path / "sweep.yaml"
    sweep.write_text("method: grid\nparameters:\n  img_sample_size:\n    values: ['64.5']\n")
    with pytest.raises(ValueError, match="fractional"):
        run_nerf.main([*TINY, "--platform", "cpu", "--wandb_sweep_yaml", str(sweep),
                       "--log_dir_root", str(tmp_path / "cases")])


def test_tiny_train_static_follows_jax(tiny_runs):
    jout, tout = tiny_runs
    assert tout["state"].step == int(jout["state"].step) == 61
    assert tout["final_step"] == jout["final_step"] == 61
    assert tout["log_dir"].endswith("-static")
    jr, tr = records(jout["log_dir"]), records(tout["log_dir"])
    for want in (lambda r: "train_loss" in r, lambda r: "test_image_psnr" in r):
        a, b = [r for r in tr if want(r)], [r for r in jr if want(r)]
        assert [r["step"] for r in a] == [r["step"] for r in b]
        assert [set(r) for r in a] == [set(r) for r in b]
    # the same seed draws the same params, batches and depths: the first
    # loss agrees to f32 rounding, the last after 60 Adam steps closely
    ta, ja = [r for r in tr if "train_loss" in r], [r for r in jr if "train_loss" in r]
    np.testing.assert_allclose(ta[0]["train_loss"], ja[0]["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ta[-1]["train_loss"], ja[-1]["train_loss"], rtol=1e-3)
    te = next(r for r in tr if "test_image_psnr" in r)
    je = next(r for r in jr if "test_image_psnr" in r)
    np.testing.assert_allclose(te["test_image_psnr"], je["test_image_psnr"], atol=1e-2)
    with open(os.path.join(tout["log_dir"], "checkpoint-61", "metadata.json")) as f:
        meta = json.load(f)
    assert list(meta["field_configs"]) == ["static"]
    assert meta["run"]["step"] == 61 and "selection_metric" in meta["run"]
    assert tck.load_field_configs(os.path.join(tout["log_dir"], "checkpoint"))["static"] == \
        ttr.static_config_from_args(tcfg.parse_args(TINY))


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def test_static_resume_is_bitwise(tiny_data, tmp_path, deterministic):
    extra = [*TINY, "--data_root", tiny_data, "--platform", "cpu", "--n_iters", "5",
             "--save_every", "3", "--display_every", "3", "--log_every", "1"]
    straight = run_nerf.main([*extra, "--log_dir_root", str(tmp_path / "a")])
    ckpt = os.path.join(straight["log_dir"], "checkpoint-3")
    resumed = run_nerf.main([*extra, "--log_dir_root", str(tmp_path / "b"),
                             "--resume_from", ckpt])
    assert straight["final_step"] == resumed["final_step"] == 6
    assert_states_equal(resumed["state"], straight["state"])
    assert [r["step"] for r in records(resumed["log_dir"]) if "train_loss" in r] == [3, 4, 5]
