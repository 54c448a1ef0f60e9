"""Data and depth parallelism of the torch port (``nerfca_tpu_torch/parallel``
on ``torch.distributed``) against the JAX package's on the CPU.

Two ranks over gloo run in spawned processes (``tests/torch_dist_worker.py``,
which imports no JAX) on numpy inputs made here: the sharded K3 entry
against JAX's ``fused_train_loss_and_grads_sharded`` on a 2-device mesh
(Pallas in interpret mode) and against the port's unsharded call, the
depth-sharded render against JAX's, two data-parallel train steps against
JAX's data-parallel step, and the mesh helpers. ``multihost.initialize``'s
strictness, and each train step under a one-rank mesh against the same
step without one, run in this process (the autograd paths under two ranks
are in ``tests/test_torch_parallel_autograd.py``)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import multiprocessing as mp
import os
import pickle
import socket
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads_sharded as jax_sharded
from nerfca_tpu.ops.sampling import linspace_depths as j_linspace
from nerfca_tpu.parallel.depth_shard import depth_sharded_render as jax_depth_render
from nerfca_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from nerfca_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nerfca_tpu.parallel.mesh import replicate as jax_replicate
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops.cuda import fused_train as tk3
from nerfca_tpu_torch.ops.hull import MotionHull as THull
from nerfca_tpu_torch.parallel import make_mesh, multihost
from nerfca_tpu_torch.train import step as ts
from tests import torch_dist_worker
from tests.test_torch_fused_train import HP as K3_HP
from tests.test_torch_fused_train import problem as k3_problem
from tests.test_train_step import synthetic_rays

WORLD = 2
N_STEPS = 2
# tests/test_parallel.py:182-232's tolerances for the sharded entry: loss
# rel 1e-5, terms rel 1e-5 (1e-12 absolute), grads rel 1e-4 + 1e-7
# absolute; the depth render 2e-5 absolute; the train steps against JAX's
# plain data-parallel step (the same math in another library and another
# summation order): loss rel 1e-5 a step, params 1e-6 after one step and
# 1e-5 after more (tests/test_torch_step.py)
LOSS_RTOL, TERM_TOL, GRAD_TOL = 1e-5, dict(rtol=1e-5, atol=1e-12), dict(rtol=1e-4, atol=1e-7)
RENDER_ATOL = 2e-5
PARAMS_ATOL = 1e-5


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def k3_inputs():
    """The K3 problem of tests/test_torch_fused_train.py at 16 rays."""
    kw = dict(num_early_layers=2, num_filters=128, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100)
    cfgs = (kw, dict(kw, use_time_latents=True, num_time_dim=8))
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(0),
                                                       jf.FieldConfig(**cfgs[0])))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(1),
                                                         jf.FieldConfig(**cfgs[1])))
    rng = np.random.default_rng(3)
    r = 16
    batch = {
        "origins": np.tile(np.array([[4.5, 0.0, 0.0]], np.float32), (r, 1)),
        "directions": (rng.normal(0, 0.02, (r, 3)) + [-1.0, 0.0, 0.0]).astype(np.float32),
        "phases": rng.integers(0, 10, r).astype(np.int32),
        "pixels": (2.1 + 0.05 * rng.random(r)).astype(np.float32),
        "weights": (1.0 + rng.random(r)).astype(np.float32),
        "initial_intensities": np.full(r, 2.16, np.float32),
    }
    _, _, _, z = k3_problem()
    hp = dict(K3_HP, img_sample_size=r)
    return {"cfgs": cfgs, "ps": ps, "pt": pt, "batch": batch, "z": z, "hp": hp,
            "lw": np.array([1e-3, 1e-4, 1e-4, 1e-6], np.float32),
            "window": np.asarray(free_window_mask(4, 50, 100, 1))}


def depth_inputs():
    kw = dict(num_early_layers=2, num_filters=16, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=200)
    cfgs = (kw, dict(kw, use_time_latents=True, num_time_dim=4))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"static": jax.tree.map(np.asarray, jf.init_static_field(
                  k1, jf.FieldConfig(**cfgs[0]))),
              "temp": jax.tree.map(np.asarray, jf.init_temporal_field(
                  k2, jf.FieldConfig(**cfgs[1])))}
    rng = np.random.default_rng(0)
    r, s = 16, 64
    return {"cfgs": cfgs, "params": params,
            "origins": np.tile(np.array([[4.5, 0.0, 0.0]], np.float32), (r, 1)),
            "directions": (np.array([[-1.0, 0.0, 0.0]]) + rng.normal(0, 0.01, (r, 3))
                           ).astype(np.float32),
            "phases": rng.integers(0, 10, r).astype(np.int32),
            "z": np.asarray(j_linspace(3.6, 5.4, s)),
            "windows": {"static": np.ones(4, np.float32), "temp": np.ones(4, np.float32)}}


def step_inputs():
    """The composite problem at the K3 envelope's width (the fused path
    needs 128-wide fields): 16 rays of 32 samples, two steps."""
    kw = dict(num_early_layers=1, num_filters=128, pos_enc="free_windowed", pos_enc_basis=4,
              pos_enc_window_start=1, pos_enc_window_decay_steps=200)
    cfgs = {"static": kw, "temp": dict(kw, use_time_latents=True, num_time_dim=4)}
    hp = dict(img_sample_size=16, depth_samples_coarse=32, favor_s_weight_start=1e-12,
              favor_s_weight_end=1e-10, favor_s_weight_delay_steps=50,
              dynamic_entro_weight_start=1e-10, dynamic_entro_weight_end=1e-8,
              occl_weight_start=1e-8, occl_weight_end=1e-4, l1_weight_start=1e-8,
              l1_weight_end=1e-15, hyperparam_decay_steps=200)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"static": jf.init_static_field(keys[0], jf.FieldConfig(**cfgs["static"])),
              "temp": jf.init_temporal_field(keys[1], jf.FieldConfig(**cfgs["temp"]))}
    rays, phases = synthetic_rays(256)
    return {"cfgs": cfgs, "hp": hp, "params": jax.tree.map(np.asarray, params),
            "rng": np.asarray(keys[2]), "tx": (1e-3, 1.0, 100), "rays": np.asarray(rays),
            "phases": np.asarray(phases), "z": np.asarray(j_linspace(3.6, 5.4, 32)),
            "n_steps": N_STEPS}


@pytest.fixture(scope="module")
def problem():
    return {"k3": k3_inputs(), "depth": depth_inputs(), "steps": step_inputs()}


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """Both ranks' results (spawned, gloo, a free port)."""
    tmp = tmp_path_factory.mktemp("ranks")
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_worker.run,
                         args=(r, WORLD, port, str(tmp / f"rank{r}.pkl"), problem))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def compare_trees(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), err_msg=str(path), **tol)


def assert_k3_close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert set(got["terms"]) == set(want["terms"])
    for k in want["terms"]:
        np.testing.assert_allclose(got["terms"][k], want["terms"][k], err_msg=k, **TERM_TOL)
    compare_trees(got["gs"], want["gs"], **GRAD_TOL)
    compare_trees(got["gt"], want["gt"], **GRAD_TOL)


def test_ranks_and_mesh_helpers(ranks):
    for r, out in enumerate(ranks):
        assert out["info"]["process_index"] == r and out["info"]["process_count"] == WORLD
        assert out["sharding"] == (r, WORLD)
        np.testing.assert_array_equal(out["shard"], np.arange(8)[4 * r:4 * r + 4])
        # every rank holds rank 0's tensors after replicate
        np.testing.assert_array_equal(out["replicated"]["a"], np.zeros(3))
        np.testing.assert_array_equal(out["replicated"]["b"][0], [0.5])
    # the all-reduced results are the same bits on both ranks
    a, b = ranks
    assert a["k3"]["loss"] == b["k3"]["loss"] and a["k3"]["terms"] == b["k3"]["terms"]
    for x, y in zip(jax.tree_util.tree_leaves((a["k3"]["gs"], a["k3"]["gt"])),
                    jax.tree_util.tree_leaves((b["k3"]["gs"], b["k3"]["gt"]))):
        np.testing.assert_array_equal(x, y)


def test_sharded_k3_refuses_a_batch_that_does_not_split(ranks):
    # 15 rays over 2 ranks: every rank raises before it computes anything
    for out in ranks:
        assert "15 rays do not split evenly over 2 shards" in out["uneven"]


def test_sharded_k3_matches_jax_sharded(ranks, problem, interpret_mode):
    k3 = problem["k3"]
    cs, ct = (jf.FieldConfig(**kw) for kw in k3["cfgs"])
    b = {k: jnp.asarray(v) for k, v in k3["batch"].items()}
    w = jnp.asarray(k3["window"])
    loss, terms, gs, gt = jax_sharded(
        jax_make_mesh(WORLD), "data", k3["ps"], k3["pt"], b["origins"], b["directions"],
        jnp.asarray(k3["z"]), b["phases"], b["pixels"], b["weights"],
        b["initial_intensities"], cs, ct, w, w, jnp.asarray(k3["lw"]),
        js.CompositeHParams(**k3["hp"]))
    want = {"loss": float(loss), "terms": {k: float(v) for k, v in terms.items()},
            "gs": jax.tree.map(np.asarray, gs), "gt": jax.tree.map(np.asarray, gt)}
    assert_k3_close(ranks[0]["k3"], want)


def test_sharded_k3_bf16_residuals_match_jax_sharded(ranks, problem, interpret_mode):
    # the sharded entry with bf16 residual storage against JAX's on its
    # 2-device mesh: the loss and terms at the tolerances above and equal to
    # the f32 sharded call's bit for bit (the forward and the loss stay
    # f32); gradients within 1e-3 of each leaf's scale (the K3 tests'
    # bound: a stored activation whose bf16 rounding the f32 summation
    # order flips moves its terms by 2^-8)
    k3 = problem["k3"]
    cs, ct = (jf.FieldConfig(**kw) for kw in k3["cfgs"])
    b = {k: jnp.asarray(v) for k, v in k3["batch"].items()}
    w = jnp.asarray(k3["window"])
    loss, terms, gs, gt = jax_sharded(
        jax_make_mesh(WORLD), "data", k3["ps"], k3["pt"], b["origins"], b["directions"],
        jnp.asarray(k3["z"]), b["phases"], b["pixels"], b["weights"],
        b["initial_intensities"], cs, ct, w, w, jnp.asarray(k3["lw"]),
        js.CompositeHParams(**k3["hp"], pallas_bf16_residuals=True))
    got = ranks[0]["k3_res"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    for k in terms:
        np.testing.assert_allclose(got["terms"][k], float(terms[k]), err_msg=k, **TERM_TOL)
    assert got["loss"] == ranks[0]["k3"]["loss"] and got["terms"] == ranks[0]["k3"]["terms"]
    for mine, theirs in ((got["gs"], gs), (got["gt"], gt)):
        assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(theirs)
        for (path, y), x in zip(jax.tree_util.tree_flatten_with_path(theirs)[0],
                                jax.tree_util.tree_leaves(mine)):
            y = np.asarray(y)
            assert np.abs(x - y).max() <= 1e-3 * np.abs(y).max(), path
    moved = [not np.array_equal(x, y) for x, y in zip(
        jax.tree_util.tree_leaves((got["gs"], got["gt"])),
        jax.tree_util.tree_leaves((ranks[0]["k3"]["gs"], ranks[0]["k3"]["gt"])))]
    assert any(moved)


def test_sharded_k3_matches_the_unsharded_call(ranks, problem):
    k3 = problem["k3"]
    cs, ct = (tf.FieldConfig(**kw) for kw in k3["cfgs"])
    tb = {k: torch.tensor(v) for k, v in k3["batch"].items()}
    w = torch.tensor(k3["window"])
    loss, terms, gs, gt = tk3.fused_train_loss_and_grads(
        tf.params_from_jax(k3["ps"]), tf.params_from_jax(k3["pt"]), tb["origins"],
        tb["directions"], torch.tensor(k3["z"]), tb["phases"], tb["pixels"], tb["weights"],
        tb["initial_intensities"], cs, ct, w, w, torch.tensor(k3["lw"]),
        ts.CompositeHParams(**k3["hp"]))
    want = {"loss": float(loss), "terms": {k: float(v) for k, v in terms.items()},
            "gs": tf.params_to_jax(gs), "gt": tf.params_to_jax(gt)}
    assert_k3_close(ranks[0]["k3"], want)


def test_depth_sharded_render_matches_jax(ranks, problem):
    dp = problem["depth"]
    cs, ct = (jf.FieldConfig(**kw) for kw in dp["cfgs"])
    want = jax_depth_render(jax_make_mesh(WORLD, axis_names=("depth",)), dp["params"],
                            jnp.asarray(dp["origins"]), jnp.asarray(dp["directions"]),
                            jnp.asarray(dp["phases"]), jnp.asarray(dp["z"]), cs, ct,
                            {k: jnp.asarray(v) for k, v in dp["windows"].items()}, 2.16)
    for out in ranks:
        for a, b in zip(out["depth"], want):
            np.testing.assert_allclose(a, np.asarray(b), atol=RENDER_ATOL, rtol=0)
        # the decomposed attenuations sum to the total
        np.testing.assert_allclose(2.16 - out["depth"][0], out["depth"][1] + out["depth"][2],
                                   atol=RENDER_ATOL)


def test_data_parallel_steps_match_jax(ranks, problem):
    st = problem["steps"]
    cfgs = {k: jf.FieldConfig(**kw) for k, kw in st["cfgs"].items()}
    tx = js.make_optimizer(*st["tx"])
    mesh = jax_make_mesh(WORLD)
    params = jax.tree.map(jnp.asarray, st["params"])
    state = js.TrainState(jax_replicate(mesh, params), jax_replicate(mesh, tx.init(params)),
                          jnp.zeros((), jnp.int32), jnp.asarray(st["rng"]))
    step = jax.jit(js.make_composite_train_step(
        cfgs, js.CompositeHParams(**st["hp"]), tx, jnp.asarray(st["z"]), 2.16,
        batch_sharding=jax_batch_sharding(mesh)))
    zero = jnp.zeros(1, jnp.int32)
    losses = []
    for _ in range(N_STEPS):
        state, m = step(state, jnp.asarray(st["rays"]), jnp.asarray(st["phases"]), zero, zero)
        losses.append(float(m["train_loss"]))
    # the ranks hold the same parameters, bit for bit
    for x, y in zip(jax.tree_util.tree_leaves(ranks[0]["params"]),
                    jax.tree_util.tree_leaves(ranks[1]["params"])):
        np.testing.assert_array_equal(x, y)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_RTOL * N_STEPS)
    compare_trees(ranks[0]["params"], jax.tree.map(np.asarray, state.params),
                  atol=PARAMS_ATOL, rtol=0)
    np.testing.assert_array_equal(ranks[0]["rng"], np.asarray(state.rng))


# ---------------------------------------------------------------------------
# In this process: bring-up strictness and the step's branch under a mesh


def test_multihost_initialize_strictness(monkeypatch):
    assert not dist.is_initialized()

    def boom(*a, **k):
        raise RuntimeError("connection to coordinator failed")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost.initialize("10.0.0.1:1234", 2, 0, backend="gloo")
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="10.0.0.1:1234", backend="gloo")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        info = multihost.initialize(backend="gloo")
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert any("single-process" in str(x.message) for x in w)
    grid = list(range(7))
    assert multihost.shard_sweep(grid, process_id=0, process_count=2) == [0, 2, 4, 6]
    assert multihost.shard_sweep(grid, process_id=1, process_count=2) == [1, 3, 5]
    assert multihost.shard_sweep(grid) == grid  # one process: everything
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(device="cpu")


@pytest.fixture
def world_one():
    """A one-rank gloo group in this process, taken down afterwards."""
    info = multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="gloo")
    try:
        yield info
    finally:
        dist.destroy_process_group()


def test_mesh_step_branch_and_world_one(world_one, problem):
    # an already-initialized group is kept
    assert multihost.initialize(backend="gloo")["process_count"] == 1
    mesh = make_mesh(device="cpu")
    st = problem["steps"]
    cfgs = {k: tf.FieldConfig(**kw) for k, kw in st["cfgs"].items()}
    # the autograd paths under a mesh (the plain fields, K1/K2's twin): at
    # world 1 each step is the unsharded step, bit for bit
    for kw in (dict(use_pallas=False), dict(use_pallas=True, use_fused_loss=False)):
        assert_world_one_bitwise(mesh, st, lambda m: ts.make_composite_train_step(
            cfgs, ts.CompositeHParams(**st["hp"], **kw), ts.make_optimizer(*st["tx"]),
            torch.tensor(st["z"]), 2.16, mesh=m), st["params"])
    # world 1: the sharded entry is the unsharded call, bit for bit
    k3 = problem["k3"]
    cs, ct = (tf.FieldConfig(**kw) for kw in k3["cfgs"])
    tb = {k: torch.tensor(v) for k, v in k3["batch"].items()}
    w = torch.tensor(k3["window"])
    args = (tf.params_from_jax(k3["ps"]), tf.params_from_jax(k3["pt"]), tb["origins"],
            tb["directions"], torch.tensor(k3["z"]), tb["phases"], tb["pixels"], tb["weights"],
            tb["initial_intensities"], cs, ct, w, w, torch.tensor(k3["lw"]),
            ts.CompositeHParams(**k3["hp"]))
    torch.use_deterministic_algorithms(True)
    try:
        one = tk3.fused_train_loss_and_grads(*args)
        sharded = tk3.fused_train_loss_and_grads_sharded(mesh, "data", *args)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(one[0], sharded[0])
    for k in one[1]:
        assert torch.equal(one[1][k], sharded[1][k]), k
    for (n, a), (_, b) in zip(ts.param_items({"static": one[2], "temp": one[3]}),
                              ts.param_items({"static": sharded[2], "temp": sharded[3]})):
        assert torch.equal(a, b), n


def assert_world_one_bitwise(mesh, st, make_step, params) -> None:
    """``N_STEPS`` steps of ``make_step(mesh)`` and of ``make_step(None)``
    from the same state: the losses and metrics, parameters, Adam moments
    and keys bit for bit."""
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for m in (None, mesh):
            tp = {k: tf.params_from_jax(v) for k, v in params.items()}
            state = ts.TrainState(tp, ts.init_opt_state(tp), 0, np.asarray(st["rng"], np.uint32))
            step = make_step(m)
            rays, phases = torch.tensor(st["rays"]), torch.tensor(st["phases"]).long()
            ids = torch.arange(64), torch.arange(64, rays.shape[0])
            metrics = [step(state, rays, phases, *ids) for _ in range(N_STEPS)]
            runs.append((metrics, state))
    finally:
        torch.use_deterministic_algorithms(False)
    (m1, s1), (m2, s2) = runs
    for a, b in zip(m1, m2):
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    for (n, a), (_, b) in zip(ts.param_items(s1.params), ts.param_items(s2.params)):
        assert torch.equal(a, b), n
    for a, b in zip(s1.opt_state["mu"] + s1.opt_state["nu"],
                    s2.opt_state["mu"] + s2.opt_state["nu"]):
        assert torch.equal(a, b)
    assert s1.opt_state["count"] == s2.opt_state["count"] == N_STEPS
    np.testing.assert_array_equal(s1.rng, s2.rng)


@pytest.mark.parametrize("kind", ["fine", "static"])
def test_world_one_fine_and_static_steps_are_bitwise(world_one, problem, kind):
    # the fine pass (the K1/K2 twin at per-ray depths on both pairs, the
    # motion hull; the global max and ray 0's depths through the mesh's
    # collectives) and the static step (the one-field twin) at world 1: the
    # unsharded steps bit for bit
    mesh = make_mesh(device="cpu")
    st = problem["steps"]
    tx = ts.make_optimizer(*st["tx"])
    z = torch.tensor(st["z"])
    if kind == "static":
        cfg = tf.FieldConfig(**st["cfgs"]["static"])
        hp = ts.StaticHParams(img_sample_size=16, nb_var_rays=4, depth_samples_coarse=32,
                              occl_weight_start=1e-2, use_pallas=True)
        assert_world_one_bitwise(mesh, st, lambda m: ts.make_static_train_step(
            cfg, hp, tx, z, 2.16, mesh=m), {"static": st["params"]["static"]})
        return
    cfgs = {k: tf.FieldConfig(**kw) for k, kw in st["cfgs"].items()}
    cfgs.update(static_fine=cfgs["static"], temp_fine=cfgs["temp"])
    params = dict(st["params"], static_fine=st["params"]["static"],
                  temp_fine=st["params"]["temp"])
    hp = ts.CompositeHParams(**dict(st["hp"], nb_var_rays=4), depth_samples_fine=8,
                             use_pallas=True, hull_static_l1_weight_start=1e-3,
                             hull_static_l1_weight_end=1e-3)
    grid = (0.2 + 0.8 * np.random.default_rng(9).random((6, 6, 6))).astype(np.float32)
    hull = THull(torch.tensor(grid), torch.full((3,), 0.5), torch.zeros(3))

    def make_step(m):
        step = ts.make_composite_train_step(cfgs, hp, tx, z, 2.16, mesh=m)
        return lambda *a: step(*a, hull=hull)

    assert_world_one_bitwise(mesh, st, make_step, params)


def test_prepare_composite_wires_the_mesh(world_one, tmp_path, monkeypatch):
    from nerfca_tpu_torch.train import config as tcfg
    from nerfca_tpu_torch.train import trainer as ttr
    from tests.test_torch_trainer import FAST_DATA, SMALL

    calls = []
    sharded = ts.fused_train_loss_and_grads_sharded

    def counted(*a, **k):
        calls.append(a[1])
        return sharded(*a, **k)

    monkeypatch.setattr(ts, "fused_train_loss_and_grads_sharded", counted)
    args = tcfg.parse_args(["--config", SMALL, "--platform", "cpu", "--use_pallas", "true",
                            "--use_fused_loss", "true", "--static_num_filters", "128",
                            "--temp_num_filters", "128", "--data_root", str(tmp_path / "d"),
                            *FAST_DATA])
    setup = ttr.prepare_composite(args, torch.device("cpu"), mesh=make_mesh(device="cpu"))
    dd = setup["device_data"]
    m = setup["train_step"](setup["state"], dd["rays"], dd["phases"], dd["var_ids"],
                            dd["non_var_ids"])
    assert calls == ["data"] and np.isfinite(float(m["train_loss"]))
    # without a mesh the same step takes the unsharded entry
    plain = ttr.prepare_composite(args, torch.device("cpu"))
    plain["train_step"](plain["state"], dd["rays"], dd["phases"], dd["var_ids"],
                        dd["non_var_ids"])
    assert calls == ["data"]
    assert os.path.isdir(str(tmp_path / "d"))
