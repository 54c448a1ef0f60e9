"""The torch port's checkpoints against the JAX package's: the manager's
on-disk layout for the same saves, metadata read across packages, a
bitwise save/load round trip, bitwise resume through the trainer, the
patience stop and checkpoint selection, the profile window, and Adam's
state carried between optax and the port."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.train import checkpoint as jck
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.data.dataset import build_dataset
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import run_composite
from nerfca_tpu_torch.train import step as ts
from nerfca_tpu_torch.train import trainer as ttr
from tests.test_torch_step import cfgs as step_cfgs
from tests.test_torch_step import hparams, problem, torch_params
from tests.test_torch_trainer import FAST_DATA, SMALL
from tests.test_train_step import make_state as jax_state
from tests.test_train_step import tiny_cfgs


def port_cfgs():
    return {k: tf.FieldConfig(**dataclasses.asdict(v)) for k, v in tiny_cfgs().items()}


def port_state(seed=0, step=0):
    cfgs = port_cfgs()
    keys = prng.split(prng.key(seed), 3)
    params = {"static": tf.init_static_field(keys[0], cfgs["static"]),
              "temp": tf.init_temporal_field(keys[1], cfgs["temp"])}
    return ts.TrainState(params=params, opt_state=ts.init_opt_state(params), step=step,
                         rng=keys[2])


# ---------------------------------------------------------------------------
# CheckpointManager: the same saves leave the same layout in both packages

SCENARIOS = {
    # keep-last-2 with the best (step 1) kept past its turn
    "retention": [("manager", 2), ("save", 0, 10.0), ("save", 1, 30.0), ("save", 2, 20.0),
                  ("save", 3, 25.0)],
    # a resumed run: a fresh manager over the same dir keeps the best
    "resume_preserves_best": [("manager", 1), ("save", 0, 10.0), ("save", 1, 30.0),
                              ("manager", 1), ("save", 2, 5.0), ("save", 3, 7.0)],
    # no checkpoint-best.json: the metric comes back from the best
    # checkpoint's own metadata; a worse metric keeps it, a better replaces
    "legacy_recovery": [("manager", 2), ("save", 0, 10.0), ("save", 1, 30.0),
                        ("drop_best_json",), ("manager", 2), ("save", 2, 5.0),
                        ("save", 3, 31.0)],
    # no json and no embedded metric: the best is pinned and never pruned
    "pinned_unknown_best": [("manager", 1), ("save", 0, 10.0), ("save", 1, 30.0),
                            ("drop_best_json",), ("drop_metric", 1), ("manager", 1),
                            ("save", 2, 99.0), ("save", 3, 98.0)],
    # saves without a metric: history and the latest link only
    "no_metric": [("manager", 2), ("save", 0, None), ("save", 1, None), ("save", 2, None)],
}


def layout(root):
    names = sorted(os.listdir(root)) if os.path.isdir(root) else []
    links = {n: os.readlink(os.path.join(root, n)) for n in names
             if os.path.islink(os.path.join(root, n))}
    best = None
    if "checkpoint-best.json" in names:
        with open(os.path.join(root, "checkpoint-best.json")) as f:
            best = json.load(f)
    metrics = {}
    for n in names:
        if n.startswith("checkpoint-") and n[11:].isdigit():
            with open(os.path.join(root, n, "metadata.json")) as f:
                metrics[n] = json.load(f).get("run", {}).get("selection_metric")
    return {"names": names, "links": links, "best_json": best, "embedded": metrics}


def play(ops, root, manager_cls, state_at):
    """Run ``ops``; the layout and the manager's record after every op, and
    the warnings raised."""
    mgr, snaps, caught = None, [], []
    for op in ops:
        if op[0] == "manager":
            mgr = manager_cls(str(root), keep_last_n=op[1])
        elif op[0] == "save":
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                mgr.save(state_at(op[1]), run_metadata={"note": "t"}, metric=op[2])
            caught += [str(w.message) for w in rec]
        elif op[0] == "drop_best_json":
            os.remove(os.path.join(root, "checkpoint-best.json"))
        elif op[0] == "drop_metric":
            path = os.path.join(root, f"checkpoint-{op[1]}", "metadata.json")
            with open(path) as f:
                meta = json.load(f)
            meta["run"].pop("selection_metric")
            with open(path, "w") as f:
                json.dump(meta, f)
        snaps.append((layout(root), mgr.best_step, mgr.best_metric))
    return snaps, caught


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_checkpoint_manager_layout_matches_jax(scenario, tmp_path):
    jstate = jax_state(tiny_cfgs(), js.make_optimizer(1e-3, 0.01, 100))
    tstate = port_state()
    j_snaps, j_warn = play(SCENARIOS[scenario], tmp_path / "jax", jck.CheckpointManager,
                           lambda i: jstate._replace(step=jnp.asarray(i, jnp.int32)))
    t_snaps, t_warn = play(SCENARIOS[scenario], tmp_path / "torch", tck.CheckpointManager,
                           lambda i: dataclasses.replace(tstate, step=i))
    assert t_snaps == j_snaps
    assert t_warn == j_warn
    if scenario == "pinned_unknown_best":
        assert t_snaps[-1][0]["links"]["checkpoint-best"] == "checkpoint-1"
        assert any("pinned" in w for w in t_warn)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_field_config_metadata_reads_across_packages(writer, tmp_path):
    cfgs = tiny_cfgs(fine=True)
    run = {"data_name": "SYNTH", "step": 7, "hull": {"use_motion_hull": True, "hull_res": 48}}
    if writer == "jax":
        state = jax_state(cfgs, js.make_optimizer(1e-3, 0.01, 100))
        jck.save_checkpoint(str(tmp_path), state, cfgs, run_metadata=run)
        loaded = tck.load_field_configs(str(tmp_path))
        # and the port's own keys at their defaults
        want = {k: {**dataclasses.asdict(v), **tf.PORT_ONLY_DEFAULTS} for k, v in cfgs.items()}
    else:
        tcfgs = {k: tf.FieldConfig(**dataclasses.asdict(v)) for k, v in cfgs.items()}
        tck.save_checkpoint(str(tmp_path), port_state(), tcfgs, run_metadata=run)
        loaded = jck.load_field_configs(str(tmp_path))
        # the port's own keys at their defaults are left out for JAX
        want = {k: {n: x for n, x in dataclasses.asdict(v).items()
                    if n not in tf.PORT_ONLY_DEFAULTS} for k, v in tcfgs.items()}
        assert all(dataclasses.asdict(v)[n] == x for v in tcfgs.values()
                   for n, x in tf.PORT_ONLY_DEFAULTS.items())
    assert {k: dataclasses.asdict(v) for k, v in loaded.items()} == want
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)
    assert meta["format_version"] == 1 and meta["run"] == run


# ---------------------------------------------------------------------------
# Round trip, params-only load, device check

def advanced_state():
    """A port state three steps in: nontrivial params, moments and count."""
    state = port_state(seed=3)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = [torch.tensor(rng.normal(size=t.shape).astype(np.float32))
                 for _, t in ts.param_items(state.params)]
        ts.adam_update(state.params, state.opt_state, grads, ts.make_optimizer(1e-3, 0.1, 100),
                       step, ts.CompositeHParams())
        state.rng = prng.split(state.rng)[0]
        state.step += 1
    return state


def assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for (n, x), (_, y) in zip(ts.param_items(a.params), ts.param_items(b.params)):
        assert torch.equal(x, y), n
    for key in ("mu", "nu"):
        for x, y in zip(a.opt_state[key], b.opt_state[key]):
            assert torch.equal(x, y), key
    np.testing.assert_array_equal(a.rng, b.rng)
    assert a.rng.dtype == np.uint32


def test_round_trip_is_bitwise(tmp_path):
    state = advanced_state()
    tck.save_checkpoint(str(tmp_path), state, port_cfgs(), run_metadata={"step": 3})
    restored = tck.load_checkpoint(str(tmp_path), port_state(seed=99))
    assert_states_equal(restored, state)


def test_params_only_load_keeps_the_example_optimizer_and_key(tmp_path):
    state = advanced_state()
    tck.save_checkpoint(str(tmp_path), state)
    example = port_state(seed=99)
    restored = tck.load_checkpoint(str(tmp_path), example, params_only=True)
    assert restored.step == 3
    for (n, x), (_, y) in zip(ts.param_items(restored.params), ts.param_items(state.params)):
        assert torch.equal(x, y), n
    assert restored.opt_state is example.opt_state and restored.rng is example.rng


def test_resume_restores_the_jax_key(tmp_path):
    # the key is the JAX trainer's, kept as int64 in the file: the resumed
    # step draws what the uninterrupted one draws
    state = advanced_state()
    tck.save_checkpoint(str(tmp_path), state)
    saved = torch.load(tmp_path / tck.STATE_FILE, weights_only=True)
    assert saved["rng"].dtype == torch.int64
    restored = tck.load_checkpoint(str(tmp_path), port_state())
    hp = ts.CompositeHParams(img_sample_size=16, nb_var_rays=4, ray_jitter=1e-3)
    a = ts.step_draws(restored.rng, hp, 10, 30, 40, 8)
    b = ts.step_draws(state.rng, hp, 10, 30, 40, 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_load_rejects_another_tree(tmp_path):
    tck.save_checkpoint(str(tmp_path), advanced_state())
    cfgs = port_cfgs()
    wide = dataclasses.replace(cfgs["static"], num_early_layers=3)
    params = {"static": tf.init_static_field(prng.key(0), wide),
              "temp": tf.init_temporal_field(prng.key(1), cfgs["temp"])}
    example = ts.TrainState(params, ts.init_opt_state(params), 0, prng.key(2))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_checkpoint(str(tmp_path), example)


# ---------------------------------------------------------------------------
# The trainer: saves, resume, patience, selection, profile

@pytest.fixture
def deterministic():
    # the CPU's threaded index backward (the latent gather) sums in a
    # varying order; the card's K3 path has no atomics by design
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    # 40 projector samples per ray keep the build short
    root = str(tmp_path_factory.mktemp("data"))
    build_dataset(tcfg.parse_args(["--config", SMALL, *FAST_DATA]), root, projector_samples=40)
    return root


def train(data_root, cases, *extra):
    return run_composite.main([
        "--config", SMALL, "--platform", "cpu", "--log_every", "1", "--data_root", data_root,
        "--log_dir_root", str(cases), *FAST_DATA, *extra])


def records(out):
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


FUSED = ["--use_pallas", "true", "--use_fused_loss", "true", "--static_num_filters", "128",
         "--temp_num_filters", "128", "--depth_samples_per_ray_coarse", "64",
         "--img_sample_size", "64"]


@pytest.mark.parametrize("path", ["plain", "fused_loss"])
def test_resume_is_bitwise(path, data_root, tmp_path, deterministic):
    # 6 steps straight against 3 steps, a save, and a resume to 6: the same
    # params, moments, count, step and generator, bit for bit
    extra = ["--n_iters", "5", "--save_every", "3", "--display_every", "3"]
    extra += FUSED if path == "fused_loss" else []
    straight = train(data_root, tmp_path / "a", *extra)
    ckpt = os.path.join(straight["log_dir"], "checkpoint-3")
    assert os.path.isdir(ckpt)
    resumed = train(data_root, tmp_path / "b", *extra, "--resume_from", ckpt)
    assert straight["final_step"] == resumed["final_step"] == 6
    assert_states_equal(resumed["state"], straight["state"])
    steps = [r["step"] for r in records(resumed) if "train_loss" in r]
    assert steps == [3, 4, 5]
    # the saves of the resumed run: 6 (save_every, and the end)
    assert sorted(n for n in os.listdir(resumed["log_dir"]) if n[11:].isdigit()) == [
        "checkpoint-6"]


def test_saves_every_n_at_the_end_and_keeps_the_best(data_root, tmp_path):
    out = train(data_root, tmp_path, "--n_iters", "6", "--save_every", "3", "--display_every",
                "2", "--keep_last_n_checkpoints", "1")
    evals = {r["step"]: r["test_image_psnr"] for r in records(out) if "test_image_psnr" in r}
    assert sorted(evals) == [2, 4, 6]
    # saves at 3 (metric of the eval at 2), 6 and 7 (both the eval at 6)
    embedded = {3: evals[2], 6: evals[6], 7: evals[6]}
    best_step = max(sorted(embedded), key=embedded.get)
    names = sorted(os.listdir(out["log_dir"]))
    assert f"checkpoint-{best_step}" in names and "checkpoint-7" in names
    assert os.readlink(os.path.join(out["log_dir"], "checkpoint")) == "checkpoint-7"
    assert os.readlink(os.path.join(out["log_dir"], "checkpoint-best")) == (
        f"checkpoint-{best_step}")
    with open(os.path.join(out["log_dir"], "checkpoint-7", "metadata.json")) as f:
        meta = json.load(f)
    assert meta["run"]["selection_metric"] == evals[6]
    assert meta["run"]["data_name"] == "SYNTH" and meta["run"]["step"] == 7
    assert meta["run"]["hull"]["use_motion_hull"] is False


def test_patience_stops_where_jax_counts_and_still_saves(data_root, tmp_path):
    # --early_stop_patience 1: the run stops at the first eval whose
    # selection metric does not beat the best so far
    # (nerfca_tpu/train/trainer.py:641-649), and the save at that step fires
    out = train(data_root, tmp_path, "--n_iters", "40", "--display_every", "1",
                "--save_every", "1000", "--early_stop_patience", "1", "--lr", "3e-2")
    evals = [(r["step"], r["test_image_psnr"]) for r in records(out) if "test_image_psnr" in r]
    best, stop = float("-inf"), None
    for step, metric in evals:
        if metric > best:
            best = metric
        else:
            stop = step
            break
    assert stop is not None and stop < 41, evals
    assert out["final_step"] == stop and evals[-1][0] == stop
    assert sorted(n for n in os.listdir(out["log_dir"]) if n[11:].isdigit()) == [
        f"checkpoint-{stop}"]


def test_separated_psnr_ranks_separation_first(tmp_path):
    sharp_mixed = {"test_image_psnr": 30.0, "test_dyn_corr": 0.3}
    soft_separated = {"test_image_psnr": 10.0, "test_dyn_corr": 0.9}
    sel = ttr.selection_metric
    assert sel(sharp_mixed, "image_psnr", 0.5) > sel(soft_separated, "image_psnr", 0.5)
    assert sel(sharp_mixed, "separated_psnr", 0.5) < sel(soft_separated, "separated_psnr", 0.5)
    assert sel(sharp_mixed, "separated_psnr", 0.2) == 30.0
    assert sel({}, "separated_psnr", 0.5) is None
    # through the manager: the separated checkpoint is the best
    mgr = tck.CheckpointManager(str(tmp_path), keep_last_n=1)
    state = port_state()
    for step, ev in ((1, sharp_mixed), (2, soft_separated), (3, sharp_mixed)):
        mgr.save(dataclasses.replace(state, step=step),
                 metric=sel(ev, "separated_psnr", 0.5))
    assert os.readlink(tmp_path / "checkpoint-best") == "checkpoint-2"
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "checkpoint-2", "checkpoint-3",
                                            "checkpoint-best", "checkpoint-best.json"]


def test_separated_psnr_docks_the_trainer_metric(data_root, tmp_path):
    # a threshold above any correlation docks every checkpoint by 1000
    out = train(data_root, tmp_path, "--n_iters", "1", "--display_every", "2",
                "--best_metric", "separated_psnr", "--sep_corr_threshold", "1.5")
    psnr = next(r["test_image_psnr"] for r in records(out) if "test_image_psnr" in r)
    with open(os.path.join(out["log_dir"], "checkpoint-2", "metadata.json")) as f:
        assert json.load(f)["run"]["selection_metric"] == pytest.approx(psnr - 1000.0, abs=1e-9)


def test_profile_steps_writes_a_trace(data_root, tmp_path):
    out = train(data_root, tmp_path, "--n_iters", "3", "--display_every", "4",
                "--profile_steps", "2")
    traces = os.listdir(os.path.join(out["log_dir"], "profile"))
    assert len(traces) == 1
    with open(os.path.join(out["log_dir"], "profile", traces[0])) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


# ---------------------------------------------------------------------------
# Adam's state between optax and the port

@jax.jit
def _jax_loss_and_grads(params, batch, z, step):
    return jax.value_and_grad(
        lambda p: js.composite_loss_fn(p, batch, z, step, step_cfgs(jf), hparams(js, "strong")),
        has_aux=True)(params)


def jax_step_grads(params, step):
    _, batch, z = problem(seed=step)
    (loss, _), grads = _jax_loss_and_grads(params, batch, z, jnp.int32(step))
    return float(loss), grads


def test_opt_state_carried_from_jax_gives_the_same_next_step():
    # three JAX steps, then the fourth in each package from the carried
    # params and Adam state on the same batch and depths: the loss within
    # 1e-5 relative, the params within 1e-6 (tests/test_torch_step.py)
    params, _, _ = problem(seed=11)
    tx = js.make_optimizer(1e-3, 0.01, 300)
    opt = tx.init(params)
    for step in range(3):
        _, grads = jax_step_grads(params, step)
        updates, opt = tx.update(grads, opt, params)
        params = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    tparams = torch_params(params)
    topt = ts.opt_state_from_jax(opt)
    assert topt["count"] == 3

    jloss, grads = jax_step_grads(params, 3)
    updates, _ = tx.update(grads, opt, params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))

    _, batch, z = problem(seed=3)
    tloss, _, tgrads = ts.composite_grads(tparams, {k: torch.tensor(v) for k, v in batch.items()},
                                          torch.tensor(z), 3, step_cfgs(tf),
                                          hparams(ts, "strong"))
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5, atol=0)
    ts.adam_update(tparams, topt, tgrads, ts.make_optimizer(1e-3, 0.01, 300), 3,
                   hparams(ts, "strong"))
    got = {k: tf.params_to_jax(v) for k, v in tparams.items()}
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=str(path))
    assert topt["count"] == 4


def test_opt_state_round_trips_through_optax_layout():
    params, _, _ = problem(seed=5)
    tx = js.make_optimizer(1e-3, 0.01, 300)
    _, grads = jax_step_grads(params, 0)
    _, opt = tx.update(grads, tx.init(params), params)
    adam = opt[0]
    back = ts.opt_state_to_jax(ts.opt_state_from_jax(opt), torch_params(params))
    assert back["count"] == int(adam.count) and back["count"].dtype == np.int32
    for key in ("mu", "nu"):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(getattr(adam, key))[0],
                                jax.tree_util.tree_leaves(back[key])):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=f"{key} {path}")
    rebuilt = type(adam)(count=jnp.asarray(back["count"]), mu=back["mu"], nu=back["nu"])
    assert jax.tree_util.tree_structure(rebuilt) == jax.tree_util.tree_structure(adam)
