"""One rank of the data- and depth-parallel CPU tests
(``tests/test_torch_parallel.py``, and ``tests/test_torch_parallel_autograd.py``
through :func:`run_autograd`), run in a spawned process over gloo.
Imports torch and the port only: the ranks never import JAX.

:func:`run` and :func:`run_autograd` take numpy inputs, compute on this
rank and pickle numpy results to ``out_path``."""

from __future__ import annotations

import os
import pickle
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy() if hasattr(tree, "detach") else tree


def run(rank: int, world: int, port: int, out_path: str, problem: dict) -> None:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.models import fields as tf
    from nerfca_tpu_torch.ops.cuda import fused_train as tk3
    from nerfca_tpu_torch.parallel import (
        batch_sharding, depth_sharded_render, make_mesh, multihost, replicate, shard_batch,
    )
    from nerfca_tpu_torch.train import step as ts

    torch.use_deterministic_algorithms(True)
    info = multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    out = {"info": info}

    # the mesh helpers
    sharding = batch_sharding(mesh)
    out["sharding"] = (sharding.index, sharding.count)
    out["shard"] = shard_batch(mesh, {"x": torch.arange(8)})["x"].numpy()
    mine = {"a": torch.full((3,), float(rank)), "b": [torch.tensor([rank + 0.5])]}
    out["replicated"] = _to_numpy(replicate(mesh, mine))

    # the sharded K3 entry on the global batch
    k3 = problem["k3"]
    cs, ct = (tf.FieldConfig(**kw) for kw in k3["cfgs"])
    tb = {k: torch.tensor(v) for k, v in k3["batch"].items()}
    loss, terms, gs, gt = tk3.fused_train_loss_and_grads_sharded(
        mesh, "data", tf.params_from_jax(k3["ps"]), tf.params_from_jax(k3["pt"]),
        tb["origins"], tb["directions"], torch.tensor(k3["z"]), tb["phases"], tb["pixels"],
        tb["weights"], tb["initial_intensities"], cs, ct, torch.tensor(k3["window"]),
        torch.tensor(k3["window"]), torch.tensor(k3["lw"]), ts.CompositeHParams(**k3["hp"]))
    out["k3"] = {"loss": float(loss), "terms": {k: float(v) for k, v in terms.items()},
                 "gs": tf.params_to_jax(gs), "gt": tf.params_to_jax(gt)}
    # the same with bf16 residual storage
    loss, terms, gs, gt = tk3.fused_train_loss_and_grads_sharded(
        mesh, "data", tf.params_from_jax(k3["ps"]), tf.params_from_jax(k3["pt"]),
        tb["origins"], tb["directions"], torch.tensor(k3["z"]), tb["phases"], tb["pixels"],
        tb["weights"], tb["initial_intensities"], cs, ct, torch.tensor(k3["window"]),
        torch.tensor(k3["window"]), torch.tensor(k3["lw"]),
        ts.CompositeHParams(**k3["hp"], pallas_bf16_residuals=True))
    out["k3_res"] = {"loss": float(loss), "terms": {k: float(v) for k, v in terms.items()},
                     "gs": tf.params_to_jax(gs), "gt": tf.params_to_jax(gt)}
    # a batch of 15 rays does not split over 2 ranks
    odd = slice(0, 15)
    try:
        tk3.fused_train_loss_and_grads_sharded(
            mesh, "data", tf.params_from_jax(k3["ps"]), tf.params_from_jax(k3["pt"]),
            tb["origins"][odd], tb["directions"][odd], torch.tensor(k3["z"]),
            tb["phases"][odd], tb["pixels"][odd], tb["weights"][odd],
            tb["initial_intensities"][odd], cs, ct, torch.tensor(k3["window"]),
            torch.tensor(k3["window"]), torch.tensor(k3["lw"]), ts.CompositeHParams(**k3["hp"]))
        out["uneven"] = "no error"
    except ValueError as e:
        out["uneven"] = str(e)

    # the depth-sharded render over a 'depth' mesh of the same ranks
    dp = problem["depth"]
    dmesh = make_mesh(axis_names=("depth",), device="cpu")
    cs, ct = (tf.FieldConfig(**kw) for kw in dp["cfgs"])
    params = {k: tf.params_from_jax(v) for k, v in dp["params"].items()}
    windows = {k: torch.tensor(v) for k, v in dp["windows"].items()}
    pix, s_attn, t_attn = depth_sharded_render(
        dmesh, params, torch.tensor(dp["origins"]), torch.tensor(dp["directions"]),
        torch.tensor(dp["phases"]), torch.tensor(dp["z"]), cs, ct, windows, 2.16)
    out["depth"] = [pix.numpy(), s_attn.numpy(), t_attn.numpy()]

    # data-parallel train steps from the JAX state (the fused path, which
    # on CPU tensors runs K3's plain twin)
    st = problem["steps"]
    cfgs = {k: tf.FieldConfig(**kw) for k, kw in st["cfgs"].items()}
    params = {k: tf.params_from_jax(v) for k, v in st["params"].items()}
    state = ts.TrainState(params, ts.init_opt_state(params), 0, np.asarray(st["rng"], np.uint32))
    step = ts.make_composite_train_step(
        cfgs, ts.CompositeHParams(**st["hp"], use_pallas=True, use_fused_loss=True),
        ts.make_optimizer(*st["tx"]),
        torch.tensor(st["z"]), 2.16, mesh=mesh)
    zero = torch.zeros(1, dtype=torch.int64)
    rays, phases = torch.tensor(st["rays"]), torch.tensor(st["phases"]).long()
    out["losses"] = [float(step(state, rays, phases, zero, zero)["train_loss"])
                     for _ in range(st["n_steps"])]
    out["params"] = {k: tf.params_to_jax(v) for k, v in state.params.items()}
    out["rng"] = np.asarray(state.rng)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _train_case(case: dict, mesh) -> dict:
    """``case["n_steps"]`` data-parallel steps of one autograd-path case
    (``kind`` ``"composite"`` or ``"static"``) from its numpy state: the
    losses, the last step's metrics, the parameters, the key, the K1/K2
    twin's warnings."""
    import warnings

    import numpy as np
    import torch

    from nerfca_tpu_torch.models import fields as tf
    from nerfca_tpu_torch.ops.hull import MotionHull
    from nerfca_tpu_torch.train import step as ts

    params = {k: tf.params_from_jax(v) for k, v in case["params"].items()}
    state = ts.TrainState(params, ts.init_opt_state(params), 0,
                          np.asarray(case["rng"], np.uint32))
    z = torch.tensor(case["z"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if case["kind"] == "static":
            step = ts.make_static_train_step(tf.FieldConfig(**case["cfg"]),
                                             ts.StaticHParams(**case["hp"]),
                                             ts.make_optimizer(*case["tx"]), z, 2.16, mesh=mesh)
        else:
            step = ts.make_composite_train_step(
                {k: tf.FieldConfig(**kw) for k, kw in case["cfgs"].items()},
                ts.CompositeHParams(**case["hp"]), ts.make_optimizer(*case["tx"]), z, 2.16,
                mesh=mesh)
    hull = None
    if case.get("hull") is not None:
        hull = MotionHull(*(torch.tensor(a) for a in case["hull"]))
    args = (torch.tensor(case["rays"]), torch.tensor(case["phases"]).long(),
            torch.tensor(case["var_ids"]).long(), torch.tensor(case["non_var_ids"]).long())
    losses, metrics = [], None
    for _ in range(case["n_steps"]):
        metrics = step(state, *args, hull=hull)
        losses.append(float(metrics["train_loss"]))
    return {"losses": losses, "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: tf.params_to_jax(v) for k, v in state.params.items()},
            "rng": np.asarray(state.rng), "warnings": [str(w.message) for w in caught]}


def _gather_trap(mesh, problem: dict) -> dict:
    """The gradient of a loss over a per-ray vector spread over the ranks:
    through :func:`~nerfca_tpu_torch.parallel.collectives.sum_partials`
    (each rank's partial of the mean) and through
    ``torch.distributed.nn.functional.all_gather`` (every rank computes the
    whole mean from the gathered vector); and the cotangent that
    :func:`~nerfca_tpu_torch.parallel.collectives.from_first_shard` returns
    to the first rank's ray 0."""
    import torch
    import torch.distributed.nn.functional as dnn

    from nerfca_tpu_torch.parallel import batch_sharding
    from nerfca_tpu_torch.parallel.collectives import from_first_shard, sum_partials

    x, c = torch.tensor(problem["x"]), torch.tensor(problem["c"])
    n = x.shape[0]
    part = batch_sharding(mesh).uneven_slice(n)
    local = x[part].clone().requires_grad_(True)
    loss = sum_partials(torch.sum(c[part] * local ** 2) / n, mesh)
    ours = torch.autograd.grad(loss, local)[0]
    gathered = local.detach().clone().requires_grad_(True)
    whole = torch.cat(dnn.all_gather(gathered))
    trap = torch.autograd.grad(torch.sum(c * whole ** 2) / n, gathered)[0]
    # each rank uses ray 0 of the first rank's slice against its own rays
    first = local.detach().clone().requires_grad_(True)
    ray0 = from_first_shard(first[:1], mesh)
    bcast = torch.autograd.grad(sum_partials(torch.sum(c[part]) * ray0[0], mesh), first)[0]
    return {"loss": float(loss), "ours": ours.numpy(), "trap": trap.numpy(),
            "bcast": bcast.numpy()}


def run_autograd(rank: int, world: int, port: int, out_path: str, problem: dict) -> None:
    """Every case of ``problem["cases"]`` through the autograd paths under a
    ``world``-rank ``'data'`` mesh, and the gather trap."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from nerfca_tpu_torch.parallel import make_mesh, multihost

    torch.use_deterministic_algorithms(True)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    out = {name: _train_case(case, mesh) for name, case in problem["cases"].items()}
    out["trap"] = _gather_trap(mesh, problem["trap"])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
