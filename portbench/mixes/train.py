"""The ``train`` mix: chunks of train steps through the trainer's chunk
runner, one read-back a chunk. ``correct``: the first steps, driven
through the window's own call in set-up, against the reference's."""

from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from portbench import counting, inputs, threefry, tracing
from portbench.mixes import (build_kernels, program_fields, program_hparams, program_hull,
                             resolved, sync)
from portbench.reference import train as reference


def leaf_norms(tree_items) -> dict:
    return {n: float(torch.linalg.norm(t.detach().double())) for n, t in tree_items}


def norm_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    names = [n for n in want if keep is None or n in keep]
    med = statistics.median(want[n] for n in names)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in names)


def term_gaps(got: list, want: list) -> tuple:
    """The worst relative gap of the loss over the steps, and of the other
    read-back terms (terms that are 0 on both sides skipped)."""
    loss, terms = 0.0, 0.0
    for g, w in zip(got, want):
        for k, ref in w.items():
            if k not in g:
                raise KeyError(f"the program reports no {k}")
            ref, val = float(ref), float(g[k])
            if ref == 0.0 and val == 0.0:
                continue
            gap = abs(val - ref) / max(abs(ref), 1e-30)
            if k == "train_loss":
                loss = max(loss, gap)
            else:
                terms = max(terms, gap)
    return loss, terms



def setup(cfg: dict, traffic: dict, seed: int, device, **hp_changes) -> dict:
    """Inputs, weights and the program's step for a train cell;
    ``hp_changes`` replace fields of the program's hyperparameters (the
    control runs the program's own bf16 path)."""
    from nerfca_tpu_torch.train.step import (
        TrainState, init_opt_state, make_composite_train_step, make_optimizer,
        make_static_train_step,
    )

    cfg = resolved(cfg, traffic)
    data = inputs.train_rays(cfg, seed, device)
    hull = None
    if traffic.get("hull"):
        hull = inputs.hull_grid(data["phantom"], traffic["hull"]["res"], data["acq"]["half"],
                                traffic["hull"]["radius"], device)
    weights0 = inputs.field_weights(cfg["fields"], seed, device)
    z_base = inputs.base_depths(data["acq"], cfg["depth_samples_per_ray_coarse"], device)
    fields = program_fields(cfg)
    hp = dataclasses.replace(program_hparams(cfg), **hp_changes)
    tx = make_optimizer(cfg["lr"], cfg["lr_end_factor"], cfg["lr_decay_steps"])
    i0 = data["initial_intensity"]
    if cfg["method"] == "static":
        step_fn = make_static_train_step(fields["static"], hp, tx, z_base, i0)
    else:
        step_fn = make_composite_train_step(fields, hp, tx, z_base, i0)
    params = inputs.clone_params(weights0)
    state = TrainState(params=params, opt_state=init_opt_state(params), step=0,
                       rng=threefry.key(seed))
    dd = {k: data[k] for k in ("rays", "phases", "var_ids", "non_var_ids")}
    return {"cfg": cfg, "data": data, "hull": hull, "weights0": weights0, "z_base": z_base,
            "step_fn": step_fn, "state": state, "dd": dd, "p_hull": program_hull(hull),
            "seed": seed}


def run_chunk(su: dict, n: int, step_fn=None) -> dict:
    """``n`` steps through the trainer's chunk runner, one read-back."""
    from nerfca_tpu_torch.train.trainer import _run_chunk

    return _run_chunk(step_fn or su["step_fn"], su["state"], su["dd"], n, hull=su["p_hull"])


def first_steps(su: dict, n_steps: int) -> dict:
    """The first ``n_steps`` steps through the window's own call: each
    step's read-back terms, the first gradient by leaf as Adam got it
    (its first moment over ``1 - b1``), and the parameters' change by
    leaf after the steps."""
    from nerfca_tpu_torch.train.step import param_items

    state = su["state"]
    chunks = [run_chunk(su, 1)]
    mu1 = {n: m.detach().clone() for (n, _), m in zip(param_items(state.params),
                                                       state.opt_state["mu"])}
    chunks.append(run_chunk(su, n_steps - 1))
    w0 = dict(reference.leaves(su["weights0"]))
    return {"terms": [{k: v[i] for k, v in c.items()} for c in chunks
                      for i in range(len(c["train_loss"]))],
            "grad": leaf_norms((n, m / 0.1) for n, m in mu1.items()),
            "change": leaf_norms((n, t - w0[n]) for n, t in reference.leaves(state.params))}


def reference_steps(su: dict, n_steps: int, tf32: bool = False, loss_wrap=None) -> dict:
    """The reference's readings of the same first steps: from the same
    weights, key, rays and hull. ``loss_wrap`` plants a fault (control
    runs only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = inputs.clone_params(su["weights0"])
    recs = reference.train_steps(params, su["cfg"], su["data"], su["z_base"],
                                 threefry.key(su["seed"]), n_steps, hull=su["hull"], tf32=tf32,
                                 loss_wrap=loss_wrap)
    w0 = dict(reference.leaves(su["weights0"]))
    return {"terms": [r["terms"] for r in recs],
            "grad": leaf_norms(recs[0]["grads"].items()),
            "change": leaf_norms((n, t - w0[n]) for n, t in reference.leaves(params))}


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of a train cell: the loss and the other
    read-back terms of each of the first steps, the first gradient's norm
    by leaf, the parameters' change by leaf (leaves whose reference
    gradient is under a thousandth of the median leaf's left out: they
    move by round-off alone)."""
    med = statistics.median(want["grad"].values())
    moved = {n for n, v in want["grad"].items() if v >= 1e-3 * med}
    loss, terms = term_gaps(got["terms"], want["terms"])
    return {"loss": loss, "terms": terms, "grad": norm_gap(got["grad"], want["grad"]),
            "change": norm_gap(got["change"], want["change"], moved)}


def drive(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> dict:
    """One run of a train cell: set-up with the first steps, warm-up, the window
    of chunks (or a traced window), then the first steps against the
    reference."""
    build_kernels(device)
    su = setup(cfg, traffic, seed, device)
    cfg, chunk = su["cfg"], traffic["chunk_steps"]
    got = first_steps(su, traffic["check_steps"])
    for _ in range(traffic["warmup_chunks"]):
        run_chunk(su, chunk)
    sync(device)
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    steps, failed = 0, 0
    ctx = e2e = None
    if trace:
        wrapped = step_fn_traced(su["step_fn"])

        def window():
            nonlocal steps
            for _ in range(traffic["trace_chunks"]):
                with tracing.span("portbench.chunk"):
                    run_chunk(su, chunk, wrapped)
                steps += chunk

        ctx = train_ctx(cfg, tracing.traced(window), steps)
    else:
        t0 = time.time()
        chunk_s = []
        while True:
            t1 = time.time()
            m = run_chunk(su, chunk)
            chunk_s.append(time.time() - t1)
            steps += chunk
            failed += int((~np.isfinite(m["train_loss"])).sum())
            elapsed = time.time() - t0
            if elapsed >= seconds:
                break
        print(f"chunks {len(chunk_s)}: s min {min(chunk_s):.4f} median "
              f"{statistics.median(chunk_s):.4f} max {max(chunk_s):.4f}", file=sys.stderr)
        e2e = {"train_rays_per_s": steps * cfg["img_sample_size"] / elapsed,
               "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    for k in ("state", "step_fn", "dd"):  # the program's state is freed first
        su.pop(k)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(got, reference_steps(su, traffic["check_steps"]))
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "memory_peak_bytes": int(peak),
            "attempted": steps, "failed": failed}


def step_fn_traced(step_fn):
    def wrapped(*a, **k):
        with tracing.span("portbench.train_step"):
            return step_fn(*a, **k)
    return wrapped


def train_ctx(cfg: dict, tr: dict, steps: int) -> dict:
    n, s = cfg["img_sample_size"], cfg["depth_samples_per_ray_coarse"]
    return {"kind": "train", "trace": tr, "steps": steps,
            "k1_bound_s": steps * counting.k1_bound_s(cfg, n, s),
            "k2_bound_s": steps * counting.k2_bound_s(cfg, n, s),
            "flops": steps * 3 * counting.forward_flops(cfg, n * s),
            "peak_flops": counting.PEAK_FLOPS[cfg["compute_dtype"]]}


def half_batch(loss_fn):
    """A fault for the readings: the loss of the first half of each batch
    alone, the mean taken over it."""
    def wrapped(params, cfg, batch, z, step, hull, tf32):
        half = batch["origins"].shape[0] // 2
        batch = {k: (v[:half] if hasattr(v, "shape") and v.dim() > 0 else v)
                 for k, v in batch.items()}
        return loss_fn(params, cfg, batch, z, step, hull, tf32)
    return wrapped


def worst_leaves(got: dict, want: dict) -> dict:
    """Which leaf sets ``grad`` and ``change``, and the median leaf's gap."""
    out = {}
    for key in ("grad", "change"):
        med = statistics.median(want[key].values())
        gaps = {n: abs(got[key][n] - want[key][n]) / max(want[key][n], med) for n in want[key]}
        out[key] = [max(gaps, key=gaps.get), statistics.median(gaps.values())]
    return out


def readings(cfg: dict, traffic: dict, seed: int, device, control: bool) -> dict:
    """The program's numbers against the reference; with ``control`` also
    the control's (the reference in TF32 in the program's place), the
    reference with half of each batch left out, and the program's bf16
    path."""
    n = traffic["check_steps"]
    su = setup(cfg, traffic, seed, device)
    got = first_steps(su, n)
    su.pop("state"), su.pop("step_fn")
    ref = reference_steps(su, n)
    out = {"program": compare(got, ref), "worst_leaf": worst_leaves(got, ref)}
    if control:
        out["control_tf32"] = compare(reference_steps(su, n, tf32=True), ref)
        out["fault_half_batch"] = compare(reference_steps(su, n, loss_wrap=half_batch), ref)
        bf = setup(cfg, traffic, seed, device, compute_dtype="bfloat16")
        out["program_bf16"] = compare(first_steps(bf, n), ref)
    return out
