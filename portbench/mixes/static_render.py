"""The ``static_render`` mix: the static method's test views through the
eval's renderer with its one field, one in flight, pixels read back.
``correct``: the views drawn from the seed against the reference's images.
The set-up (views, depths, weights, the seed's order and sample) and the
comparison are the ``render`` mix's."""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from portbench import counting, spans, tracing
from portbench.mixes import build_kernels, render, sync
from portbench.reference import static_render as reference

setup = render.setup


def render_one(su: dict, v: int) -> torch.Tensor:
    """One test view through the program's eval renderer with the static
    field alone, its image read back ``[1, W * H]``."""
    from nerfca_tpu_torch.train.evaluation import render_test_view

    view = su["views"][v]
    out = render_test_view(su["params"], view["origins"], view["directions"], None, su["z"],
                           su["step"], su["fields"], su["hp"], su["i0"], tile=su["tile"])
    return out["pix_static"][None].cpu()


def traced_views(su: dict, traffic: dict) -> list:
    """The records of the program's view spans (``portbench/spans.py``) over
    a traced window of the cell's first ``trace_views`` views, for the
    ``view_*`` readers."""
    from torch.profiler import ProfilerActivity, profile

    order, n_all = su["order"], len(su["views"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(traffic["trace_views"]):
            with tracing.span("portbench.view"):
                render_one(su, int(order[i % n_all]))
        torch.cuda.synchronize()
    return spans.reduce_views(*spans.profiler_events(prof))


def drive(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> dict:
    """One run of a static render cell: set-up and warm-up, the window of
    views (or a traced window, then the view spans' window), then the
    sampled views against the reference."""
    build_kernels(device)
    su = setup(cfg, traffic, seed, device)
    order, n_all = su["order"], len(su["views"])
    for i in range(traffic["warmup_views"]):
        render_one(su, int(order[i % n_all]))
    sync(device)
    setup_s = time.time() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    kept, lat, n_views, failed = {}, [], 0, 0
    ctx = e2e = None
    if trace:
        def window():
            nonlocal n_views
            for i in range(traffic["trace_views"]):
                with tracing.span("portbench.view"):
                    render_one(su, int(order[i % n_all]))
                n_views += 1

        tr = tracing.traced(window)
        cfg = su["cfg"]
        n, s = su["acq"]["n_detector"] ** 2, cfg["depth_samples_per_ray_coarse"]
        ctx = {"kind": "static_render", "trace": tr, "views": n_views, "rays": n, "samples": s,
               "k1_bound_s": n_views * counting.k1_bound_s(cfg, n, s),
               "flops": n_views * counting.forward_flops(cfg, n * s),
               "peak_flops": counting.PEAK_FLOPS[cfg["compute_dtype"]],
               "view_spans": traced_views(su, traffic)}
    else:
        t0 = time.time()
        while True:
            v = int(order[n_views % n_all])
            t1 = time.time()
            pix = render_one(su, v)
            t2 = time.time()
            lat.append(t2 - t1)
            n_views += 1
            failed += int(not torch.isfinite(pix).all())
            if v in su["sample"] and v not in kept:
                kept[v] = pix
            if t2 - t0 >= seconds:
                break
        med = statistics.median(lat)
        print(f"views {n_views}: s min {min(lat):.4f} median {med:.4f} max {max(lat):.4f}, "
              f"{sum(x > 1.1 * med for x in lat)} over 1.1 x median", file=sys.stderr)
        e2e = {"render_views_per_s": n_views / (t2 - t0),
               "render_view_p95_ms": 1e3 * float(np.percentile(lat, 95)), "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    for v in su["sample"]:  # a view the window did not reach is rendered now
        if v not in kept:
            kept[v] = render_one(su, v)
    su.pop("params")
    checks = {"view": render.check_views(su, kept, reference_views(su, kept))}
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "memory_peak_bytes": int(peak),
            "attempted": n_views, "failed": failed}


def reference_views(su: dict, views, tf32: bool = False) -> dict:
    """The reference's images of ``views``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {v: reference.render_view(su["weights0"], su["cfg"], su["views"][v], su["z"],
                                     su["step"], su["i0"], tf32=tf32).cpu()
            for v in views}


def readings(cfg: dict, traffic: dict, seed: int, device, control: bool) -> dict:
    """The program's ``view`` against the reference; with ``control`` also
    the control's (the reference in TF32 in the program's place) and the
    program's bf16 path's."""
    su = setup(cfg, traffic, seed, device)
    kept = {v: render_one(su, v) for v in su["sample"]}
    ref = reference_views(su, su["sample"])
    out = {"program": {"view": render.check_views(su, kept, ref)}}
    if control:
        ctl = reference_views(su, su["sample"], tf32=True)
        out["control_tf32"] = {"view": render.check_views(su, ctl, ref)}
        bf = setup(cfg, traffic, seed, device, compute_dtype="bfloat16")
        out["program_bf16"] = {"view": render.check_views(
            su, {v: render_one(bf, v) for v in su["sample"]}, ref)}
    return out
