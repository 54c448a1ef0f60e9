"""The ``hash_render`` mix: test views of a hash-grid attenuation field (NAF's:
Instant-NGP's multiresolution hash encoding and a small MLP) through the
static method's eval renderer, one in flight, pixels read back.

The configuration's own keys give the field (``hash_*`` and ``static_*``
for the encoding and NAF's MLP, ``port_field`` for the program's layers);
this kind reads them itself, as ``mixes/__init__.py::config_fields`` covers
the NeRF-CA fields alone. The views, their seeded order and sample, the
depth grid and the image comparison are the render mixes'. Weights from
the seed: the table Uniform(-table_range, table_range) (a trained table's
spread: at Instant-NGP's +-1e-4 init every point reads ~0 and the check
would not see the gathers), the MLP nn.Linear's init with the output
layer scaled by ``out_scale`` and raised by ``out_bias``, so that the
sigmoid's densities span 0.05-0.95 and more over a view.

``correct``: ``view``, the worst gap of the sampled views' densities (the
renderer's sigma at every sample) over the reference's largest density,
and ``image``, the render mixes' pixel gap over the largest attenuation.
The densities carry the field's precision. The image does not: the static
method's image is ``i0 - 1e-2 sum sigma dist`` with sigma at most 1,
attenuations of a hundredth or less, so a few f32 roundings of a pixel
near ``i0`` read as much as a TF32 product's error; its limit catches a
fault in the image (a moved pixel, rays left out), not the precision."""

from __future__ import annotations

import math
import statistics
import sys
import time

import numpy as np
import torch

from portbench import inputs, tracing
from portbench.mixes import build_kernels, render, sync
from portbench.metrics import hash_roofline
from portbench.reference import hash_render as reference


def program_field(cfg: dict, half: float):
    """The program's ``FieldConfig`` of the configuration's field."""
    from nerfca_tpu_torch.models.fields import FieldConfig

    f = cfg["port_field"]
    return FieldConfig(num_early_layers=f["static_num_early_layers"],
                       num_late_layers=f["static_num_late_layers"],
                       num_filters=f["static_num_filters"], pos_enc=f["static_pos_enc"],
                       hidden_activation=f["static_hidden_activation"], hash_bound=half)


def weights(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The reference's weights (``{"layers": [...], "table"}``, NAF's
    order) from the seed."""
    width, enc = cfg["static_hidden_dim"], cfg["hash_levels"] * cfg["hash_features_per_level"]
    dims = []
    for i in range(cfg["static_num_layers"]):
        fan_in = enc if i == 0 else width + (enc if i in cfg["static_skips"] else 0)
        dims.append((fan_in, 1 if i == cfg["static_num_layers"] - 1 else width))
    sizes = [o * i + o for i, o in dims]
    u = torch.rand(sum(sizes), generator=inputs.generator(seed, device, 2), device=device)
    layers = []
    for (fan_in, fan_out), part in zip(dims, torch.split(u, sizes)):
        t = (2 * part - 1) / math.sqrt(fan_in)
        layers.append({"w": t[:fan_in * fan_out].reshape(fan_out, fan_in).clone(),
                       "b": t[fan_in * fan_out:].clone()})
    layers[-1]["w"] *= traffic["out_scale"]
    layers[-1]["b"] += traffic["out_bias"]
    table = torch.rand(reference.table_entries(cfg), cfg["hash_features_per_level"],
                       generator=inputs.generator(seed, device, 3), device=device)
    return {"layers": layers, "table": (2 * table - 1) * traffic["table_range"]}


def program_params(w: dict) -> dict:
    """The same weights in the program's layout: NAF's first two layers as
    the early layers, the skip layer, the output layer."""
    layers = [{k: t.clone() for k, t in layer.items()} for layer in w["layers"]]
    return {"static": {"early": layers[:2], "skip": layers[2], "late": [], "out": layers[3],
                       "table": w["table"].clone()}}


def setup(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Test views, the eval's depth grid, weights and the order of the
    views; the sample of views checked, drawn from the seed."""
    from nerfca_tpu_torch.train.step import StaticHParams

    acq = inputs.geometry.acquisition(cfg["data_size"])
    field = program_field(cfg, acq["half"])  # first: a program without the field fails here
    views = inputs.test_views(cfg, device)
    w = weights(cfg, traffic, seed, device)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(views))
    sample = sorted(rng.choice(len(views), traffic["check_views"], replace=False).tolist())
    hp = StaticHParams(img_sample_size=cfg["img_sample_size"],
                       depth_samples_coarse=cfg["depth_samples_per_ray_coarse"],
                       output_activation=cfg["output_activation"],
                       compute_dtype=cfg["compute_dtype"], use_pallas=cfg["use_pallas"])
    return {"cfg": cfg, "views": views, "acq": acq, "weights0": w, "params": program_params(w),
            "z": inputs.eval_depths(acq, cfg["depth_samples_per_ray_coarse"], seed, device),
            "fields": {"static": field}, "hp": hp, "i0": math.log(inputs.geometry.MAX_PIXEL_VALUE),
            "step": traffic["step"], "tile": traffic["tile"], "order": order, "sample": sample}


def render_one(su: dict, v: int):
    """One test view through the program's eval renderer: its image read
    back ``[1, W * H]``, and the renderer's outputs."""
    from nerfca_tpu_torch.train.evaluation import render_test_view

    view = su["views"][v]
    out = render_test_view(su["params"], view["origins"], view["directions"], None, su["z"],
                           su["step"], su["fields"], su["hp"], su["i0"], tile=su["tile"])
    return out["pix_static"][None].cpu(), out


def traced_views(su: dict, traffic: dict) -> tuple:
    """The device operations, the view spans and the runtime calls of a
    traced window of the cell's first ``trace_views`` views
    (``portbench/spans.py::profiler_events``), for the ``view_*`` readers."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans

    order, n_all = su["order"], len(su["views"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(traffic["trace_views"]):
            with tracing.span("portbench.view"):
                render_one(su, int(order[i % n_all]))
        torch.cuda.synchronize()
    return spans.profiler_events(prof)


def drive(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> dict:
    """One run of the cell: set-up and warm-up, the window of views (or a
    traced window, then the view spans' window), then the sampled views
    against the reference."""
    su = setup(cfg, traffic, seed, device)
    build_kernels(device)
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
        from portbench import spans

        def window():
            nonlocal n_views
            for i in range(traffic["trace_views"]):
                with tracing.span("portbench.view"):
                    render_one(su, int(order[i % n_all]))
                n_views += 1

        tr = tracing.traced(window)
        n, s = su["acq"]["n_detector"] ** 2, cfg["depth_samples_per_ray_coarse"]
        events = traced_views(su, traffic)
        ctx = {"kind": "hash_render", "trace": tr, "views": n_views, "rays": n, "samples": s,
               "hash_bound_s": n_views * hash_roofline.view_bound_s(cfg, n, s),
               "flops": n_views * hash_roofline.mlp_flops(cfg, n * s),
               "peak_flops": hash_roofline.PEAK_F32_FMA, "view_events": events,
               "view_spans": spans.reduce_views(*events)}
    else:
        t0 = time.time()
        while True:
            v = int(order[n_views % n_all])
            t1 = time.time()
            pix, out = render_one(su, v)
            t2 = time.time()
            lat.append(t2 - t1)
            n_views += 1
            # numpy's check: torch's takes ~0.2 ms of host on a 40000-pixel
            # view, a twentieth of the view, between its pixels and the next launch
            failed += int(not np.isfinite(pix.numpy()).all())
            if v in su["sample"] and v not in kept:
                kept[v] = (pix, out["static_sigma"])
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
            pix, out = render_one(su, v)
            kept[v] = (pix, out["static_sigma"])
    su.pop("params")
    checks = compare(su, {v: (p, s.cpu()) for v, (p, s) in kept.items()}, reference_views(su))
    return {"e2e": e2e, "ctx": ctx, "checks": checks, "memory_peak_bytes": int(peak),
            "attempted": n_views, "failed": failed}


def reference_views(su: dict, **kw) -> dict:
    """The reference's image and densities of each sampled view; ``kw``:
    ``tf32`` or ``table_dtype``, a control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for v in su["sample"]:
        pix, sigma = reference.render_view(su["weights0"], su["cfg"], su["views"][v], su["z"],
                                           su["i0"], su["acq"]["half"], **kw)
        out[v] = (pix.cpu(), sigma.cpu())
    return out


def compare(su: dict, got: dict, want: dict) -> dict:
    """``view``: the worst density gap over the sampled views, over the
    reference's largest density; ``image``: the worst pixel gap over the
    largest attenuation (``render.check_views``)."""
    top = max(float(want[v][1].abs().max()) for v in got)
    gap = max(float((s.double() - want[v][1].double()).abs().max()) for v, (_, s) in got.items())
    image = render.check_views(su, {v: p for v, (p, _) in got.items()},
                               {v: want[v][0] for v in got})
    return {"view": gap / top, "image": image}


def program_views(su: dict) -> dict:
    """The program's image and densities of each sampled view."""
    got = {}
    for v in su["sample"]:
        pix, out = render_one(su, v)
        got[v] = (pix, out["static_sigma"].cpu())
    return got


def readings(cfg: dict, traffic: dict, seed: int, device, control: bool) -> dict:
    """The program's ``view`` and ``image`` against the reference; with
    ``control`` also the controls': the reference with TF32 products, and
    with its table read in bf16, each in the program's place; and the
    program's bf16 path (the plain field with bf16 products: the kernel
    computes in f32 alone)."""
    su = setup(cfg, traffic, seed, device)
    ref = reference_views(su)
    out = {"program": compare(su, program_views(su), ref)}
    if control:
        out["control_tf32"] = compare(su, reference_views(su, tf32=True), ref)
        out["control_bf16_table"] = compare(su, reference_views(su, table_dtype=torch.bfloat16),
                                            ref)
        bf = setup(dict(cfg, compute_dtype="bfloat16"), traffic, seed, device)
        out["program_bf16"] = compare(su, program_views(bf), ref)
    return out
