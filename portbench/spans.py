"""Per-view numbers from the program's own spans.

The port marks each test view it renders with a host span,
``nerfca.eval.view`` (``nerfca_tpu_torch/utils/profiling.py::span``), on
the clock the profiler gives the card's operations. A device operation
belongs to a view when the runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) began inside the view's
span; the profiler gives an operation and its call one correlation id.
Per view:

  - ``lead_ms``: the span's start to the start of the view's first K1
    (``fwd_kernel``) on the device;
  - ``tail_ms``: the end of the view's last K1 to the end of the last
    device operation launched inside the span;
  - ``launches``: the device kernels launched inside the span, K1
    included, memory copies and sets not counted (as ``n_kernels``);

and, to check the shared clock and place the rest of a view:
``first_op_after_span`` (the span starts before the view's first device
operation), ``k1_after_call_ms`` (the least, over the view's K1 launches,
of the kernel's start less its call's start: above 0 where the two clocks
agree), ``k1`` (the K1 launches attributed to the view), ``k1_ms`` (its
first K1's start to its last K1's end) and ``lead_host_ms`` (the span's
start to the first K1's call, on the host's clock alone).

The harness's trace (``tracing.traced``) keeps no events, so the readers
(``metrics/view_*.py``) trace a window of their own after the harness's,
once for the three of them (kept in the readers' ``ctx``): the cell's
first ``trace_views`` views in the seed's order, set up from the run's seed
as the render mix sets them up, one warm-up view first. A program without
the span gives no views, and the readers read nothing.
"""

from __future__ import annotations

import statistics
import sys

VIEW = "nerfca.eval.view"
K1 = "fwd_kernel"
NOT_LAUNCHES = ("Memcpy", "Memset")


def reduce_views(views: list, device: list, calls: dict) -> list:
    """One record per view span. ``views``: ``(start, end)`` of each
    ``nerfca.eval.view`` host span; ``device``: ``(start, end, name,
    correlation)`` of each device operation; ``calls``: the start of the
    runtime call of each correlation id. Times in nanoseconds."""
    out = []
    for a, b in sorted(views):
        ops = sorted(op for op in device if a <= calls.get(op[3], -1) <= b)
        k1 = [op for op in ops if K1 in op[2]]
        rec = {"launches": sum(not op[2].startswith(NOT_LAUNCHES) for op in ops),
               "k1": len(k1), "lead_ms": None, "tail_ms": None, "k1_ms": None,
               "lead_host_ms": None, "k1_after_call_ms": None,
               "first_op_after_span": bool(ops) and ops[0][0] > a}
        if k1:
            k1_end = max(op[1] for op in k1)
            rec.update(lead_ms=(k1[0][0] - a) * 1e-6,
                       tail_ms=(max(op[1] for op in ops) - k1_end) * 1e-6,
                       k1_ms=(k1_end - k1[0][0]) * 1e-6,
                       lead_host_ms=(calls[k1[0][3]] - a) * 1e-6,
                       k1_after_call_ms=min(op[0] - calls[op[3]] for op in k1) * 1e-6)
        out.append(rec)
    return out


def profiler_events(prof) -> tuple:
    """The view spans, the device operations and the runtime calls that
    launched them, from a stopped ``torch.profiler.profile``, for
    :func:`reduce_views`."""
    from torch.autograd import DeviceType

    views, device, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            # the benchmark's spans mirrored on the device's timeline: no
            # operation, and their ids are not the runtime's correlation ids
            if not e.name().startswith("portbench."):
                device.append(item)
        elif e.name() == VIEW:
            views.append(item[:2])
        elif e.name().startswith("cu"):
            host.append(item)
    launched = {op[3] for op in device}
    calls = {c[3]: c[0] for c in host if c[3] in launched}
    return views, device, calls


def traced_views(cfg: dict, traffic: dict, seed: int, device) -> list:
    """The per-view records of a traced window of the render cell's views."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import tracing
    from portbench.mixes import render

    su = render.setup(cfg, traffic, seed, device)
    order, n_all = su["order"], len(su["views"])
    render.render_one(su, int(order[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(traffic["trace_views"]):
            with tracing.span("portbench.view"):
                render.render_one(su, int(order[i % n_all]))
        torch.cuda.synchronize()
    return reduce_views(*profiler_events(prof))


def run_seed():
    """The ``--seed`` of the run's command line, or None."""
    argv = sys.argv
    return int(argv[argv.index("--seed") + 1]) if "--seed" in argv[:-1] else None


def per_view(ctx: dict):
    """The view records of a traced render cell, from a window traced once
    for the readers of one run; None where no card or seed is there to
    trace one."""
    if "view_spans" not in ctx:
        import torch

        seed = run_seed()
        ctx["view_spans"] = None
        if ctx.get("kind") == "render" and seed is not None and torch.cuda.is_available():
            ctx["view_spans"] = traced_views(ctx["config"], ctx["traffic"], seed,
                                             torch.device("cuda"))
    return ctx["view_spans"]


def median(ctx: dict, key: str):
    """The median of ``key`` over the traced views that have it, or None."""
    values = [v[key] for v in per_view(ctx) or [] if v[key] is not None]
    return statistics.median(values) if values else None
