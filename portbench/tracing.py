"""The device trace of a window: ``torch.profiler`` over the cell's own
calls, reduced to the device's busy time (the union of its operations'
intervals), the time and count of each kernel, and the idle gaps labelled
by what the host was doing (the innermost host span or operation that
covers each gap's middle). The benchmark's spans are
``torch.profiler.record_function`` scopes around its calls into the
program."""

from __future__ import annotations

import bisect
import time
from contextlib import contextmanager

import torch


@contextmanager
def span(name: str):
    """A host span of the benchmark's own, seen in the trace."""
    with torch.profiler.record_function(name):
        yield


def traced(fn) -> dict:
    """Run ``fn()`` under the profiler, synchronised at both ends; the
    window's wall time and the trace's reduction."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("portbench.window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    device, host, win = [], [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith("portbench.") and e.device_type == DeviceType.CUDA:
            continue  # the benchmark's spans, mirrored on the device's timeline
        if e.device_type == DeviceType.CUDA:
            device.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
            if e.name == "portbench.window":
                win = (start, end)
    return reduce_trace(device, host, win, window_s)


def reduce_trace(device: list, host: list, win, window_s: float) -> dict:
    """Busy seconds, kernels by name, and idle gaps by host activity, from
    device and host intervals in microseconds."""
    device.sort()
    kernels: dict = {}
    n_kernels = 0
    for start, end, name in device:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (end - start) * 1e-6
        k[1] += 1
        if not name.startswith(("Memcpy", "Memset")):
            n_kernels += 1
    merged = []
    for start, end, _ in device:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    lo, hi = win if win else (merged[0][0] if merged else 0.0, merged[-1][1] if merged else 0.0)
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    host = sorted(h for h in host if h[2] != "portbench.window")
    starts = [h[0] for h in host]
    idle: dict = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        for h in host[max(0, i - 400):i]:
            if h[1] >= mid and (best is None or h[1] - h[0] < best[1] - best[0]):
                best = h
        name = best[2] if best else "outside any host span"
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return {"window_s": window_s, "busy_s": busy_s, "n_kernels": n_kernels,
            "kernels": {k: (v[0], v[1]) for k, v in kernels.items()},
            "device_ops": sorted(([k, v[0]] for k, v in kernels.items()),
                                 key=lambda r: -r[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda r: -r[1])[:10]}


def kernel_seconds(trace: dict, *parts: str) -> float:
    """Device seconds of the kernels whose names contain any of ``parts``."""
    return sum(v[0] for k, v in trace["kernels"].items() if any(p in k for p in parts))
