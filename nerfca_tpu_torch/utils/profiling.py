"""Profiling and tracing hooks (port of ``nerfca_tpu/utils/profiling.py``).

The reference's only instrumentation is a per-iteration ``time.time()``
logged as ``train_time`` (``run_composite.py:231,336``). Here:

  - ``StepTimer``: per-chunk wall-clock with steps/sec and rays/sec;
  - ``trace()``: a ``torch.profiler`` context over the CPU and, with a
    card, CUDA activity, writing a trace that TensorBoard's profiler
    plugin and ``chrome://tracing`` read (the trainer's ``--profile_steps``
    window uses it);
  - ``device_memory_stats()``: live device memory per CUDA device;
  - ``span()``: a named host span of the port's own, seen by any running
    ``torch.profiler`` (the trainer's ``trace()`` window, a benchmark's
    trace) on the clock it gives the card's kernels, and free otherwise.

JAX's ``enable_compilation_cache`` has no counterpart: it configures XLA's
compilation cache, and the port compiles its kernels once into
``build/kernels/`` (``ops/cuda/build.py``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
import types
from typing import Optional

import torch


class StepTimer:
    """Accumulates wall-clock per train chunk; reports derived rates."""

    def __init__(self, rays_per_step: int = 0):
        self.rays_per_step = rays_per_step
        self.reset()

    def reset(self) -> None:
        self.total_steps = 0
        self.total_time = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int) -> dict:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_steps += n_steps
        self.total_time += dt
        out = {
            "chunk_time_s": dt,
            "steps_per_sec": n_steps / dt if dt > 0 else 0.0,
        }
        if self.rays_per_step:
            out["rays_per_sec"] = out["steps_per_sec"] * self.rays_per_step
        return out

    def summary(self) -> dict:
        sps = self.total_steps / self.total_time if self.total_time else 0.0
        return {
            "total_steps": self.total_steps,
            "total_time_s": self.total_time,
            "steps_per_sec": sps,
            "rays_per_sec": sps * self.rays_per_step,
        }


@contextlib.contextmanager
def trace(log_dir: str, name: Optional[str] = None):
    """``with trace('dir') as t: ...`` profiles the block with
    ``torch.profiler`` (CPU activity, and CUDA activity when a card is
    present) and on exit writes the trace as ``<log_dir>/<t.name>``, a
    Chrome trace JSON. The default name, ``<host>_<pid>.<ms>.pt.trace.json``,
    is the one TensorBoard's profiler plugin looks for; ``t.name`` may be
    set inside the block (the trainer names its window by its steps).
    ``t.profiler`` is the running ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handle = types.SimpleNamespace(
        name=name or f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}"
                     f".pt.trace.json",
        profiler=profile(activities=activities))
    handle.profiler.start()
    try:
        yield handle
    finally:
        handle.profiler.stop()
        os.makedirs(log_dir, exist_ok=True)
        handle.profiler.export_chrome_trace(os.path.join(log_dir, handle.name))


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span('nerfca.<part>'): ...`` marks the block as a host span
    in a running ``torch.profiler`` trace; with no profiler running it is
    one check of the profiler's state and nothing else. The span is an
    operator-scope record (as a ``torch.autograd.Function``'s is), so it
    nests the aten ops and kernel launches under it and, unlike a
    ``record_function`` scope, adds no copy of itself to the device's
    timeline: the device's busy time and kernel list stay the kernels'.
    Every name starts with ``nerfca.``."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


def device_memory_stats(device: Optional[str] = None) -> list[dict]:
    """Per-device live memory statistics: one dict per CUDA device
    (``device`` None or ``"cuda"``) with ``bytes_in_use`` and
    ``peak_bytes_in_use`` from the caching allocator
    (``torch.cuda.memory_stats``) and ``bytes_limit``, the card's total
    memory (``torch.cuda.mem_get_info``). ``"cpu"`` gives one entry with
    ``None`` values, as JAX's CPU device reports. Raises ``RuntimeError``
    for CUDA without a CUDA device: it does not report the CPU instead."""
    if device == "cpu":
        return [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                 "bytes_limit": None}]
    if device not in (None, "cuda"):
        raise ValueError(f"unknown device {device!r} (None, 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats: no CUDA device is available "
                           "(pass 'cpu' for the CPU's entry)")
    stats = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        })
    return stats
