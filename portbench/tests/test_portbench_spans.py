"""The per-view readers of the program's spans (``portbench/spans.py``,
``metrics/view_*.py``) on hand-made event lists, and the trace's reduction
with the program's spans among the host events."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import harness, spans, tracing

# two views; times in ns. Each device op: (start, end, name, correlation);
# CALLS: the start of the runtime call of each correlation.
VIEWS = [(0, 10_000), (20_000, 30_000)]
DEVICE = [
    (150, 160, "Memcpy HtoD (Pageable -> Device)", 1),
    (250, 300, "vectorized_elementwise_kernel", 2),
    (1_000, 3_000, "void fwd_kernel<2, 32, 2, false, false>", 3),
    (3_000, 5_000, "void fwd_kernel<2, 32, 2, false, false>", 4),
    (5_100, 5_200, "CatArrayBatchedCopy", 5),
    (5_300, 6_000, "reduce_kernel<512, 1>", 6),
    (10_600, 10_700, "CatArrayBatchedCopy", 7),  # launched after the span: not the view's
    (10_800, 11_000, "Memcpy DtoH (Device -> Pinned)", 8),
    (22_000, 25_000, "void fwd_kernel<2, 32, 2, false, false>", 13),
    (25_500, 26_000, "vectorized_elementwise_kernel", 14),
    (26_100, 27_000, "Memset (Device)", 15),
    (27_100, 28_000, "elementwise_kernel", 16),
    (28_100, 28_500, "elementwise_kernel", 17),
]
CALLS = {1: 100, 2: 200, 3: 300, 4: 400, 5: 500, 6: 600, 7: 10_500, 8: 10_550,
         13: 20_100, 14: 20_200, 15: 20_300, 16: 20_400, 17: 20_500}


def ctx():
    return {"view_spans": spans.reduce_views(VIEWS, DEVICE, CALLS)}


def test_view_records_by_hand():
    a, b = spans.reduce_views(VIEWS, DEVICE, CALLS)
    assert a["lead_ms"] == pytest.approx(1e-3) and a["tail_ms"] == pytest.approx(1e-3)
    assert a["launches"] == 5 and a["k1"] == 2
    assert b["lead_ms"] == pytest.approx(2e-3) and b["tail_ms"] == pytest.approx(3.5e-3)
    assert b["launches"] == 4 and b["k1"] == 1
    assert a["k1_ms"] == pytest.approx(4e-3) and b["k1_ms"] == pytest.approx(3e-3)
    assert a["lead_host_ms"] == pytest.approx(3e-4) and b["lead_host_ms"] == pytest.approx(1e-4)
    assert a["k1_after_call_ms"] == pytest.approx(7e-4)
    assert b["k1_after_call_ms"] == pytest.approx(1.9e-3)
    assert a["first_op_after_span"] and b["first_op_after_span"]


def test_the_three_readers_give_the_medians_of_two_views():
    assert harness.read_metric("view_lead_ms.render", ctx()) == pytest.approx(1.5e-3)
    assert harness.read_metric("view_tail_ms.render", ctx()) == pytest.approx(2.25e-3)
    assert harness.read_metric("view_launches.render", ctx()) == pytest.approx(4.5)


class Event:
    """A kineto event as ``profiler_events`` reads one."""

    def __init__(self, start, end, name, corr, device):
        self.args = start, end, name, corr, device

    def start_ns(self):
        return self.args[0]

    def end_ns(self):
        return self.args[1]

    def name(self):
        return self.args[2]

    def correlation_id(self):
        return self.args[3]

    def device_type(self):
        return self.args[4]


def test_profiler_events_keep_views_launches_and_device_ops_alone():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Event(a, b, spans.VIEW, 900 + i, cpu) for i, (a, b) in enumerate(VIEWS)]
    events += [Event(s, e, n, c, cuda) for s, e, n, c in DEVICE]
    events += [Event(t, t + 50, "cudaLaunchKernel", c, cpu) for c, t in CALLS.items()]
    events += [Event(90, 95, "aten::mul", 3, cpu),  # a host op's id, not a runtime's
               # the benchmark's span mirrored on the device, its id another numbering's
               Event(1_000, 29_000, "portbench.view", 4, cuda)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    views, device, calls = spans.profiler_events(prof)
    assert views == VIEWS and sorted(device) == sorted(DEVICE) and calls == CALLS
    assert spans.reduce_views(views, device, calls) == spans.reduce_views(VIEWS, DEVICE, CALLS)


def test_a_kernel_that_starts_before_its_call_fails_the_clock_check():
    late = {**CALLS, 3: 1_500}
    a, _ = spans.reduce_views(VIEWS, DEVICE, late)
    assert a["k1_after_call_ms"] == pytest.approx(-5e-4)


def test_no_view_span_reads_nothing():
    empty = {"view_spans": spans.reduce_views([], DEVICE, CALLS)}
    for name in ("view_lead_ms.render", "view_tail_ms.render", "view_launches.render"):
        assert harness.read_metric(name, empty) is None
    # no card or seed to trace a window with
    assert harness.read_metric("view_lead_ms.render", {"kind": "render"}) is None


def test_program_spans_leave_the_trace_reduction_as_it_was():
    device = [(s / 1e3, e / 1e3, name) for s, e, name, _ in DEVICE]
    host = [(0.0, 11.0, "portbench.view"), (0.05, 0.2, "aten::copy_"),
            (0.2, 0.25, "aten::mul"), (20.0, 30.0, "portbench.view")]
    program = [(0.0, 10.0, "nerfca.eval.view"), (0.01, 0.45, "nerfca.eval.tile"),
               (0.45, 0.7, "nerfca.eval.composite"), (20.0, 30.0, "nerfca.eval.view")]
    win = (0.0, 31.0)
    before = tracing.reduce_trace(list(device), list(host), win, 31e-6)
    after = tracing.reduce_trace(list(device), host + program, win, 31e-6)
    for key in ("window_s", "busy_s", "n_kernels", "kernels", "device_ops"):
        assert before[key] == after[key], key
    ctx_b, ctx_a = ({"trace": t} for t in (before, after))
    assert (harness.read_metric("device_idle.render", ctx_b)
            == harness.read_metric("device_idle.render", ctx_a))
    # the view's idle time now carries the program's labels
    assert "nerfca.eval.view" in dict(after["idle_gaps"])
    assert "nerfca.eval.view" not in dict(before["idle_gaps"])
