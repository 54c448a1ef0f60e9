"""The eval renderer's captured views (``train/evaluation.py::ViewGraphs``)
off the card. A view on CPU tensors, or with ``use_pallas`` off, never
captures and counts as eager. The cache's rules, with the capture
replaced by a stand-in that records the view and reruns it into the same
output buffers at each replay, as a CUDA graph writes them: a key's first
view runs eagerly and captures, later views replay into copies that the
caller keeps, the windows' values are copied in at each replay, other
weights capture anew, an entry goes with its weights, at most
``capacity`` entries are kept, and a view that cannot be captured runs
eagerly. The graphs themselves are held against eager views on the card
(``tests/test_torch_gpu.py``)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import gc

import pytest
import torch

from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.train import evaluation, step as ts
from tests.test_torch_spans import field_cfgs, field_params, rays

N_RAYS, TILE, S, I0 = 10, 4, 8, 2.16
Z = torch.linspace(3.6, 5.4, S)
CFGS = field_cfgs()
HP = ts.CompositeHParams(depth_samples_coarse=S)
MADE: list = []  # the steps whose windows ``view`` made


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("fields", [1, 2])
def test_views_off_the_card_never_capture(fields, use_pallas):
    # CPU tensors (with use_pallas and 128-wide fields, the kernels' twin)
    # and the plain fields: every view eager, counted as such and as a
    # torch composite, nothing kept
    cfgs = {k: dataclasses.replace(c, num_filters=128) for k, c in field_cfgs().items()}
    if fields == 1:
        cfgs.pop("temp")
    params = field_params(cfgs)
    origins, dirs = rays(N_RAYS)
    phases = torch.arange(N_RAYS) % 10 if fields == 2 else None
    hp = (ts.CompositeHParams if fields == 2 else ts.StaticHParams)(depth_samples_coarse=S,
                                                                   use_pallas=use_pallas)
    kept = len(evaluation.VIEW_GRAPHS.entries)
    ft.reset_launch_counts()
    views = [evaluation.render_test_view(params, origins, dirs, phases, Z, 50, cfgs, hp, I0,
                                         tile=TILE) for _ in range(2)]
    assert ft.LAUNCHES["eval_view.eager"] == ft.LAUNCHES["eval_composite.torch"] == 2
    assert ft.LAUNCHES["eval_view.capture"] == ft.LAUNCHES["eval_view.replay"] == 0
    assert len(evaluation.VIEW_GRAPHS.entries) == kept
    assert all(torch.equal(views[0][k], views[1][k]) for k in views[0])


class Rerun:
    """Stands in for a captured graph: it renders the view once on the
    buffers it was recorded with, and each replay renders it again into
    the same output buffers."""

    def __init__(self, run, rays_in, windows):
        self.run, self.rays, self.windows = run, rays_in, windows
        self.out = run(rays_in, windows)

    def replay(self):
        counts = dict(ft.LAUNCHES)  # a graph's replay runs no Python that counts
        for k, v in self.run(self.rays, self.windows).items():
            self.out[k].copy_(v)
        ft.LAUNCHES.update(counts)


class StandIn(evaluation.ViewGraphs):
    """The cache with the stand-in for the capture; ``fail``: every
    capture fails, as one whose launches wait for the host. Without
    ``replays`` a capture keeps its outputs alone, as a graph does, and not
    the view's function, which holds the weights."""

    def __init__(self, capacity: int = 4, fail: bool = False, replays: bool = True):
        super().__init__(capacity)
        self.fail, self.replays, self.recorded = fail, replays, []

    def _record(self, run, rays_in, windows, dev):
        if self.fail:
            return None, None
        if not self.replays:
            return object(), run(rays_in, windows)
        graph = Rerun(run, rays_in, windows)
        self.recorded.append(graph)
        return graph, graph.out


def view(graphs, params, seed: int, step: int) -> dict:
    """One composite view of ``rays(N_RAYS, seed)`` through ``graphs``,
    assembled as ``render_test_view`` assembles it on the card; each
    render counts one ``eval_static.kernel``, a route counter that a
    replay must add its captured launches to."""
    origins, dirs = rays(N_RAYS, seed)
    phases = (torch.arange(N_RAYS) + seed) % 10

    def run(r, w):
        ft.LAUNCHES["eval_static.kernel"] += 1
        return evaluation._render_view(params, r["origins"], r["directions"], r["phases"],
                                       [("", Z)], w, CFGS, HP, TILE, None, I0)

    def windows_at():
        MADE.append(step)
        return evaluation.view_windows(CFGS, step)

    read = evaluation._tensors([params["static"], params["temp"]]) + [Z]
    rays_in = {"origins": origins, "directions": dirs, "phases": phases}
    return graphs.render(read, rays_in, step, windows_at, (TILE, I0, HP, CFGS["static"]), run)


def eager(params, seed: int, step: int) -> dict:
    origins, dirs = rays(N_RAYS, seed)
    phases = (torch.arange(N_RAYS) + seed) % 10
    return evaluation._render_view(params, origins, dirs, phases, [("", Z)],
                                   evaluation.view_windows(CFGS, step), CFGS, HP, TILE, None,
                                   I0)


VIEWS = ((0, 60), (1, 70), (2, 70), (3, 150))  # (seed of the rays, step)


def test_a_key_captures_once_then_replays_into_copies():
    # four views of new rays at three steps (the window annealing, then
    # open): one capture, three replays, each view its eager render bit
    # for bit; the windows made once a step; the route counter counts four
    # renders; the first view's tensors unchanged by the later replays
    graphs, params = StandIn(), field_params(CFGS)
    ft.reset_launch_counts()
    MADE.clear()
    got = [view(graphs, params, seed, step) for seed, step in VIEWS]
    kept = {k: v.clone() for k, v in got[0].items()}
    assert ft.LAUNCHES["eval_view.capture"] == 1 and ft.LAUNCHES["eval_view.replay"] == 3
    assert ft.LAUNCHES["eval_view.eager"] == 0 and ft.LAUNCHES["eval_static.kernel"] == 4
    assert MADE == [60, 70, 150]
    for out, (seed, step) in zip(got, VIEWS):
        want = eager(params, seed, step)
        assert set(out) == set(want) and all(torch.equal(out[k], want[k]) for k in want)
    assert all(torch.equal(got[0][k], kept[k]) for k in kept)
    (entry,) = graphs.entries.values()
    assert len(entry.windows) == 1  # the pair's one window, one buffer
    assert not any(got[3][k].data_ptr() == v.data_ptr() for k, v in entry.out.items())
    assert len(graphs.recorded) == 1


def test_an_in_place_update_keeps_the_key():
    graphs, params = StandIn(), field_params(CFGS)
    view(graphs, params, 0, 60)
    with torch.no_grad():
        params["static"]["out"]["b"].add_(0.5)
    ft.reset_launch_counts()
    out = view(graphs, params, 1, 60)
    assert ft.LAUNCHES["eval_view.replay"] == 1 and ft.LAUNCHES["eval_view.capture"] == 0
    want = eager(params, 1, 60)
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_other_weights_capture_anew_and_an_entry_goes_with_its_weights():
    graphs = StandIn(replays=False)
    first, second = field_params(CFGS), field_params(CFGS)
    view(graphs, first, 0, 60)
    (key_first,) = graphs.entries
    ft.reset_launch_counts()
    view(graphs, second, 0, 60)
    assert ft.LAUNCHES["eval_view.capture"] == 1 and ft.LAUNCHES["eval_view.replay"] == 0
    assert len(graphs.entries) == 2
    del first
    gc.collect()
    assert key_first not in graphs.entries and len(graphs.entries) == 1


def test_entries_are_bounded_least_recently_used_first():
    graphs = StandIn(capacity=2)
    weights = [field_params(CFGS) for _ in range(3)]
    view(graphs, weights[0], 0, 60)
    view(graphs, weights[1], 0, 60)
    keys = list(graphs.entries)
    view(graphs, weights[0], 1, 60)  # a replay: the first entry is now the newest
    view(graphs, weights[2], 0, 60)
    assert list(graphs.entries)[0] == keys[0] and keys[1] not in graphs.entries
    assert len(graphs.entries) == 2


def test_a_view_that_cannot_be_captured_runs_eagerly():
    graphs, params = StandIn(fail=True), field_params(CFGS)
    ft.reset_launch_counts()
    ff.reset_launch_counts()
    got = [view(graphs, params, seed, 60) for seed in range(3)]
    assert ft.LAUNCHES["eval_view.eager"] == 3 and ft.LAUNCHES["eval_static.kernel"] == 3
    assert ft.LAUNCHES["eval_view.capture"] == ft.LAUNCHES["eval_view.replay"] == 0
    assert len(graphs.entries) == 1  # remembered, so the capture is tried once
    for seed, out in enumerate(got):
        want = eager(params, seed, 60)
        assert all(torch.equal(out[k], want[k]) for k in want)
