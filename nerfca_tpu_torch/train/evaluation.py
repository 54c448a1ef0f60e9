"""Full-image test rendering and evaluation metrics (port of
``nerfca_tpu/train/evaluation.py``).

The W*H rays of a view are rendered in tiles of 4096 rays (2,048,000 points
per field-kernel launch at 500 samples), then the composite and the
decomposed static-only / dynamic-only intensity maps are formed, plus the
reference's test losses and pure image PSNR / SSIM. With the fine pass the
fine pair is rendered the same way on its own fixed depth grid. The static
method's view (:func:`render_static_test_view`) is the single-field render
of the static field through the same renderer and tiles.

On the card, with both fields of a pair on K1, each tile's composite is
one launch of the Beer-Lambert kernel right after the tile's K1
(``ops/cuda/fused_train.py::eval_composite``), into buffers allocated once
for the view; the static method's field takes the one-field K1
(``ops/cuda/fused_field.py::StaticFieldRays``) and the kernel's one-field
sibling (``eval_static``) the same way. Everywhere else the tiles are
joined and rendered by ``ops/render.py``. Both give the same sigmas and
dists bit for bit and the same images up to the order of each per-ray sum.

On the card, with every pair on the kernel path, a view's launches are one
CUDA graph (:class:`ViewGraphs`), captured at the first view of a key and
replayed for each later view with the same key: the device no longer waits
through the host's packing, checks and launches at the head of a view.
"""

from __future__ import annotations

import collections
import weakref
from typing import Optional

import numpy as np
import torch

from nerfca_tpu_torch.ops.hull import hull_gate_rays
from nerfca_tpu_torch.ops.losses import weighted_mse
from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite
from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.ops.cuda.fused_field import (
    StaticFieldRays, kernel_supported, plain_static_field_rays,
)
from nerfca_tpu_torch.train.step import (
    CompositeHParams, StaticHParams, evaluate_fields, field_window, field_windows,
    loss_weights, regularized_loss, regularizer_losses,
)
from nerfca_tpu_torch.utils.profiling import span

# the route counters a replay adds its captured launches to
_COUNTERS = (ff.LAUNCHES, ft.LAUNCHES)


def _fields(cfgs: dict, suffix: str) -> tuple:
    """The fields of the pair ``suffix`` names: the static and the temporal
    one, or, for the static method, the static field alone."""
    return ("static", "temp") if "temp" + suffix in cfgs else ("static",)


def view_windows(cfgs: dict, step: int, device=None) -> dict:
    """The windows of a view's fields at ``step``: both fields'
    (:func:`field_windows`), or the static method's field's alone."""
    if "temp" in cfgs:
        return field_windows(cfgs, step, device)
    return {"static": field_window(cfgs["static"], step, device)}


def _tile_fields(params, windows, cfgs, hp, z, tile: int, suffix: str, on_kernel: bool):
    """A tile's raw densities ``[r, S]``, one for each field of the pair
    ``suffix`` names, from its rays and phases: both fields through
    :func:`evaluate_fields` (``windows``: :func:`view_windows`); the static
    method's field through the one-field K1 on the card (``on_kernel``:
    packed with its window once for the view's tiles), else the plain field
    under ``hp.dtype``, as the JAX package renders it."""
    if "temp" + suffix in cfgs:
        def both(o, d, ph):
            s_raw, t_raw = evaluate_fields(params, o, d, z, ph, windows, cfgs, hp, suffix)
            return s_raw[..., 0], t_raw[..., 0]
        return both
    p, cfg, window = params["static" + suffix], cfgs["static" + suffix], windows["static"]
    if on_kernel:
        k1 = StaticFieldRays(p, cfg, window, hp.compute_dtype, tile)
        return lambda o, d, ph: (k1(o, d, z),)
    return lambda o, d, ph: (plain_static_field_rays(p, o, d, z, cfg, window, hp.dtype)[..., 0],)


def _tiles(params, origins, directions, phases, depth_values, windows, cfgs, hp, tile: int,
           hull, suffix: str, on_kernel: bool):
    """The pair ``suffix`` names on every ray, ``tile`` rays at a time: per
    tile its first ray, the raw densities ``[tile, S]`` of each field
    (:func:`_tile_fields`) and the hull gate (None without a hull)."""
    fields = _tile_fields(params, windows, cfgs, hp, depth_values, tile, suffix, on_kernel)
    for start in range(0, origins.shape[0], tile):
        with span("nerfca.eval.tile"):
            rows = slice(start, start + tile)
            o, d = origins[rows], directions[rows]
            raws = fields(o, d, None if phases is None else phases[rows])
            gate = hull_gate_rays(hull, o, d, depth_values) if hull is not None else None
        yield start, raws, gate


def composite_on_kernel(origins, cfgs: dict, hp, suffix: str = "") -> bool:
    """Whether the pair ``suffix`` names takes the eval's Beer-Lambert kernel
    (the static method's field alone: its one-field sibling): CUDA tensors
    with every field of the pair on K1 (:func:`evaluate_fields`'s
    condition)."""
    return (origins.device.type == "cuda" and hp.use_pallas
            and all(kernel_supported(cfgs[f + suffix]) for f in _fields(cfgs, suffix)))


def _render_pair(params, origins, directions, phases, depth_values, windows, cfgs, hp,
                 tile: int, hull, i0: float, suffix: str, images: bool,
                 on_kernel: bool) -> dict:
    """The pair's composite and, with ``images``, its static and dynamic
    images; the static method's pair (one field): its image ``pix_static``,
    UNSCALED sigma and dists. ``on_kernel``: each tile's Beer-Lambert
    kernel right after its K1, into buffers for the view; else the tiles
    joined, then the renders of ``ops/render.py`` over the whole view."""
    one = len(_fields(cfgs, suffix)) == 1
    tiles = _tiles(params, origins, directions, phases, depth_values, windows, cfgs, hp, tile,
                   hull, suffix, on_kernel)
    act = hp.output_activation
    if on_kernel and one:
        out = None
        for start, (raw,), _ in tiles:
            with span("nerfca.eval.composite"):
                if out is None:  # made once tile 0's K1 is queued
                    out = ft.eval_static_buffers(origins.shape[0], depth_values)
                ft.eval_static(raw, depth_values, i0, act, out, start)
        return out
    if on_kernel:
        out = ft.eval_composite_buffers(origins.shape[0], depth_values, images)
        for start, (s_raw, t_raw), gate in tiles:
            with span("nerfca.eval.composite"):
                ft.eval_composite(s_raw, t_raw, depth_values, i0, act, out, start, gate)
        return out
    parts = list(tiles)
    with span("nerfca.eval.composite"):
        raws = [torch.cat([p[1][k] for p in parts])[..., None] for k in range(len(parts[0][1]))]
        gate = torch.cat([p[2] for p in parts]) if hull is not None else None
        del parts  # the tiles, released before the renders as the joins replace them
        i0_rays = torch.full((raws[0].shape[0],), i0, device=origins.device)
        if one:
            pix, sigma, dists = render_transmission(raws[0], i0_rays, depth_values, act)
            return {"pix_static": pix, "static_sigma": sigma, "dists": dists}
        s_raw, t_raw = raws
        pix, s_sig, t_sig, dists = render_transmission_composite(
            s_raw, t_raw, i0_rays, depth_values, act, temp_gate=gate)
        out = {"pix": pix}
        if images:
            out["pix_static"] = render_transmission(s_raw, i0_rays, depth_values, act)[0]
            out["pix_temp"] = render_transmission(t_raw, i0_rays, depth_values, act,
                                                  gate=gate)[0]
    out.update(static_sigma=s_sig, temp_sigma=t_sig, dists=dists)
    return out


def _render_view(params, origins, directions, phases, pairs, windows, cfgs, hp, tile: int,
                 hull, i0: float) -> dict:
    """Every pair of ``pairs`` (``(suffix, depths)``) on the view's rays,
    launched as it goes: the coarse pair's outputs, and the fine pair's
    under ``_fine``."""
    out = {}
    for suffix, z in pairs:
        got = _render_pair(params, origins, directions, phases, z, windows, cfgs, hp, tile,
                           hull, i0, suffix, images=not suffix,
                           on_kernel=composite_on_kernel(origins, cfgs, hp, suffix))
        out.update({k + suffix: v for k, v in got.items()})
    return out


def _tensors(tree) -> list:
    """Every tensor in a nest of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class _ViewGraph:
    """One view's launches, captured: the buffers its rays and windows are
    copied into before a replay (``rays``, ``windows``; a window shared by
    both fields is one buffer, so K1 keeps its shared units), the step
    whose windows those buffers hold, the buffers its launches write
    (``out``), and what its launches added to the route counters
    (``launches``). ``graph`` None: the view could not be captured, and
    each view of its key runs eagerly."""

    def __init__(self, graph, rays: dict, windows: dict, step: int, out: Optional[dict],
                 launches: list):
        self.graph, self.rays, self.step, self.out = graph, rays, step, out
        self.launches = launches
        self.windows = {}  # each buffer once, under the first field that reads it
        for k, buf in windows.items():
            if buf is not None and all(b is not buf for b in self.windows.values()):
                self.windows[k] = buf
        self.refs: list = []

    def replay(self, rays: dict, step: int, windows_at) -> dict:
        """The view of ``rays`` at ``step``: the rays copied in, the windows
        too where the step is another than the last replay's
        (``windows_at()`` makes them), replayed, and the outputs handed
        out as copies, so a tensor returned for one view never changes
        under its caller when a later view replays."""
        for k, buf in self.rays.items():
            buf.copy_(rays[k])
        if step != self.step:
            windows = windows_at()
            for k, buf in self.windows.items():
                buf.copy_(windows[k])
            self.step = step
        self.graph.replay()
        for counts, added in zip(_COUNTERS, self.launches):
            for k, v in added.items():
                counts[k] += v
        return {k: v.clone() for k, v in self.out.items()}


class ViewGraphs:
    """The eval renderer's captured views, at most ``capacity`` of them,
    the least recently used dropped first. A view's key holds every value
    a launch bakes in: the address and layout of each tensor the view's
    launches read (the weights, the depths, the hull), the rays' layout
    (their values are copied into the graph's buffers before each replay),
    and the caller's part (in ``render_test_view``: the tile, the configs,
    the hyperparameters and the initial intensity). The fields' windows
    are a function of the step under the key's configs, which also fix
    their layout and whether the two fields share one; their values are
    copied into the graph's buffers when the step changes. A graph reads
    the weights at their addresses, so an in-place update of them (Adam's)
    shows in the next replay; an entry holds its tensors by weak reference
    and goes when any of them dies, so it keeps no freed weights alive and
    never replays a freed address. Counted in ``fused_train.LAUNCHES``:
    ``eval_view.capture``, ``eval_view.replay`` and ``eval_view.eager`` (a
    view of a key that could not be captured, or off the kernel path)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def render(self, read: list, rays: dict, step: int, windows_at, key: tuple, run) -> dict:
        """The view ``run(rays, windows_at())`` renders eagerly at
        ``step``, replayed where its key was captured. The first view of a
        key runs eagerly (its warm-up: every lazy set-up of the launches,
        such as a kernel's attributes or a cached window, happens outside
        the capture), then is captured for the views after it."""
        key = (key, tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device) for t in read),
               tuple((k, t.shape, t.dtype) for k, t in rays.items()))
        entry = self.entries.get(key)
        if entry is None:
            windows = windows_at()
            out = run(rays, windows)
            entry = self._capture(key, read, rays, windows, step, run)
            ft.LAUNCHES["eval_view.capture" if entry.graph is not None else "eval_view.eager"] += 1
            return out
        self.entries.move_to_end(key)
        if entry.graph is None:
            ft.LAUNCHES["eval_view.eager"] += 1
            return run(rays, windows_at())
        ft.LAUNCHES["eval_view.replay"] += 1
        return entry.replay(rays, step, windows_at)

    def _capture(self, key: tuple, read: list, rays: dict, windows: dict, step: int,
                 run) -> _ViewGraph:
        """The view's launches captured into a new entry under ``key``; an
        entry without a graph where the capture fails (a launch that
        waits for the host, say). The route counters are left as they
        were: the capture ran nothing."""
        dev = rays["origins"].device
        ray_bufs = {k: torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
                    for k, t in rays.items()}
        win_bufs: dict = {}
        for k, w in windows.items():
            same = [j for j in win_bufs if windows[j] is w]
            win_bufs[k] = None if w is None else win_bufs[same[0]] if same else w.clone()
        before = [dict(c) for c in _COUNTERS]
        with span("nerfca.eval.capture"):
            graph, out = self._record(run, ray_bufs, win_bufs, dev)
        launches = [{k: c[k] - b[k] for k in c if c[k] != b[k]} for c, b in zip(_COUNTERS,
                                                                                  before)]
        for c, b in zip(_COUNTERS, before):
            c.update(b)
        entry = _ViewGraph(graph, ray_bufs, win_bufs, step, out, launches)

        def drop(_, key=key):
            self.entries.pop(key, None)

        entry.refs = [weakref.ref(t, drop) for t in read]
        self.entries[key] = entry
        while len(self.entries) > self.capacity:
            self.entries.popitem(last=False)
        return entry

    @staticmethod
    def _record(run, rays: dict, windows: dict, dev) -> tuple:
        """``run(rays, windows)`` captured on a side stream of ``dev``: the
        graph and the buffers its launches write, or (None, None) where
        the capture fails. Only this thread's calls are held to the
        capture's rules (``thread_local``)."""
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = run(rays, windows)
                finally:
                    graph.capture_end()
        except RuntimeError:
            graph, out = None, None
        torch.cuda.current_stream(dev).wait_stream(stream)
        return graph, out


# one entry for each method and pair serves every caller: the trainers'
# in-loop evals, run_eval and run_render render one key view after view
VIEW_GRAPHS = ViewGraphs(capacity=4)


@torch.no_grad()
def render_test_view(params, test_origins, test_directions, test_phases, depth_values,
                     step: int, cfgs: dict, hp, initial_intensity: float,
                     tile: int = 4096, depth_values_fine=None, hull=None) -> dict:
    """Render one full test view; per-pixel composite and decomposed
    intensity maps plus the scaled sigmas and dists, the fields under
    ``hp.compute_dtype`` (``nerfca_tpu/train/evaluation.py:80``). ``hull``:
    optional ``MotionHull`` gating the dynamic density exactly as in
    training.

    With ``depth_values_fine`` and fine params, the fine pair is rendered
    directly on that fixed grid, as the reference's eval does (not a
    resampled hierarchical pass): ``pix_fine`` and the fine sigmas and
    dists. Each pair's composite takes the Beer-Lambert kernel where
    :func:`composite_on_kernel` holds; a view whose composite ran in torch
    counts one ``fused_train.LAUNCHES["eval_composite.torch"]``. Where it
    holds for every pair, the view's launches are a CUDA graph
    (:data:`VIEW_GRAPHS`), bitwise the eager view's; the tensors returned
    are the caller's to keep.

    The static method's view: ``cfgs`` ``{"static": cfg}`` with its
    ``StaticHParams``, no phases (``test_phases`` None) and no hull; it
    returns ``pix_static``, the single-field render of the static field,
    with its UNSCALED sigma ``static_sigma`` and the ``dists``
    (:func:`render_static_test_view`)."""
    if hull is not None and "temp" not in cfgs:
        raise ValueError("the motion hull gates the temporal field; the static method has none")
    with span("nerfca.eval.view"):
        pairs = [("", depth_values)]
        if depth_values_fine is not None and "static_fine" in params:
            pairs.append(("_fine", depth_values_fine))
        rays = {k: t for k, t in (("origins", test_origins), ("directions", test_directions),
                                  ("phases", test_phases)) if t is not None}

        def run(r: dict, w: dict) -> dict:
            return _render_view(params, r["origins"], r["directions"], r.get("phases"), pairs,
                                w, cfgs, hp, tile, hull, initial_intensity)

        def windows_at():
            return view_windows(cfgs, step, test_origins.device)

        if all(composite_on_kernel(test_origins, cfgs, hp, suffix) for suffix, _ in pairs):
            fields = [params[f + suffix] for suffix, _ in pairs for f in _fields(cfgs, suffix)]
            read = _tensors(fields) + [z for _, z in pairs] + _tensors(hull)
            key = (tile, float(initial_intensity), hp, tuple(sorted(cfgs.items())))
            return VIEW_GRAPHS.render(read, rays, step, windows_at, key, run)
        ft.LAUNCHES["eval_composite.torch"] += 1
        ft.LAUNCHES["eval_view.eager"] += 1
        return run(rays, windows_at())


def render_static_test_view(params, test_origins, test_directions, depth_values, step: int,
                            cfg, hp: StaticHParams, initial_intensity: float,
                            tile: int = 4096) -> dict:
    """One full test view of the static method
    (``nerfca_tpu/train/evaluation.py:227-275``): ``pix_static``, the
    single-field render of the static field, with its UNSCALED sigma and
    the dists. The JAX package renders it through its composite renderer
    beside a zero temporal field, on the plain path (its hyperparameters
    there leave ``use_pallas`` off), and scores ``pix_static``, which that
    field does not enter; this renders the static field alone through the
    same renderer, :func:`render_test_view`: on the card with
    ``use_pallas`` through the one-field K1 and its Beer-Lambert kernel,
    elsewhere plain under ``hp.compute_dtype``
    (``nerfca_tpu/train/evaluation.py:261``)."""
    return render_test_view(params, test_origins, test_directions, None, depth_values, step,
                            {"static": cfg}, hp, initial_intensity, tile=tile)


def test_metrics(render: dict, test_img_flat: torch.Tensor, step: int, hp: CompositeHParams,
                 img_shape: Optional[tuple] = None) -> dict:
    """Test losses + PSNR as the reference logs them, plus image PSNR/SSIM."""
    weights = loss_weights(step, hp)
    ones = torch.ones_like(test_img_flat)
    pixel_loss = torch.mean(weighted_mse(render["pix"], test_img_flat, ones))
    losses = regularizer_losses(render["static_sigma"], render["temp_sigma"], render["dists"],
                                ones, hp)
    test_loss = regularized_loss(pixel_loss, losses, weights)
    pixel_loss_fine = None
    if "pix_fine" in render:
        # the fine terms add to test_loss, and the logged regularizers are
        # the fine pass's (run_composite.py:380-389)
        pixel_loss_fine = torch.mean(weighted_mse(render["pix_fine"], test_img_flat, ones))
        losses = regularizer_losses(render["static_sigma_fine"], render["temp_sigma_fine"],
                                    render["dists_fine"], ones, hp)
        test_loss = test_loss + regularized_loss(pixel_loss_fine, losses, weights)
    test_loss = float(test_loss)
    pred = render["pix"].double().cpu().numpy()
    gt = test_img_flat.double().cpu().numpy()
    out = {
        "test_loss": test_loss,
        "test_psnr": float(-10.0 * np.log10(test_loss)),
        "test_pixel_loss_coarse": float(pixel_loss),
        "test_favor_s_loss": float(losses.favor_s_loss),
        "test_blendw": float(losses.blendw_mean),
        "test_s_entropy_loss": float(losses.static_entropy_loss),
        "test_d_entropy_loss": float(losses.dynamic_entropy_loss),
        "test_image_psnr": image_psnr(pred, gt),
    }
    if pixel_loss_fine is not None:
        out["test_pixel_loss_fine"] = float(pixel_loss_fine)
        out["test_image_psnr_fine"] = image_psnr(render["pix_fine"].double().cpu().numpy(), gt)
    if img_shape is not None:
        lo, hi = float(gt.min()), float(gt.max())
        scale = (hi - lo) or 1.0
        out["test_image_ssim"] = image_ssim((pred.reshape(img_shape) - lo) / scale,
                                            (gt.reshape(img_shape) - lo) / scale)
    return out


def normalize01(img: np.ndarray) -> np.ndarray:
    lo, hi = float(img.min()), float(img.max())
    if hi == lo:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def pearson_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation of two images (flattened); 0 when degenerate."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def image_psnr(pred: np.ndarray, gt: np.ndarray) -> float:
    """Data-range PSNR ``10 log10(range(gt)^2 / MSE)`` on the raw values."""
    mse = float(np.mean((np.asarray(pred) - np.asarray(gt)) ** 2))
    if mse == 0:
        return float("inf")
    data_range = float(np.max(gt) - np.min(gt))
    if data_range == 0:
        return float("-inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def image_ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Gaussian-windowed SSIM on 2-D images (standard constants)."""
    from scipy.ndimage import gaussian_filter

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    sigma = 1.5
    mu_a = gaussian_filter(a, sigma)
    mu_b = gaussian_filter(b, sigma)
    va = gaussian_filter(a * a, sigma) - mu_a**2
    vb = gaussian_filter(b * b, sigma) - mu_b**2
    cov = gaussian_filter(a * b, sigma) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    return float(np.mean(num / den))


def masked_region_psnr(pred: np.ndarray, gt: np.ndarray, rel_thresh: float = 0.05,
                       dilate: int = 2) -> float:
    """PSNR restricted to the ground truth's support (pixels with
    ``gt > rel_thresh * max(gt)``, dilated by ``dilate`` pixels).

    Whole-frame ``dyn_psnr`` rewards a near-empty dynamic render, because
    the artery ground truth is mostly zero; scoring only where the vessel
    projects makes an empty render score the full ground-truth range
    against ~zero. The data range stays the full ground-truth range, so the
    score compares with :func:`image_psnr`. Plain PSNR when the mask would
    be empty."""
    gt = np.asarray(gt, np.float64)
    pred = np.asarray(pred, np.float64)
    top = float(gt.max())
    mask = gt > rel_thresh * top
    if top <= 0 or not mask.any():
        return image_psnr(pred, gt)
    if dilate > 0:
        from scipy.ndimage import binary_dilation

        mask = binary_dilation(mask, iterations=dilate)
    mse = float(np.mean((pred[mask] - gt[mask]) ** 2))
    data_range = float(gt.max() - gt.min())
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))
