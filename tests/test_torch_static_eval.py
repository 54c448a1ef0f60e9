"""The static method's test view through the eval's renderer on the CPU:
``render_test_view`` with the static field alone (``cfgs`` ``{"static":
cfg}``) against the benchmark's plain reference
(``portbench/reference/static_render.py``) and against the plain body
that rendered the view before it took the shared renderer; partial last
tiles; the two-field view's route untouched; the one-field kernels'
wrappers refusing what they would hand the card. The kernels themselves
are held against the same renders on the card (``tests/test_torch_gpu.py``)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses

import pytest
import torch

from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.ops.render import render_transmission
from nerfca_tpu_torch.train import evaluation, step as ts
from portbench import inputs
from portbench.mixes import program_fields
from portbench.reference import static_render as reference
from tests.test_torch_spans import field_cfgs, field_params, rays

N_RAYS, S, I0, DECAY = 50, 24, 2.16, 100
# the field as the benchmark describes it (portbench/mixes/__init__.py's
# config_fields), at a small width
FIELD = {"num_early_layers": 2, "num_filters": 32, "pos_enc": "free_windowed",
         "pos_enc_basis": 4, "encoded_features": 27, "pos_enc_window_start": 1,
         "pos_enc_window_decay_steps": DECAY, "use_time_latents": False, "num_time_dim": 8}
# the reference and the port compute the same f32 operations in another
# library's order (encoding, products, sums): the image within a few f32
# roundings of its largest attenuation, as the benchmark's `view` limit
# reads it
REF_REL = 1e-6


def static_setup(seed: int, width: int = 32):
    """The port's config and ``StaticHParams``, weights in the benchmark's
    layout (the output layer x50 and +20, as the benchmark's render cells
    scale it), rays and depths."""
    field = dict(FIELD, num_filters=width)
    weights = inputs.field_weights({"static": field}, seed, torch.device("cpu"))
    weights["static"]["out"]["w"] *= 50.0
    weights["static"]["out"]["b"] += 20.0
    cfg = program_fields({"fields": {"static": field}})["static"]
    origins, dirs = rays(N_RAYS, seed)
    z = torch.linspace(3.6, 5.4, S)
    return field, weights, cfg, origins, dirs, z


def old_static_view(params, origins, dirs, z, step, cfg, hp, tile):
    """The static method's view as it was rendered before it took the
    shared renderer: the plain field's points tile by tile, joined, then
    ``render_transmission`` over the whole view."""
    window = ts.field_window(cfg, step, origins.device)
    parts = []
    for start in range(0, origins.shape[0], tile):
        o, d = origins[start:start + tile], dirs[start:start + tile]
        pts = o[:, None, :] + d[:, None, :] * z[:, None]
        parts.append(ff.plain_static_field(params["static"], pts, cfg, window, hp.dtype)[..., 0])
    raw = torch.cat(parts)
    i0 = torch.full((raw.shape[0],), I0)
    pix, sigma, dists = render_transmission(raw[..., None], i0, z, hp.output_activation)
    return {"pix_static": pix, "static_sigma": sigma, "dists": dists}


@pytest.mark.parametrize("step", [60, 150])  # the window partly open, then open
@pytest.mark.parametrize("seed", [3, 2147483659, 4294967311])
def test_static_view_matches_the_plain_reference(seed, step):
    field, weights, cfg, origins, dirs, z = static_setup(seed)
    hp = ts.StaticHParams(depth_samples_coarse=S, use_pallas=True)
    got = evaluation.render_test_view(weights, origins, dirs, None, z, step, {"static": cfg},
                                      hp, I0, tile=16)
    want = reference.render_view(weights, {"fields": {"static": field}},
                                 {"origins": origins, "directions": dirs}, z, step, I0)
    assert want.shape == (1, N_RAYS)
    scale = float((I0 - want.double()).abs().max())
    assert scale > 0.05  # densities in a trained field's range, not a near-blank image
    gap = float((got["pix_static"].double() - want[0].double()).abs().max()) / scale
    assert gap <= REF_REL, gap
    # the control, one precision below f32 (TF32 products), reads over it
    tf32 = reference.render_view(weights, {"fields": {"static": field}},
                                 {"origins": origins, "directions": dirs}, z, step, I0,
                                 tf32=True)
    assert float((tf32[0].double() - want[0].double()).abs().max()) / scale > REF_REL


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("tile", [16, 50, 4096])  # a partial last tile, one exact, one past
def test_static_view_matches_the_old_body(tile, use_pallas, compute_dtype):
    _, weights, cfg, origins, dirs, z = static_setup(5, width=128)
    hp = ts.StaticHParams(depth_samples_coarse=S, use_pallas=use_pallas,
                          compute_dtype=compute_dtype)
    ft.reset_launch_counts()
    got = evaluation.render_static_test_view(weights, origins, dirs, z, 60, cfg, hp, I0,
                                             tile=tile)
    assert ft.LAUNCHES["eval_composite.torch"] == 1
    assert ft.LAUNCHES["eval_static.kernel"] == ft.LAUNCHES["eval_composite.kernel"] == 0
    want = old_static_view(weights, origins, dirs, z, 60, cfg, hp, tile)
    assert set(got) == {"pix_static", "static_sigma", "dists"}
    for k in ("static_sigma", "dists"):
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    torch.testing.assert_close(got["pix_static"], want["pix_static"], rtol=1e-6, atol=0)


def test_static_view_is_the_wrapper_and_refuses_a_hull():
    _, weights, cfg, origins, dirs, z = static_setup(7)
    hp = ts.StaticHParams(depth_samples_coarse=S)
    a = evaluation.render_test_view(weights, origins, dirs, None, z, 60, {"static": cfg}, hp,
                                    I0, tile=16)
    b = evaluation.render_static_test_view(weights, origins, dirs, z, 60, cfg, hp, I0, tile=16)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        evaluation.render_test_view(weights, origins, dirs, None, z, 60, {"static": cfg}, hp,
                                    I0, hull=object())


@pytest.mark.parametrize("fields", [1, 2])
def test_cpu_views_keep_the_torch_route(fields):
    # the kernels' condition (use_pallas, 128-wide fields) off the card: a
    # static view and a composite view each take ops/render.py, counted
    # once as a torch composite, and launch nothing; the composite view's
    # outputs are the whole-view composite's bit for bit
    from tests.test_torch_eval_composite import whole_view_composite

    cfgs = {k: dataclasses.replace(c, num_filters=128) for k, c in field_cfgs().items()}
    if fields == 1:
        cfgs.pop("temp")
    params = field_params(cfgs)
    origins, dirs = rays(10)
    phases = torch.arange(10) % 10
    z = torch.linspace(3.6, 5.4, 8)
    hp = (ts.CompositeHParams(depth_samples_coarse=8, use_pallas=True) if fields == 2
          else ts.StaticHParams(depth_samples_coarse=8, use_pallas=True))
    assert not evaluation.composite_on_kernel(origins, cfgs, hp)
    ft.reset_launch_counts()
    ff.reset_launch_counts()
    got = evaluation.render_test_view(params, origins, dirs, phases if fields == 2 else None,
                                      z, 50, cfgs, hp, I0, tile=4)
    assert ft.LAUNCHES["eval_composite.torch"] == ft.LAUNCHES["eval_view.eager"] == 1
    assert not any(v for k, v in ft.LAUNCHES.items()
                   if k not in ("eval_composite.torch", "eval_view.eager"))
    assert not any(ff.LAUNCHES.values())
    if fields == 2:
        want = whole_view_composite(params, origins, dirs, phases, z, cfgs, hp, None, "", True)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    else:
        assert set(got) == {"pix_static", "static_sigma", "dists"}


@pytest.mark.parametrize("fault", ["raw_short", "raw_float64", "z_rows", "past_the_view"])
def test_eval_static_refuses_malformed_tiles(fault):
    # the one-field kernel's wrapper checks what it hands the card as
    # pointers before any launch (so the checks run here, with no card)
    r, s, n = 4, 8, 10
    z = torch.linspace(3.6, 5.4, s)
    raw, start = torch.zeros(r, s), 0
    out = ft.eval_static_buffers(n, z)
    assert out["static_sigma"].shape == (n, s) and out["dists"].shape == (s,)
    if fault == "raw_short":
        raw = torch.zeros(r, s - 1)
    elif fault == "raw_float64":
        raw = raw.double()
    elif fault == "z_rows":
        with pytest.raises(ValueError):
            ft.eval_static_buffers(n, torch.zeros(n - 1, s))
        z = torch.zeros(n, s)
    else:
        start = n - r + 1
    with pytest.raises(ValueError):
        ft.eval_static(raw, z, I0, "softplus", out, start)


@pytest.mark.parametrize("fault", ["float64", "too_many_rays", "z_rows", "outside_envelope"])
def test_static_field_rays_refuse_what_they_would_launch(fault):
    _, weights, cfg, origins, dirs, z = static_setup(9, width=128)
    window = ts.field_window(cfg, 60)
    if fault == "outside_envelope":
        with pytest.raises(NotImplementedError):
            ff.StaticFieldRays(weights["static"], dataclasses.replace(cfg, num_filters=64),
                               window, "float32", N_RAYS)
        return
    k1 = ff.StaticFieldRays(weights["static"], cfg, window, "float32", N_RAYS // 2)
    before = ff.LAUNCHES["fused_static_field_fwd.rays"]
    o, d = origins[:N_RAYS // 2], dirs[:N_RAYS // 2]
    if fault == "float64":
        o = o.double()
    elif fault == "too_many_rays":
        o, d = origins, dirs
    else:
        z = z[None].expand(3, -1).contiguous()
    with pytest.raises(ValueError):
        k1(o, d, z)
    assert ff.LAUNCHES["fused_static_field_fwd.rays"] == before


def test_each_view_packs_the_one_field_k1_once(monkeypatch):
    # on the card a static view packs its field and window once for all its
    # tiles (evaluation._tile_fields), from the weights as they are at that
    # view: checked here without a launch, each pack's call replaced by the
    # plain field on the weights it was given
    _, weights, cfg, origins, dirs, z = static_setup(11, width=128)
    hp = ts.StaticHParams(use_pallas=True)
    made = []

    class Counted(ff.StaticFieldRays):
        def __init__(self, params, cfg, window, compute_dtype, n_rays):
            super().__init__(params, cfg, window, compute_dtype, n_rays)
            self.params, self.cfg, self.window, self.n_rays = params, cfg, window, n_rays
            made.append(self)

        def __call__(self, o, d, z):
            return ff.plain_static_field_rays(self.params, o, d, z, self.cfg, self.window)[..., 0]

    monkeypatch.setattr(evaluation, "StaticFieldRays", Counted)

    def view(step):
        windows = evaluation.view_windows({"static": cfg}, step)
        return list(evaluation._tiles(weights, origins, dirs, None, z, windows,
                                      {"static": cfg}, hp, 16, None, "", True))

    assert len(view(60)) == 4 and len(made) == 1  # 50 rays in 16-ray tiles
    assert made[0].n_rays == 16 and torch.equal(made[0].window, ts.field_window(cfg, 60))
    with torch.no_grad():
        weights["static"]["early"][0]["w"].add_(1.0)  # the pack holds it transposed, a copy
    tiles = view(70)
    assert len(made) == 2 and torch.equal(made[1].window, ts.field_window(cfg, 70))
    assert torch.equal(made[1].pack.w0, weights["static"]["early"][0]["w"].t())
    assert not torch.equal(made[0].pack.w0, made[1].pack.w0)
    want = ff.plain_static_field_rays(weights["static"], origins, dirs, z, cfg,
                                      ts.field_window(cfg, 70))[..., 0]
    assert torch.equal(torch.cat([raws[0] for _, raws, _ in tiles]), want)
