"""The CUDA kernels K1/K2 and K3's loss kernel against their plain PyTorch
versions on the card, and their bf16 instantiations (bf16 compute, bf16
residual storage) against the bf16 twin. Imports torch only (the machine with the card has no JAX), so it runs
there without this directory's conftest:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" tests/test_torch_gpu.py -q

On a machine without CUDA every test skips itself."""

import dataclasses
import math
import zlib

import pytest
import torch
import torch.nn.functional as F

from nerfca_tpu_torch.models.fields import FieldConfig, init_static_field, init_temporal_field
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.encoding import free_window_mask, nerfies_window, posenc
from nerfca_tpu_torch.train.step import is_buffer, param_items

# K1: f32 raw densities, only the summation order differs from the plain
# version; K2: each leaf within 2e-2 of max(its scale, 1e-2 x global max),
# the rule of bench.py:93-116
K1_ATOL = 2e-4
K2_REL = 2e-2

# ReLU units whose pre-activation lies within rounding of zero at some
# point may take the other side of the mask in the kernels (3xTF32
# mma.sync) than in the plain f32 version; the gradient of such a unit's
# weight row and bias then differs by that point's whole contribution
# (ROADMAP §3). The comparison leaves out exactly the units whose mask
# differs (read from K1 itself, below), no others, and holds each flipped
# point to the rounding bound of its pre-activation:
#   |pre| <= (l + 1) (3 * 2^-22 + (3 K + 1) * 2^-24) S,   S = sum_k |h[k] w[n,k]| + |b[n]|
# over the f64 inputs of layer l (0 the input layer, K its fan-in): each
# 3xTF32 product drops small*small and rounds both small parts to TF32
# (3 * 2^-22 of |a b|), the 3 K products and the bias accumulate in f32
# (one 2^-24 rounding each), and each of the l layers below passes its own
# error up. Such flips are rare events of the data, so their count is
# held to a Poisson tail: a batch of n points may hold at most the count
# that it exceeds with probability FLIP_TAIL at FLIP_RATE flipped units a
# point. FLIP_RATE is measured on the card by
# ``scripts/gpu_check_seeds.py --survey 40`` (80 cases of 64 rays x 500
# samples, two 4 x 128 fields, free_windowed and fourier, on an NVIDIA H100:
# 516 units in 2,560,000 points, 6.45 a case on average, the most in one
# case 15; every flipped point within its bound; PERF.md). The limit is
# then 22 units at 32,000 points, 8 at 3,700, 3 at 99.
FLIP_RATE = 516 / 2_560_000
FLIP_TAIL = 1e-6


def max_flipped_units(n_points: int) -> int:
    lam = n_points * FLIP_RATE
    k, term = 0, math.exp(-lam)
    cdf = term
    while 1.0 - cdf > FLIP_TAIL:
        k += 1
        term *= lam / k
        cdf += term
    return k


def flip_bound(layer: int, fan_in: int) -> float:
    return (layer + 1) * (3 * 2.0 ** -22 + (3 * fan_in + 1) * 2.0 ** -24)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make(dev, r=37, s=100, basis=12, layers=4, enc="free_windowed", seed=0, shared_z=False,
         sigma=2.0):
    kw = dict(num_early_layers=layers, num_filters=128, pos_enc=enc, pos_enc_basis=basis,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100, fourier_sigma=sigma)
    cfg_s, cfg_t = FieldConfig(**kw), FieldConfig(use_time_latents=True, num_time_dim=8, **kw)
    keys = prng.split(prng.key(seed))
    params = {"static": init_static_field(keys[0], cfg_s, dev),
              "temp": init_temporal_field(keys[1], cfg_t, dev)}
    leaves = [t.requires_grad_(True) for n, t in param_items(params) if not is_buffer(n)]
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.tensor([[0.05, -0.1, -4.5]], device=dev).repeat(r, 1)
    d = torch.cat([(torch.rand(r, 2, generator=g, device=dev) - 0.5) * 0.2,
                   torch.ones(r, 1, device=dev)], 1)
    z = torch.sort(3.6 + 1.8 * torch.rand(1 if shared_z else r, s, generator=g, device=dev),
                   dim=1).values
    z = z[0].contiguous() if shared_z else z
    ph = torch.randint(0, 10, (r,), generator=g, device=dev)
    if enc == "free_windowed":
        w = free_window_mask(basis, 70, 100, 1, device=dev)
    elif enc == "nerfies_windowed":
        w = nerfies_window(basis, 2.5, device=dev)
    else:
        w = None
    args = (params["static"], params["temp"], o, d, z, ph, cfg_s, cfg_t, w, w)
    return args, leaves


def grads(fn, args, leaves, cot):
    out = fn(*args)
    return out, torch.autograd.grad(sum((x * c).sum() for x, c in zip(out, cot)), leaves)


def case_generator(args) -> torch.Generator:
    """A generator seeded by the case: its shapes and field configs."""
    o, z, cfg_s = args[2], args[4], args[6]
    key = repr((tuple(o.shape), tuple(z.shape), cfg_s.pos_enc, cfg_s.pos_enc_basis,
                cfg_s.num_early_layers)).encode()
    return torch.Generator(device=o.device).manual_seed(zlib.crc32(key))


def field_inputs(params, cfg: FieldConfig, pts, phases, window):
    """The plain version's encoded input of a field ``[N, k0]``."""
    x = pts.reshape(-1, 3)
    enc = posenc(x, cfg.pos_enc, cfg.pos_enc_basis, window=window,
                 fourier_coefficients=params.get("fourier"))
    if cfg.use_time_latents:
        enc = torch.cat([enc, params["latents"].to(x.dtype)[phases.reshape(-1).long()]], -1)
    return enc


def plain_preacts(params, cfg: FieldConfig, pts, phases, window) -> list:
    """Each early layer's pre-activation ``[N, 128]`` and its scale S
    (``sum_k |h[k] w[n,k]| + |b[n]|``), in the dtype of ``pts``."""
    h = field_inputs(params, cfg, pts, phases, window)
    out = []
    for layer in params["early"]:
        w, b = layer["w"].detach().to(h.dtype), layer["b"].detach().to(h.dtype)
        pre = F.linear(h, w, b)
        out.append((pre, F.linear(h.abs(), w.abs(), b.abs())))
        h = torch.relu(pre)
    return out


def kernel_masks(packs, rays, layer: int) -> list:
    """K1's own ReLU masks ``[N, 128]`` of early layer ``layer`` of each
    pack's field: K1 on the field cut after that layer, its output weights
    one-hot, so the output is exactly relu(pre) of one unit per launch."""
    cut = []
    for pk in packs:
        if pk is None:
            cut.append(None)
            continue
        cfg = dataclasses.replace(pk.cfg, num_early_layers=layer)
        leaves = [pk.w0.t(), pk.b0]
        for i in range(layer):
            leaves += [pk.wh[i].t(), pk.bh[i]]
        wo, bo = torch.zeros(1, 128, device=pk.wo.device), torch.zeros(1, device=pk.wo.device)
        cut.append(ff._Pack(cfg, leaves + [wo, bo], pk.table, pk.wo.device))
    o, d, z, ph, lat = rays
    masks = [[] for _ in packs]
    for n in range(128):
        for pk in cut:
            if pk is not None:
                pk.wo.zero_()
                pk.wo[n] = 1.0
        outs = ff.fused_field_fwd(cut[0], cut[1], o, d, z, ph, lat)
        for m, out in zip(masks, outs):
            if out is not None:
                m.append(out > 0)
    return [torch.stack(m, -1) if m else None for m in masks]


def relu_flips(params_list, cfgs, windows, rays, pts, phases) -> list:
    """Every (field, layer, unit) whose mask in K1 differs from the plain
    f32 version's at some point, with those points' f32 and f64
    pre-activations and their bound."""
    dev = pts.device
    packs = [None if p is None else ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, w), dev)
             for p, c, w in zip(params_list, cfgs, windows)]
    flips = []
    for fi, (p, c, w) in enumerate(zip(params_list, cfgs, windows)):
        if p is None:
            continue
        p64 = {"early": [{k: v.detach().double() for k, v in layer.items()}
                         for layer in p["early"]],
               **{k: p[k].detach().double() for k in ("latents", "fourier") if k in p}}
        with torch.no_grad():
            pre32 = plain_preacts(p, c, pts, phases, w)
            pre64 = plain_preacts(p64, c, pts.double(), phases,
                                  None if w is None else w.double())
        for l in range(c.num_early_layers + 1):
            with torch.no_grad():
                km = kernel_masks(packs, rays, l)[fi]
            diff = km != (pre32[l][0] > 0)
            fan_in = p["early"][l]["w"].shape[1]
            for n in torch.nonzero(diff.any(0)).flatten().tolist():
                pts_n = torch.nonzero(diff[:, n]).flatten().tolist()
                flips.append({
                    "field": ("static", "temp")[fi], "layer": l, "unit": n,
                    "points": [{"point": q, "kernel": bool(km[q, n]),
                                "pre32": float(pre32[l][0][q, n]),
                                "pre64": float(pre64[l][0][q, n]),
                                "bound": flip_bound(l, fan_in) * float(pre64[l][1][q, n])}
                               for q in pts_n]})
    return flips


def leaf_names(params_s, params_t) -> list:
    return [n for n, _ in param_items({"static": params_s, "temp": params_t})
            if not is_buffer(n)]


def compare_grads(names, k_g, p_g, flips, n_points: int) -> None:
    """K2's rule on every element but the flipped units' weight rows and
    biases; each flipped point within its bound, at most
    ``max_flipped_units(n_points)`` units."""
    limit = max_flipped_units(n_points)
    print(f"{len(flips)} ReLU units whose mask differs between K1 and the plain f32 version "
          f"in {n_points} points; limit {limit} (rate {FLIP_RATE:.3g} a point, tail "
          f"{FLIP_TAIL})", flips)
    assert len(flips) <= limit, flips
    for f in flips:
        for q in f["points"]:
            assert abs(q["pre64"]) <= q["bound"], f
    skip = {(f["field"], f["layer"], f["unit"]) for f in flips}
    top = max(float(b.abs().max()) for b in p_g)
    for name, a, b in zip(names, k_g, p_g):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a - b).abs()
        parts = name.split("/")
        if parts[1] == "early":
            for field, layer, unit in skip:
                if (field, layer) == (parts[0], int(parts[2])):
                    err[unit] = 0.0  # row ``unit`` of w [out, in], entry of b
        assert float(err.max()) <= K2_REL * max(float(b.abs().max()), 1e-2 * top), name


def check(args, leaves):
    with torch.no_grad():
        ref = ff.plain_composite_fields_rays(*args)
    gen = case_generator(args)
    cot = [torch.randn(x.shape, generator=gen, device=x.device) for x in ref]
    before = dict(ff.LAUNCHES)
    k_out, k_g = grads(ff.fused_composite_fields_rays, args, leaves, cot)
    assert ff.LAUNCHES["fused_field_fwd"] == before["fused_field_fwd"] + 1
    assert ff.LAUNCHES["fused_field_bwd"] == before["fused_field_bwd"] + 1
    p_out, p_g = grads(ff.plain_composite_fields_rays, args, leaves, cot)
    for a, b in zip(k_out, p_out):
        assert a.shape == b.shape
        assert float((a - b).detach().abs().max()) <= K1_ATOL
    ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    with torch.no_grad():
        pts = ff._points(o, d, z)
    phases = ph[:, None].expand(pts.shape[:2])
    rays = (o, d, z, ph.to(torch.int32), pt["latents"].detach())
    flips = relu_flips((ps, pt), (cfg_s, cfg_t), (w_s, w_t), rays, pts, phases)
    compare_grads(leaf_names(ps, pt), k_g, p_g, flips, phases.numel())
    return k_g, cot


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [dict(r=37, s=100), dict(r=3, s=33), dict(r=64, s=500)])
def test_kernels_match_plain_per_ray_depths(dev, shape):
    check(*make(dev, **shape))


@pytest.mark.gpu
def test_kernels_match_plain_shared_depths(dev):
    check(*make(dev, r=50, s=77, shared_z=True))


@pytest.mark.gpu
@pytest.mark.parametrize("shared_z", [False, True])
@pytest.mark.parametrize("r,s,rem", [(3, 43, 1), (3, 64, 64), (5, 51, 127), (2, 50, 100)])
def test_kernels_match_plain_at_tile_edges(dev, shared_z, r, s, rem):
    # K2's last tile holds 1, half a tile, all but one point, or the whole
    # batch is smaller than one tile
    assert (r * s) % ff.BWD_TILE_POINTS == rem
    check(*make(dev, r=r, s=s, shared_z=shared_z))


@pytest.mark.gpu
@pytest.mark.parametrize("enc,basis,layers",[("none", 0, 1), ("nerfies_windowed", 5, 2),
                                              ("free_windowed", 20, 0)])
def test_kernels_match_plain_other_configs(dev, enc, basis, layers):
    # basis 20: 3 + 120 encoded + 8 latent rows = 131 > 128, the second
    # k-chunk of the input-layer gradient
    check(*make(dev, enc=enc, basis=basis, layers=layers))


# The fourier encoding (the kernels' FOURIER instantiations): sigma 2 puts
# the arguments of sin/cos near 40 rad at these rays' coordinates


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [dict(r=37, s=100), dict(r=3, s=43), dict(r=64, s=500),
                                   dict(r=50, s=77, shared_z=True)])
def test_kernels_match_plain_fourier(dev, shape):
    check(*make(dev, enc="fourier", **shape))


@pytest.mark.gpu
@pytest.mark.parametrize("basis,layers", [(1, 1), (5, 0), (21, 2)])
def test_kernels_match_plain_fourier_other_configs(dev, basis, layers):
    # basis 21: 126 encoded + 8 latent rows, the input layer's second k-chunk
    check(*make(dev, enc="fourier", basis=basis, layers=layers))


@pytest.mark.gpu
@pytest.mark.parametrize("static_enc,temp_enc", [("fourier", "free_windowed"),
                                                 ("free_windowed", "fourier")])
def test_kernels_match_plain_mixed_encodings(dev, static_enc, temp_enc):
    # one field fourier, the other windowed: the FOURIER instantiation
    # picks each field's mode at run time
    args, _ = make(dev, enc=static_enc)
    targs, _ = make(dev, enc=temp_enc)
    args = (args[0], targs[1], *args[2:7], targs[7], args[8], targs[9])
    leaves = [t.requires_grad_(True) for n, t in
              param_items({"static": args[0], "temp": args[1]}) if not is_buffer(n)]
    check(args, leaves)


@pytest.mark.gpu
def test_fourier_projection_takes_no_gradient(dev):
    # a buffer, as in JAX: even asked for, no gradient reaches it
    args, leaves = make(dev, r=8, s=32, enc="fourier")
    coef = [args[0]["fourier"].requires_grad_(True), args[1]["fourier"].requires_grad_(True)]
    for fn in (ff.fused_composite_fields_rays, ff.plain_composite_fields_rays):
        out = fn(*args)
        got = torch.autograd.grad(out[0].sum() + out[1].sum(), coef, allow_unused=True)
        assert all(g is None for g in got)


@pytest.mark.gpu
@pytest.mark.parametrize("shared_z", [False, True])
@pytest.mark.parametrize("s", [2, 63, 64, 65, 127, 128, 129, 500, 1024])
def test_forward_matches_plain_at_tile_edges(dev, shared_z, s):
    # K1's 64-point tiles: 3 rays of s samples, a partial last tile unless
    # 3 s is a multiple of 64, rays that start inside a tile
    args, _ = make(dev, r=3, s=s, shared_z=shared_z)
    before = ff.LAUNCHES["fused_field_fwd"]
    with torch.no_grad():
        got = ff.fused_composite_fields_rays(*args)
        want = ff.plain_composite_fields_rays(*args)
    assert ff.LAUNCHES["fused_field_fwd"] == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= K1_ATOL


@pytest.mark.gpu
def test_forward_is_deterministic(dev):
    args, _ = make(dev, r=200, s=77)
    with torch.no_grad():
        first = ff.fused_composite_fields_rays(*args)
        again = ff.fused_composite_fields_rays(*args)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_backward_is_deterministic(dev):
    args, leaves = make(dev, r=200, s=64)
    first, cot = check(args, leaves)
    _, again = grads(ff.fused_composite_fields_rays, args, leaves, cot)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# K1 in f32 on wgmma (csrc/k1_wgmma.cuh): its weight planes, its
# persistent schedule's edges, every hidden-layer count, one and two
# fields, run-to-run bits, and the route each precision takes.


def k1_forward(args, compute_dtype="float32"):
    with torch.no_grad():
        return ff.fused_composite_fields_rays(*args, compute_dtype=compute_dtype)


def assert_forward_matches_plain(args):
    before = dict(ff.LAUNCHES)
    got = k1_forward(args)
    assert ff.LAUNCHES["fused_field_fwd.wgmma"] == before["fused_field_fwd.wgmma"] + 1
    with torch.no_grad():
        want = ff.plain_composite_fields_rays(*args)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= K1_ATOL
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("fields", [1, 2])
@pytest.mark.parametrize("enc,basis,layers", [("free_windowed", 12, 4), ("fourier", 12, 2),
                                              ("free_windowed", 20, 0)])
def test_weight_planes_match_twin(dev, fields, enc, basis, layers):
    # fwd_kernel_wsplit's planes bit for bit against their torch twin
    args, _ = make(dev, enc=enc, basis=basis, layers=layers)
    packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, w), dev)
             for p, c, w in ((args[0], args[6], args[8]), (args[1], args[7], args[9]))]
    packs = packs[:fields] + [None] * (2 - fields)
    got = ff.fused_field_fwd_planes(*packs)
    want = ff.wgmma_planes(*packs)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("layers", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shared_z", [False, True])
def test_forward_matches_plain_hidden_layers(dev, layers, shared_z):
    assert_forward_matches_plain(make(dev, r=37, s=100, layers=layers, shared_z=shared_z)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fewer_tiles_than_ctas", "ragged_last_tile",
                                  "one_tile_per_cta", "two_rounds_ragged"])
@pytest.mark.parametrize("fields", [1, 2])
def test_forward_persistent_schedule_edges(dev, case, fields):
    # the grid holds fwd_clusters() clusters of two CTAs; a unit is one
    # field on a pair of 128-point tiles
    clusters = ff.fwd_clusters()
    assert clusters >= 1
    pairs = {"fewer_tiles_than_ctas": 3, "ragged_last_tile": 5,
             "one_tile_per_cta": clusters // fields, "two_rounds_ragged": 2 * clusters + 1}[case]
    n = 256 * pairs - (0 if case == "one_tile_per_cta" else 77)
    if fields == 2:
        assert_forward_matches_plain(make(dev, r=n, s=1)[0])
        return
    params, pts, cfg, w, _ = static_points(dev, n, 1)
    before = dict(ff.LAUNCHES)
    with torch.no_grad():
        got = ff.fused_static_field(params, pts, cfg, w)
        want = ff.plain_static_field(params, pts, cfg, w)
    assert ff.LAUNCHES["fused_field_fwd.wgmma"] == before["fused_field_fwd.wgmma"] + 1
    assert float((got - want).abs().max()) <= K1_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
@pytest.mark.parametrize("shared_z", [False, True])
def test_forward_is_deterministic_wgmma(dev, enc, shared_z):
    args, _ = make(dev, r=300, s=77, enc=enc, shared_z=shared_z)
    first = k1_forward(args)
    for _ in range(2):
        for a, b in zip(first, k1_forward(args)):
            assert torch.equal(a, b)
    params, pts, cfg, w, _ = static_points(dev, 300, 77, enc=enc)
    with torch.no_grad():
        one = ff.fused_static_field(params, pts, cfg, w)
        assert torch.equal(one, ff.fused_static_field(params, pts, cfg, w))


@pytest.mark.gpu
def test_forward_routes(dev):
    # f32 calls take the wgmma route alone, bf16 calls the mma.sync one alone
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    args, _ = make(dev, r=16, s=64)
    params, pts, cfg, w, _ = static_points(dev, 16, 64)
    k3_args, h = k3_inputs(dev, r=16, s=64)
    f32 = [lambda: k1_forward(args), lambda: ff.fused_static_field(params, pts, cfg, w),
           lambda: ft.fused_train_loss_and_grads(*k3_args, hull=h)]
    bf16 = [lambda: k1_forward(args, "bfloat16"),
            lambda: ff.fused_static_field(params, pts, cfg, w, "bfloat16")]
    for calls, route in ((f32, "wgmma"), (bf16, "mma_sync")):
        other = "mma_sync" if route == "wgmma" else "wgmma"
        before = dict(ff.LAUNCHES)
        for call in calls:
            call()
        assert ff.LAUNCHES["fused_field_fwd." + route] == before["fused_field_fwd." + route] + len(
            calls)
        assert ff.LAUNCHES["fused_field_fwd." + other] == before["fused_field_fwd." + other]


@pytest.mark.gpu
def test_wrapper_checks_inputs(dev):
    args, _ = make(dev, r=4, s=16)
    bad_dtype = list(args)
    bad_dtype[2] = args[2].double()
    with pytest.raises(ValueError):
        ff.fused_composite_fields_rays(*bad_dtype)
    bad_layout = list(args)
    bad_layout[3] = torch.ones(3, 4, device=dev).t()  # [4, 3], not contiguous
    with pytest.raises(ValueError):
        ff.fused_composite_fields_rays(*bad_layout)
    # a fourier field without its projection, and one past the envelope
    # (6 * 22 = 132 encoded features > 128)
    fourier = list(args)
    fourier[6] = dataclasses.replace(args[6], pos_enc="fourier")
    with pytest.raises(ValueError):
        ff.fused_composite_fields_rays(*fourier)
    wide = list(args)
    wide[6] = dataclasses.replace(args[6], pos_enc="fourier", pos_enc_basis=22)
    with pytest.raises(NotImplementedError):
        ff.fused_composite_fields_rays(*wide)


# K3: loss and every term rel 1e-3 (f32 sums over a ray and over rays in
# another order), grads by K2's rule above
K3_REL = 1e-3


def k3_inputs(dev, r=37, s=100, hull=False, seed=0, act="softplus", enc="free_windowed"):
    from nerfca_tpu_torch.ops.hull import MotionHull
    from nerfca_tpu_torch.train.step import CompositeHParams

    args, _ = make(dev, r=r, s=s, shared_z=True, seed=seed, enc=enc)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    pixels = 2.16 - 0.3 * torch.rand(r, generator=g, device=dev)
    weights = 1.0 + torch.rand(r, generator=g, device=dev)
    i0 = torch.full((r,), 2.16, device=dev)
    gate = None
    if hull:
        # a random grid over part of the rays' x range: rays that miss it
        # are empty (gate exactly 0 on every sample)
        grid = torch.rand(8, 8, 8, generator=g, device=dev)
        gate = MotionHull(grid, torch.full((3,), 0.1, device=dev),
                          torch.tensor([0.25, -0.1, 0.0], device=dev))
    hp = CompositeHParams(entro_mask_thre=1e-4, entro_use_weighting=True,
                          entro_weighted_thresh=0.03, occl_reg_perc=0.2, use_pallas=True,
                          use_fused_loss=True, output_activation=act)
    lw = [1e-3, 1e-3, 1e-3, 1e-4, 1e-3 if hull else 0.0]
    p_s, p_t, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    return (p_s, p_t, o, d, z, ph, pixels, weights, i0, cfg_s, cfg_t, w_s, w_t, lw, hp), gate


def check_k3(args, h):
    """K3 against its plain version: one launch each of K1, the loss kernel
    and K2; loss and terms rel K3_REL, grads by K2's rule."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import hull_gate_rays

    if h is not None:
        gate = hull_gate_rays(h, args[2], args[3], args[4])
        empty = int((gate.sum(-1) == 0).sum())
        assert 0 < empty < gate.shape[0]
    before = dict(ft.LAUNCHES), dict(ff.LAUNCHES)
    k_loss, k_terms, k_gs, k_gt = ft.fused_train_loss_and_grads(*args, hull=h)
    assert ft.LAUNCHES["fused_train_loss"] == before[0]["fused_train_loss"] + 1
    assert ff.LAUNCHES["fused_field_bwd"] == before[1]["fused_field_bwd"] + 1
    assert ff.LAUNCHES["fused_field_fwd"] == before[1]["fused_field_fwd"] + 1
    p_loss, p_terms, p_gs, p_gt = ft.plain_train_loss_and_grads(*args, hull=h)
    torch.cuda.synchronize()
    assert abs(float(k_loss) - float(p_loss)) <= K3_REL * abs(float(p_loss))
    for k in p_terms:
        assert abs(float(k_terms[k]) - float(p_terms[k])) <= K3_REL * abs(float(p_terms[k])), k
    assert (float(k_terms["hull_s_l1"]) > 0) == (h is not None)
    k_leaves = [t for tree in (k_gs, k_gt) for _, t in param_items({"g": tree})]
    p_leaves = [t for tree in (p_gs, p_gt) for _, t in param_items({"g": tree})]
    top = max(float(b.abs().max()) for b in p_leaves)
    for a, b in zip(k_leaves, p_leaves):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= K2_REL * max(float(b.abs().max()), 1e-2 * top)


@pytest.mark.gpu
@pytest.mark.parametrize("hull", [False, True])
def test_fused_train_matches_plain(dev, hull):
    check_k3(*k3_inputs(dev, hull=hull))


@pytest.mark.gpu
@pytest.mark.parametrize("s,hull", [(2, False), (129, False), (129, True), (1024, False),
                                    (1024, True)])
@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
def test_fused_train_matches_plain_at_edges(dev, act, s, hull):
    # the shortest and longest rays K3 takes and rays that end one point
    # into a K1 tile, every activation, with and without a gate that leaves
    # some rays empty (two shared depths may both miss the gate's grid, so
    # the shortest ray runs ungated)
    check_k3(*k3_inputs(dev, s=s, hull=hull, act=act))


@pytest.mark.gpu
@pytest.mark.parametrize("hull", [False, True])
def test_fused_train_matches_plain_fourier(dev, hull):
    check_k3(*k3_inputs(dev, hull=hull, enc="fourier"))


def loss_kernel_inputs(dev):
    """K1's raw densities and the loss kernel's arguments for 64 gated rays
    of 500 samples; the tensors the arguments point to are kept alive."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import hull_gate_rays

    args, h = k3_inputs(dev, r=64, s=500, hull=True, seed=3)
    p_s, p_t, o, d, z, ph, pixels, weights, i0, cfg_s, cfg_t, w_s, w_t, lw, hp = args
    pack_s = ff._Pack(cfg_s, ff._leaves(p_s), w_s, dev)
    pack_t = ff._Pack(cfg_t, ff._leaves(p_t), w_t, dev)
    with torch.no_grad():
        raw_s, raw_t = ff.fused_field_fwd(pack_s, pack_t, o, d, z, ph.to(torch.int32),
                                          p_t["latents"].detach())
    gate = hull_gate_rays(h, o, d, z).contiguous()
    occl = ft.occlusion_mask(z, hp).contiguous()
    largs = ft.loss_args(pixels, weights, i0, gate, occl, lw, hp, o.shape[0], z.shape[0])
    return dict(raw_s=raw_s, raw_t=raw_t, z=z, largs=largs, gate=gate, occl=occl,
                batch=(pixels, weights, i0), lw=lw, hp=hp)


@pytest.mark.gpu
def test_fused_train_cotangents_match_plain(dev):
    # the loss kernel's own outputs: the hand-derived cotangents against the
    # plain version's on the kernel's raw densities (K1), within 1e-3 of
    # each tensor's scale, and the terms
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    li = loss_kernel_inputs(dev)
    raw_s, raw_t, z, gate = li["raw_s"], li["raw_t"], li["z"], li["gate"]
    terms, g_s, g_t = ft.fused_train_loss(raw_s, raw_t, z, li["largs"])
    pixels, weights, i0 = li["batch"]
    r, s = gate.shape
    p_terms, pg_s, pg_t = ft.loss_cotangents_plain(raw_s.view(r, s), raw_t.view(r, s), z, pixels,
                                                  weights, i0, li["lw"], li["hp"], gate=gate)
    torch.cuda.synchronize()
    for a, b in ((g_s, pg_s), (g_t, pg_t)):
        assert float((a.view(r, s) - b).abs().max()) <= 1e-3 * float(b.abs().max())
    assert torch.allclose(terms, p_terms, rtol=K3_REL, atol=0)


@pytest.mark.gpu
def test_loss_kernel_is_deterministic(dev):
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    li = loss_kernel_inputs(dev)
    first = ft.fused_train_loss(li["raw_s"], li["raw_t"], li["z"], li["largs"])
    again = ft.fused_train_loss(li["raw_s"], li["raw_t"], li["z"], li["largs"])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# The static method's entries: the one-field K1/K2 (fused_static_field)
# against plain_static_field by K1's and K2's rules, and the point form
# against the ray form on the same points.


def static_points(dev, r, s, seed=0, **kw):
    """The static field's params, a window and the points ``[r, s, 3]`` of
    ``make``'s rays, with the leaves to differentiate."""
    args, _ = make(dev, r=r, s=s, seed=seed, **kw)
    params, o, d, z, cfg, w = args[0], args[2], args[3], args[4], args[6], args[8]
    leaves = [t for n, t in param_items({"static": params}) if not is_buffer(n)]
    with torch.no_grad():
        pts = ff._points(o, d, z).contiguous()
    return params, pts, cfg, w, leaves


def check_static(params, pts, cfg, w, leaves):
    before = dict(ff.LAUNCHES)
    k_out = ff.fused_static_field(params, pts, cfg, w)
    assert ff.LAUNCHES["fused_static_field_fwd"] == before["fused_static_field_fwd"] + 1
    assert ff.LAUNCHES["fused_field_fwd"] == before["fused_field_fwd"]
    p_out = ff.plain_static_field(params, pts, cfg, w)
    assert k_out.shape == p_out.shape == (*pts.shape[:2], 1)
    assert float((k_out - p_out).detach().abs().max()) <= K1_ATOL
    key = repr((tuple(pts.shape), cfg.pos_enc, cfg.pos_enc_basis, cfg.num_early_layers))
    gen = torch.Generator(device=pts.device).manual_seed(zlib.crc32(key.encode()))
    cot = torch.randn(p_out.shape, generator=gen, device=pts.device)
    k_g = torch.autograd.grad((k_out * cot).sum(), leaves)
    assert ff.LAUNCHES["fused_static_field_bwd"] == before["fused_static_field_bwd"] + 1
    assert ff.LAUNCHES["fused_field_bwd"] == before["fused_field_bwd"]
    p_g = torch.autograd.grad((p_out * cot).sum(), leaves)
    # the point form: one-sample rays from the points (fused_field._point_rays)
    n = pts.shape[0] * pts.shape[1]
    o, d, z = ff._point_rays(pts)
    rays = (o, d, z, torch.zeros(n, dtype=torch.int32, device=pts.device),
            torch.zeros(1, ff.MAX_LAT, device=pts.device))
    flips = relu_flips((params, None), (cfg, None), (w, None), rays, pts, None)
    names = [n for n, _ in param_items({"static": params}) if not is_buffer(n)]
    compare_grads(names, k_g, p_g, flips, n)
    return k_out, k_g, cot


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,rem", [(1, 1, 1), (3, 43, 1), (3, 64, 64), (5, 51, 127),
                                     (2, 50, 100), (37, 100, 116), (64, 500, 0)])
def test_static_field_matches_plain_at_tile_edges(dev, r, s, rem):
    # K1's and K2's 128-point tiles: the last holds 1, half a tile, all but
    # one point, all of them, or the whole batch is under one tile
    assert (r * s) % ff.BWD_TILE_POINTS == rem
    check_static(*static_points(dev, r, s))


@pytest.mark.gpu
@pytest.mark.parametrize("enc,basis,layers", [("none", 0, 1), ("nerfies_windowed", 5, 2),
                                              ("free_windowed", 20, 0)])
def test_static_field_matches_plain_other_configs(dev, enc, basis, layers):
    # basis 20: 123 encoded rows, the input layer's second k-chunk in K2
    check_static(*static_points(dev, 37, 100, enc=enc, basis=basis, layers=layers))


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,basis", [(37, 100, 12), (3, 43, 12), (64, 500, 12), (5, 51, 21)])
def test_static_field_matches_plain_fourier(dev, r, s, basis):
    check_static(*static_points(dev, r, s, enc="fourier", basis=basis))


@pytest.mark.gpu
def test_static_field_is_deterministic(dev):
    params, pts, cfg, w, leaves = static_points(dev, 200, 64)
    out, g, cot = check_static(params, pts, cfg, w, leaves)
    again = ff.fused_static_field(params, pts, cfg, w)
    assert torch.equal(out, again)
    for a, b in zip(g, torch.autograd.grad((again * cot).sum(), leaves)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("r,s", [(37, 100), (3, 43)])
def test_point_form_equals_ray_form(dev, r, s):
    # the same points in the same order: origin the point, direction and
    # depth 0, so the kernels encode the same coordinates and every tile and
    # CTA sums in the same order; outputs and gradients are bitwise equal
    args, leaves = make(dev, r=r, s=s)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    with torch.no_grad():
        pts = ff._points(o, d, z).contiguous()
    pph = ph[:, None].expand(r, s)
    cot = [torch.randn(r, s, 1, device=dev) for _ in range(2)]
    ray_out, ray_g = grads(ff.fused_composite_fields_rays, args, leaves, cot)
    before = ff.LAUNCHES["fused_field_fwd"]
    pt_out, pt_g = grads(ff.fused_composite_fields, (ps, pt, pts, pph, cfg_s, cfg_t, w_s, w_t),
                         leaves, cot)
    assert ff.LAUNCHES["fused_field_fwd"] == before + 1
    for a, b in zip(pt_out, ray_out):
        assert torch.equal(a, b)
    for a, b in zip(pt_g, ray_g):
        assert torch.equal(a, b)
    p_out = ff.plain_composite_fields(ps, pt, pts, pph, cfg_s, cfg_t, w_s, w_t)
    for a, b in zip(pt_out, p_out):
        assert float((a - b).detach().abs().max()) <= K1_ATOL


@pytest.mark.gpu
def test_static_entry_checks_inputs(dev):
    params, pts, cfg, w, _ = static_points(dev, 4, 16)
    with pytest.raises(ValueError):
        ff.fused_static_field(params, pts.double(), cfg, w)
    with pytest.raises(ValueError):
        ff.fused_static_field(params, pts[..., :2], cfg, w)
    with pytest.raises(NotImplementedError):
        ff.fused_static_field(params, pts, dataclasses.replace(cfg, num_filters=64), w)


# bf16 compute and bf16 residual storage. The bf16 kernels take bf16
# operands and f32 sums, as their twin does (fused_field.twin_*), so only
# the f32 summation order, and the rare bf16 rounding of an activation it
# flips, separate them. Each statistic of the kernel against its twin must
# lie within BF16_GATE of the same statistic between the bf16 and the f32
# twins on the same inputs, so that an f32 kernel cannot pass it: the mean
# |difference| of each field's raw densities (a rounding flip moves one
# point by up to ~2e-3 of scale and leaves the others alone: by the mean
# the kernel sits ~1e-3 of the way to f32), and for the gradients the worst
# leaf's max |difference| over max(its scale, 1e-2 x the largest), K2's
# normalization (one flipped ReLU unit moves its row by ~1/sqrt(N) of
# scale, so the gradient checks take 32,000 points: ~5e-3 against a bf16
# gap of ~0.2).
BF16_GATE = 0.1


def mean_gap(a, b) -> float:
    return float((a - b).detach().abs().mean())


def leaf_gap(got, want) -> float:
    top = max(float(b.abs().max()) for b in want)
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-2 * top)
               for a, b in zip(got, want))


def assert_bf16_forward(k_out, t_out, f_out) -> None:
    for k, t, f in zip(k_out, t_out, f_out):
        if t is None:
            continue
        assert k.shape == t.shape and torch.isfinite(k).all()
        err, gap = mean_gap(k, t), mean_gap(t, f)
        print(f"bf16 forward: mean |kernel - twin| {err:.3e}, mean |twin - f32 twin| {gap:.3e}")
        assert err <= BF16_GATE * gap


def assert_bf16_grads(k_g, t_g, f_g) -> None:
    for a in k_g:
        assert torch.isfinite(a).all()
    err, gap = leaf_gap(k_g, t_g), leaf_gap(t_g, f_g)
    print(f"bf16 gradients: worst leaf {err:.3e} of scale, bf16 vs f32 twin {gap:.3e}")
    assert err <= BF16_GATE * gap


def check_bf16(args, leaves, gradients=True):
    """The bf16 K1 (and K2) against the bf16 twin: one launch each of the
    bf16 instantiations and none of the f32 ones."""
    with torch.no_grad():
        ref = ff.plain_composite_fields_rays(*args)
    gen = case_generator(args)
    cot = [torch.randn(x.shape, generator=gen, device=x.device) for x in ref]
    before = dict(ff.LAUNCHES)
    if not gradients:
        with torch.no_grad():
            k_out = ff.fused_composite_fields_rays(*args, compute_dtype="bfloat16")
            t_out = ff.twin_composite_fields_rays(*args, compute_dtype="bfloat16")
        assert ff.LAUNCHES["fused_field_fwd_bf16"] == before["fused_field_fwd_bf16"] + 1
        assert ff.LAUNCHES["fused_field_fwd"] == before["fused_field_fwd"]
        assert_bf16_forward(k_out, t_out, ref)
        return
    k_out, k_g = grads(lambda *a: ff.fused_composite_fields_rays(*a, compute_dtype="bfloat16"),
                       args, leaves, cot)
    for name in ("fused_field_fwd", "fused_field_bwd"):
        assert ff.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
        assert ff.LAUNCHES[name] == before[name]
    t_out, t_g = grads(lambda *a: ff.twin_composite_fields_rays(*a, compute_dtype="bfloat16"),
                       args, leaves, cot)
    f_out, f_g = grads(ff.plain_composite_fields_rays, args, leaves, cot)
    assert_bf16_forward(k_out, t_out, f_out)
    assert_bf16_grads(k_g, t_g, f_g)
    return k_out, k_g, cot


@pytest.mark.gpu
@pytest.mark.parametrize("enc,basis,layers", [("free_windowed", 12, 4), ("fourier", 12, 4),
                                              ("free_windowed", 20, 2), ("none", 0, 1)])
def test_bf16_kernels_match_twin(dev, enc, basis, layers):
    # the flagship fields, fourier, and basis 20: the temporal field's
    # 131-column input layer, whose last 16-deep step runs past the
    # 140-float row (its upper half reads as zero)
    check_bf16(*make(dev, r=64, s=500, enc=enc, basis=basis, layers=layers))


@pytest.mark.gpu
@pytest.mark.parametrize("shared_z", [False, True])
@pytest.mark.parametrize("r,s", [(3, 33), (3, 43), (5, 51), (37, 100), (2, 50)])
def test_bf16_forward_at_tile_edges(dev, shared_z, r, s):
    check_bf16(*make(dev, r=r, s=s, shared_z=shared_z), gradients=False)


@pytest.mark.gpu
def test_bf16_kernels_are_deterministic(dev):
    args, leaves = make(dev, r=64, s=500)
    out, g, cot = check_bf16(args, leaves)
    again, g2 = grads(lambda *a: ff.fused_composite_fields_rays(*a, compute_dtype="bfloat16"),
                      args, leaves, cot)
    for a, b in zip((*out, *g), (*again, *g2)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
def test_bf16_static_field_matches_twin(dev, enc):
    params, pts, cfg, w, leaves = static_points(dev, 64, 500, enc=enc)
    gen = torch.Generator(device=dev).manual_seed(3)
    cot = torch.randn(*pts.shape[:2], 1, generator=gen, device=dev)
    before = dict(ff.LAUNCHES)
    outs, gs = [], []
    for fn, cd in ((ff.fused_static_field, "bfloat16"), (ff.twin_static_field, "bfloat16"),
                   (ff.plain_static_field, "float32")):
        out = fn(params, pts, cfg, w, cd)
        outs.append(out)
        gs.append(torch.autograd.grad((out * cot).sum(), leaves))
    for name in ("fused_static_field_fwd", "fused_static_field_bwd"):
        assert ff.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
        assert ff.LAUNCHES[name] == before[name]
    assert_bf16_forward(*([o] for o in outs))
    assert_bf16_grads(*gs)


@pytest.mark.gpu
def test_bf16_point_form_equals_ray_form(dev):
    # as in f32: the same points in the same order give bitwise-equal
    # outputs and gradients
    args, leaves = make(dev, r=37, s=100)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    with torch.no_grad():
        pts = ff._points(o, d, z).contiguous()
    pph = ph[:, None].expand(37, 100)
    cot = [torch.randn(37, 100, 1, device=dev) for _ in range(2)]
    ray = grads(lambda *a: ff.fused_composite_fields_rays(*a, compute_dtype="bfloat16"), args,
                leaves, cot)
    point = grads(lambda *a: ff.fused_composite_fields(*a, compute_dtype="bfloat16"),
                  (ps, pt, pts, pph, cfg_s, cfg_t, w_s, w_t), leaves, cot)
    for a, b in zip((*ray[0], *ray[1]), (*point[0], *point[1])):
        assert torch.equal(a, b)


def k3_bf16(args, h, **kw):
    return args[:-1] + (dataclasses.replace(args[-1], **kw),), h


def term_gap(got, want) -> float:
    return max(abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
               for k in want if float(want[k]))


@pytest.mark.gpu
@pytest.mark.parametrize("hull", [False, True])
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
def test_bf16_fused_train_matches_twin(dev, enc, hull):
    # K3 under bf16 compute: the gradients within BF16_GATE of the bf16
    # twin's distance from the f32 twin; the loss and terms, which the f32
    # loss kernel forms from bf16 K1's raw densities and which bf16 moves by
    # only ~1e-5, by K3_REL as in f32
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    args, h = k3_inputs(dev, r=64, s=500, hull=hull, enc=enc)
    bargs, _ = k3_bf16(args, h, compute_dtype="bfloat16")
    before = dict(ff.LAUNCHES)
    k = ft.fused_train_loss_and_grads(*bargs, hull=h)
    for name in ("fused_field_fwd", "fused_field_bwd"):
        assert ff.LAUNCHES[name + "_bf16"] == before[name + "_bf16"] + 1
        assert ff.LAUNCHES[name] == before[name]
    t = ft.plain_train_loss_and_grads(*bargs, hull=h)
    f = ft.plain_train_loss_and_grads(*args, hull=h)
    assert abs(float(k[0]) - float(t[0])) <= K3_REL * abs(float(t[0]))
    assert term_gap(k[1], t[1]) <= K3_REL
    leaves = [[x for tree in r[2:] for _, x in param_items({"g": tree})] for r in (k, t, f)]
    assert_bf16_grads(*leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("hull", [False, True])
def test_bf16_residuals_keep_the_f32_loss(dev, hull):
    # K3 over bf16 residual storage: loss and terms equal the f32 K3's bit
    # for bit (the forward and the loss kernel are the f32 ones), and so do
    # the gradients of every leaf whose dW reads no stored activation
    # (biases, latents, the input layer), while the others move
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    args, h = k3_inputs(dev, r=64, s=500, hull=hull)
    rargs, _ = k3_bf16(args, h, pallas_bf16_residuals=True)
    before = dict(ff.LAUNCHES)
    k_res = ft.fused_train_loss_and_grads(*rargs, hull=h)
    assert ff.LAUNCHES["fused_field_bwd_res_bf16"] == before["fused_field_bwd_res_bf16"] + 1
    assert ff.LAUNCHES["fused_field_bwd"] == before["fused_field_bwd"]
    k_f32 = ft.fused_train_loss_and_grads(*args, hull=h)
    assert float(k_res[0]) == float(k_f32[0])
    assert all(float(k_res[1][n]) == float(k_f32[1][n]) for n in k_f32[1])
    moved = 0
    for (name, kr), (_, kf) in zip(*[param_items({"static": r[2], "temp": r[3]})
                                     for r in (k_res, k_f32)]):
        if name.endswith("/w") and "/early/0/" not in name:
            moved += not torch.equal(kr, kf)
        else:
            assert torch.equal(kr, kf), name
    assert moved > 0


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
def test_bf16_residuals_k2_change_matches_twin(dev, enc):
    # K2 over bf16 residual storage against the f32 K2 on the same
    # cotangents: each hidden or output weight's change, dk, carries the
    # twin's change, dt (its backward with and without the rounding, the
    # same sums apart from it): the share beta = <dk, dt> / <dt, dt> within
    # BF16_GATE of 1 (an f32 kernel, which changes nothing, sits at 0). The
    # f32 sums that separate the kernel's forward from the twin's make ~0.2%
    # of the stored activations round the other way: that moves dk - dt by
    # up to 0.16 of |dt| on the card, but beta by ~1%. Every other leaf
    # keeps its bits.
    args, _ = make(dev, r=64, s=500, enc=enc)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    gen = case_generator(args)
    cot = [torch.randn(64 * 500, generator=gen, device=dev) for _ in range(2)]
    packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, w), dev)
             for p, c, w in ((ps, cfg_s, w_s), (pt, cfg_t, w_t))]
    before = dict(ff.LAUNCHES)
    flats = [ff.fused_field_bwd(*packs, o, d, z, ph.to(torch.int32), pt["latents"].detach(),
                                *cot, res_bf16=res) for res in (True, False)]
    assert ff.LAUNCHES["fused_field_bwd_res_bf16"] == before["fused_field_bwd_res_bf16"] + 1
    n_phases = pt["latents"].shape[0]
    size_s = packs[0].grad_layout(n_phases)["size"]
    kernel = [[g for pk, part in zip(packs, (f[:size_s], f[size_s:]))
               for g in pk.leaf_grads(part, n_phases)[0]] for f in flats]
    leaves = ff._leaves(ps) + ff._leaves(pt)
    twin = []
    for res in (True, False):
        out = ff.twin_composite_fields_rays(*args, "float32", res, hand_backward=True)
        twin.append(torch.autograd.grad(
            sum((x * c.view(x.shape)).sum() for x, c in zip(out, cot)), leaves))
    names = [f"{n}/{k}" for c in (cfg_s, cfg_t)
             for n in [f"early/{i}" for i in range(c.num_early_layers + 1)] + ["out"] for k in "wb"]
    moved = 0
    for name, kr, kf, tr, tf_ in zip(names, *kernel, *twin):
        if not name.endswith("/w") or name.startswith("early/0/"):
            assert torch.equal(kr, kf), name
            continue
        moved += 1
        dk, dt = (kr - kf).double(), (tr - tf_).double()
        beta = float((dk * dt).sum() / (dt * dt).sum())
        print(f"{name}: share of the twin's change {beta:.4f}, |dk - dt| / |dt| "
              f"{float((dk - dt).norm() / dt.norm()):.3e}")
        assert abs(beta - 1) <= BF16_GATE, name
    assert moved == 2 * (cfg_s.num_early_layers + 1)


@pytest.mark.gpu
def test_span_on_the_card_adds_no_device_event(dev):
    # a span is a host record only: the kernel launched under it is the
    # only device event, and the kernel's launch call lies inside the span
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfca_tpu_torch.utils.profiling import span

    buf = torch.ones(2**20, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("nerfca.card"):
            buf.mul_(2.0)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    device = [e for e in events if e.device_type() == DeviceType.CUDA]
    assert len(device) == 1 and not device[0].name().startswith("nerfca.")
    host = next(e for e in events if e.name() == "nerfca.card")
    call = next(e for e in events if e.device_type() != DeviceType.CUDA
                and e.name().startswith("cu") and e.correlation_id() == device[0].correlation_id())
    assert host.start_ns() <= call.start_ns() <= host.end_ns()


@pytest.mark.gpu
def test_device_memory_stats_and_trace_on_the_card(dev, tmp_path):
    # utils/profiling.py on the card: one entry per CUDA device, the live
    # bytes counting a fresh 64 MiB buffer, the limit the card's memory;
    # a trace of a launch on the card is written with CUDA activity in it
    import json
    import os

    from nerfca_tpu_torch.utils.profiling import device_memory_stats, trace

    before = device_memory_stats()[0]
    buf = torch.empty(16 * 2**20, device=dev)
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count() and stats[0]["device"] == "cuda:0"
    assert stats[0]["bytes_in_use"] >= before["bytes_in_use"] + buf.numel() * 4
    assert stats[0]["peak_bytes_in_use"] >= stats[0]["bytes_in_use"]
    assert stats[0]["bytes_limit"] == torch.cuda.get_device_properties(0).total_memory
    with trace(str(tmp_path)) as t:
        buf.mul_(2.0)
        torch.cuda.synchronize()
    with open(os.path.join(tmp_path, t.name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
