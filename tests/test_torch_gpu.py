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
         sigma=2.0, open_bands=False):
    """Both fields' params and a batch of rays; a free window at step 70 of
    100 (bands 10-11 nearly shut, band 9 at 0.4), or with ``open_bands``
    every band open, as the flagship's window is once its decay ends."""
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
        w = (torch.ones(basis, device=dev) if open_bands
             else free_window_mask(basis, 70, 100, 1, device=dev))
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
@pytest.mark.parametrize("shape", [dict(r=37, s=100), dict(r=3, s=33), dict(r=64, s=500),
                                   dict(r=1024, s=628, open_bands=True)])
def test_kernels_match_plain_per_ray_depths(dev, shape):
    # 1024 x 628: the fine pass's batch of per-ray depths, every band open
    check(*make(dev, **shape))


@pytest.mark.gpu
@pytest.mark.parametrize("r,s", [(50, 77), (1024, 500)])
def test_kernels_match_plain_shared_depths(dev, r, s):
    # 1024 x 500: the flagship train batch, every band open
    check(*make(dev, r=r, s=s, shared_z=True, open_bands=r == 1024))


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
                                   dict(r=50, s=77, shared_z=True),
                                   dict(r=1024, s=500, shared_z=True)])
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
    # the grid holds fwd_clusters() clusters of two CTAs; a unit is a pair
    # of 128-point tiles, carrying both fields (the shared units: make's
    # pair has one window) or the one field; the per-field units of the
    # pair (a window apart for each field), two units a tile pair, give the
    # same bits. One unit a cluster: `clusters` tile pairs for the shared
    # units and the one field, half as many for the per-field units of two
    clusters = ff.fwd_clusters()
    assert clusters >= 1
    pairs = {"fewer_tiles_than_ctas": [3], "ragged_last_tile": [5],
             "one_tile_per_cta": [clusters, max(1, clusters // 2)],
             "two_rounds_ragged": [2 * clusters + 1]}[case]
    if fields == 2:
        for p in pairs:
            n = 256 * p - (0 if case == "one_tile_per_cta" else 77)
            args = make(dev, r=n, s=1)[0]
            before = ff.LAUNCHES[SHARED]
            got = assert_forward_matches_plain(args)
            assert ff.LAUNCHES[SHARED] == before + 1
            rays = (*args[2:5], args[5].to(torch.int32), args[1]["latents"].detach())
            for a, b in zip(got, k1_per_field(args, rays)):
                assert torch.equal(a.reshape(-1).view(torch.int32), b.view(torch.int32))
        return
    n = 256 * pairs[0] - (0 if case == "one_tile_per_cta" else 77)
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
@pytest.mark.parametrize("case", [
    dict(fields=2), dict(fields=2, layers=0), dict(fields=2, layers=1),
    dict(fields=2, enc="fourier"), dict(fields=1), dict(fields=1, layers=0),
    dict(fields=1, layers=1), dict(fields=1, enc="fourier"), dict(fields=2, r=1024, s=628),
    dict(fields=2, r=37, s=101), dict(fields=1, r=37, s=101), dict(fields=2, layers=8)],
    ids=["pair", "pair_no_hidden", "pair_one_hidden", "pair_fourier", "static",
         "static_no_hidden", "static_one_hidden", "static_fourier", "pair_fine_shape",
         "pair_odd_units", "static_odd_units", "pair_eight_hidden"])
def test_forward_f32_instantiations(dev, case):
    # every f32 instantiation: bitwise equal from run to run and within
    # K1_ATOL of the plain version; the fine pass's per-ray depths at its
    # shape (1024 x 628); 3737 points (off a multiple of 256: the last tile
    # pair ragged, the two warpgroups on an odd unit); 8 hidden layers a field,
    # twice the flagship's depth
    case = dict(case)
    fields = case.pop("fields")
    if fields == 2:
        args, _ = make(dev, **case)
        first = assert_forward_matches_plain(args)
        for _ in range(2):
            for a, b in zip(first, k1_forward(args)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        return
    params, pts, cfg, w, _ = static_points(dev, case.pop("r", 37), case.pop("s", 100), **case)
    before = dict(ff.LAUNCHES)
    with torch.no_grad():
        first = ff.fused_static_field(params, pts, cfg, w)
        want = ff.plain_static_field(params, pts, cfg, w)
        for _ in range(2):
            again = ff.fused_static_field(params, pts, cfg, w)
            assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    assert ff.LAUNCHES["fused_field_fwd.wgmma"] == before["fused_field_fwd.wgmma"] + 3
    assert torch.isfinite(first).all()
    assert float((first - want).abs().max()) <= K1_ATOL


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


# K1's shared units: one encoding of a tile pair for both fields when their
# encodings agree (fused_field.encodings_agree), the per-field units
# otherwise; two windows of equal values in two tensors take the latter.

SHARED = "fused_field_fwd.wgmma.shared_enc"


def packs_of(args, apart: bool = False) -> tuple:
    """The two fields' packs; ``apart``: the temporal field reads a copy of
    its window, so that the packs do not share one (the per-field units)."""
    ps, pt, o, _, _, _, cfg_s, cfg_t, w_s, w_t = args
    w_t = w_t.clone() if apart and w_t is not None else w_t
    return tuple(ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, w), o.device)
                 for p, c, w in ((ps, cfg_s, w_s), (pt, cfg_t, w_t)))


def k1_route(args, rays, apart: bool) -> tuple:
    """K1 on ``rays`` with the packs of ``args`` (:func:`packs_of`): the
    densities and the launch's count on SHARED."""
    packs = packs_of(args, apart)
    assert ff.encodings_agree(*packs) != apart
    before = ff.LAUNCHES[SHARED]
    with torch.no_grad():
        got = ff.fused_field_fwd(*packs, *rays)
    return got, ff.LAUNCHES[SHARED] - before


def k1_per_field(args, rays) -> tuple:
    """K1's per-field units on ``rays``: the densities; SHARED stays put."""
    got, count = k1_route(args, rays, apart=True)
    assert count == 0
    return got


def k1_both_routes(args, rays) -> dict:
    """K1 on ``rays`` through the shared and the per-field units, twice
    each: the densities of each route, each call's count on SHARED."""
    out = {}
    for route, apart in (("shared", False), ("per_field", True)):
        runs, counts = zip(*(k1_route(args, rays, apart) for _ in range(2)))
        for a, b in zip(*runs):  # deterministic from run to run
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        out[route] = (runs[0], list(counts))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("problem", ["flagship", "fine", "point_form"])
def test_shared_units_match_per_field(dev, problem):
    # both fields' densities bitwise the per-field units' on the flagship
    # pair (1024 x 500, shared depths), the fine pass's per-ray depths
    # (1024 x 628) and the point form (one-sample rays); within K1_ATOL of
    # the plain version
    r, s = (1024, 628) if problem == "fine" else (1024, 500) if problem == "flagship" else (37, 101)
    args, _ = make(dev, r=r, s=s, shared_z=problem == "flagship")
    _, pt, o, d, z, ph = args[:6]
    lat = pt["latents"].detach()
    if problem == "point_form":
        with torch.no_grad():
            pts = ff._points(o, d, z).contiguous()
        rays = (*ff._point_rays(pts), ph[:, None].expand(r, s).reshape(-1).to(torch.int32)
                .contiguous(), lat)
    else:
        rays = (o, d, z, ph.to(torch.int32), lat)
    got = k1_both_routes(args, rays)
    assert got["shared"][1] == [1, 1] and got["per_field"][1] == [0, 0]
    for a, b in zip(got["shared"][0], got["per_field"][0]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    with torch.no_grad():
        want = ff.plain_composite_fields_rays(*args)
    for a, b in zip(got["shared"][0], want):
        assert torch.isfinite(a).all()
        assert float((a - b.reshape(-1)).abs().max()) <= K1_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["static", "fourier", "other_windows", "other_basis"])
def test_shared_units_only_where_encodings_agree(dev, case):
    # NF 1, fourier (projections of their own), two windows of different
    # schedules and two bases take the per-field units: SHARED stays put
    if case == "static":
        params, pts, cfg, w, _ = static_points(dev, 37, 100)
        before = dict(ff.LAUNCHES)
        with torch.no_grad():
            got = ff.fused_static_field(params, pts, cfg, w)
            want = ff.plain_static_field(params, pts, cfg, w)
        assert ff.LAUNCHES["fused_field_fwd.wgmma"] == before["fused_field_fwd.wgmma"] + 1
        assert ff.LAUNCHES[SHARED] == before[SHARED]
        assert float((got - want).abs().max()) <= K1_ATOL
        return
    args, _ = make(dev, r=37, s=100, enc="fourier" if case == "fourier" else "free_windowed")
    args = list(args)
    if case == "other_windows":
        args[9] = free_window_mask(12, 70, 150, 1, device=dev)  # another decay
        assert not torch.equal(args[8], args[9])
    if case == "other_basis":
        args[7] = dataclasses.replace(args[7], pos_enc_basis=10)
        args[1] = init_temporal_field(prng.key(5), args[7], dev)
        args[9] = free_window_mask(10, 70, 100, 1, device=dev)
    assert not ff.encodings_agree(*packs_of(args))
    before = dict(ff.LAUNCHES)
    assert_forward_matches_plain(args)
    assert ff.LAUNCHES[SHARED] == before[SHARED]


@pytest.mark.gpu
def test_render_path_shares_every_k1_launch(dev):
    # the eval renderer's windows (train.step.field_windows) are one tensor
    # for the flagship's pair, so every K1 launch of a view shares its
    # encoding
    from nerfca_tpu_torch.train.evaluation import render_test_view
    from nerfca_tpu_torch.train.step import CompositeHParams

    args, _ = make(dev, r=600, s=64, shared_z=True)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, _, _ = args
    cfg_s = dataclasses.replace(cfg_s, pos_enc_window_decay_steps=150000)
    cfg_t = dataclasses.replace(cfg_t, pos_enc_window_decay_steps=150000)
    hp = CompositeHParams(use_pallas=True, depth_samples_coarse=64)
    before = dict(ff.LAUNCHES)
    out = render_test_view({"static": ps, "temp": pt}, o, d, ph, z, 75000,
                           {"static": cfg_s, "temp": cfg_t}, hp, 2.16, tile=256)
    n = ff.LAUNCHES["fused_field_fwd.wgmma"] - before["fused_field_fwd.wgmma"]
    assert n == 3 and ff.LAUNCHES[SHARED] - before[SHARED] == n
    assert torch.isfinite(out["pix"]).all()


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


def k3_inputs(dev, r=37, s=100, hull=False, seed=0, act="softplus", enc="free_windowed",
              open_bands=False):
    from nerfca_tpu_torch.ops.hull import MotionHull
    from nerfca_tpu_torch.train.step import CompositeHParams

    args, _ = make(dev, r=r, s=s, shared_z=True, seed=seed, enc=enc, open_bands=open_bands)
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


def check_k3(args, h, k2="fused_field_bwd"):
    """K3 against its plain version: one launch each of K1, the loss kernel
    and K2 (``k2``, the launch counter of the K2 that ``args`` select);
    loss and terms rel K3_REL, grads by K2's rule."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import hull_gate_rays

    if h is not None:
        gate = hull_gate_rays(h, args[2], args[3], args[4])
        empty = int((gate.sum(-1) == 0).sum())
        assert 0 < empty < gate.shape[0]
    before = dict(ft.LAUNCHES), dict(ff.LAUNCHES)
    k_loss, k_terms, k_gs, k_gt = ft.fused_train_loss_and_grads(*args, hull=h)
    assert ft.LAUNCHES["fused_train_loss"] == before[0]["fused_train_loss"] + 1
    assert ff.LAUNCHES[k2] == before[1][k2] + 1
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
@pytest.mark.parametrize("r,s", [(37, 100), (1024, 500)])
@pytest.mark.parametrize("hull", [False, True])
def test_fused_train_matches_plain(dev, hull, r, s):
    # 1024 x 500: the flagship train batch, every band open
    check_k3(*k3_inputs(dev, r=r, s=s, hull=hull, open_bands=r == 1024))


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
@pytest.mark.parametrize("r,s", [(37, 100), (1024, 500)])
@pytest.mark.parametrize("hull", [False, True])
def test_fused_train_matches_plain_fourier(dev, hull, r, s):
    check_k3(*k3_inputs(dev, r=r, s=s, hull=hull, enc="fourier"))


@pytest.mark.gpu
@pytest.mark.parametrize("r,s", [(37, 100), (1024, 500)])
def test_step_loss_kernels_match_plain(dev, r, s):
    # the train step's loss through composite_loss_fn (render, pixel loss and
    # the regularizers), K1 against the plain fields on one batch and one set
    # of depths, by K3's rule; the window of step 100 opens every band
    from nerfca_tpu_torch.train.step import CompositeHParams, composite_loss_fn

    args, _ = make(dev, r=r, s=s, shared_z=True)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, _, _ = args
    g = torch.Generator(device=dev).manual_seed(3)
    batch = {"origins": o, "directions": d, "phases": ph,
             "pixels": 2.16 - 0.5 * torch.rand(r, generator=g, device=dev),
             "weights": 1.0 + torch.rand(r, generator=g, device=dev),
             "initial_intensities": torch.full((r,), 2.16, device=dev)}
    hp = CompositeHParams(img_sample_size=r, depth_samples_coarse=s, entro_use_weighting=True,
                          entro_weighted_thresh=0.03, dynamic_entro_weight_start=1e-10,
                          occl_weight_start=1e-8, l1_weight_start=1e-8, occl_reg_perc=0.2)
    params, cfgs = {"static": ps, "temp": pt}, {"static": cfg_s, "temp": cfg_t}
    before = ff.LAUNCHES["fused_field_fwd"]
    with torch.no_grad():
        got, _ = composite_loss_fn(params, batch, z, 100, cfgs,
                                   dataclasses.replace(hp, use_pallas=True))
        want, _ = composite_loss_fn(params, batch, z, 100, cfgs, hp)
    assert ff.LAUNCHES["fused_field_fwd"] == before + 1
    assert math.isfinite(float(got))
    assert abs(float(got) - float(want)) <= K3_REL * abs(float(want))


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
                                     (2, 50, 100), (37, 100, 116), (64, 500, 0),
                                     (1024, 500, 0)])
def test_static_field_matches_plain_at_tile_edges(dev, r, s, rem):
    # K1's and K2's 128-point tiles: the last holds 1, half a tile, all but
    # one point, all of them, or the whole batch is under one tile; 1024 x
    # 500, the static method's batch at configs/3d.txt's shapes, every band
    # open
    assert (r * s) % ff.BWD_TILE_POINTS == rem
    check_static(*static_points(dev, r, s, open_bands=r == 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("enc,basis,layers", [("none", 0, 1), ("nerfies_windowed", 5, 2),
                                              ("free_windowed", 20, 0)])
def test_static_field_matches_plain_other_configs(dev, enc, basis, layers):
    # basis 20: 123 encoded rows, the input layer's second k-chunk in K2
    check_static(*static_points(dev, 37, 100, enc=enc, basis=basis, layers=layers))


@pytest.mark.gpu
@pytest.mark.parametrize("r,s,basis", [(37, 100, 12), (3, 43, 12), (64, 500, 12), (5, 51, 21),
                                       (1024, 500, 12)])
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
@pytest.mark.parametrize("r,s", [(37, 100), (3, 43), (1024, 500)])
def test_point_form_equals_ray_form(dev, r, s):
    # the same points in the same order: origin the point, direction and
    # depth 0, so the kernels encode the same coordinates and every tile and
    # CTA sums in the same order; outputs and gradients are bitwise equal;
    # 1024 x 500 with every band open
    args, leaves = make(dev, r=r, s=s, open_bands=r == 1024)
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
@pytest.mark.parametrize("enc,basis,layers,r", [
    ("free_windowed", 12, 4, 64), ("fourier", 12, 4, 64), ("free_windowed", 20, 2, 64),
    ("none", 0, 1, 64), ("free_windowed", 12, 4, 1024), ("fourier", 12, 4, 1024)])
def test_bf16_kernels_match_twin(dev, enc, basis, layers, r):
    # the flagship fields, fourier, and basis 20: the temporal field's
    # 131-column input layer, whose last 16-deep step runs past the
    # 140-float row (its upper half reads as zero); 1024 rays: the flagship
    # batch, every band open
    check_bf16(*make(dev, r=r, s=500, enc=enc, basis=basis, layers=layers,
                     open_bands=r == 1024))


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
@pytest.mark.parametrize("r", [64, 1024])
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
def test_bf16_static_field_matches_twin(dev, enc, r):
    params, pts, cfg, w, leaves = static_points(dev, r, 500, enc=enc, open_bands=r == 1024)
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


def check_k3_bf16(args, h):
    """K3 under bf16 compute: the gradients within BF16_GATE of the bf16
    twin's distance from the f32 twin; the loss and terms, which the f32
    loss kernel forms from bf16 K1's raw densities and which bf16 moves by
    only ~1e-5, by K3_REL as in f32."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

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
@pytest.mark.parametrize("enc,hull,r", [("free_windowed", False, 64), ("free_windowed", True, 64),
                                        ("fourier", False, 64), ("fourier", True, 64),
                                        ("free_windowed", False, 1024)])
def test_bf16_fused_train_matches_twin(dev, enc, hull, r):
    # 1024 rays: the flagship batch, every band open
    check_k3_bf16(*k3_inputs(dev, r=r, s=500, hull=hull, enc=enc, open_bands=r == 1024))


@pytest.mark.gpu
@pytest.mark.parametrize("hull,r", [(False, 64), (True, 64), (False, 1024)])
def test_bf16_residuals_fused_train_matches_twin(dev, hull, r):
    # K3 over bf16 residual storage against the residual twin
    # (plain_train_loss_and_grads under pallas_bf16_residuals), by K3's rule
    check_k3(*k3_bf16(*k3_inputs(dev, r=r, s=500, hull=hull, open_bands=r == 1024),
                      pallas_bf16_residuals=True), k2="fused_field_bwd_res_bf16")


def check_res_loss(args, h):
    """K3 over bf16 residual storage: loss and terms equal the f32 K3's bit
    for bit (the forward and the loss kernel are the f32 ones), and so do
    the gradients of every leaf whose dW reads no stored activation
    (biases, latents, the input layer), while the others move."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

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
@pytest.mark.parametrize("hull,r", [(False, 64), (True, 64), (False, 1024)])
def test_bf16_residuals_keep_the_f32_loss(dev, hull, r):
    check_res_loss(*k3_inputs(dev, r=r, s=500, hull=hull, open_bands=r == 1024))


def check_res_k2_change(args):
    """K2 over bf16 residual storage against the f32 K2 on the same
    cotangents: each hidden or output weight's change, dk, carries the
    twin's change, dt (its backward with and without the rounding, the
    same sums apart from it): the share beta = <dk, dt> / <dt, dt> within
    BF16_GATE of 1 (an f32 kernel, which changes nothing, sits at 0). The
    f32 sums that separate the kernel's forward from the twin's make ~0.2%
    of the stored activations round the other way: that moves dk - dt by
    up to 0.16 of |dt| on the card, but beta by ~1%. Every other leaf
    keeps its bits."""
    ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = args
    dev = o.device
    gen = case_generator(args)
    cot = [torch.randn(o.shape[0] * z.shape[-1], generator=gen, device=dev) for _ in range(2)]
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
@pytest.mark.parametrize("enc,r", [("free_windowed", 64), ("fourier", 64), ("free_windowed", 1024)])
def test_bf16_residuals_k2_change_matches_twin(dev, enc, r):
    check_res_k2_change(make(dev, r=r, s=500, enc=enc, open_bands=r == 1024)[0])


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


# ---------------------------------------------------------------------------
# The eval renderer's composite: the Beer-Lambert kernel
# (ops/cuda/fused_train.py::eval_composite) against ops/render.py's torch
# composite on the same raw densities. The sigmas and dists bit for bit;
# each image within COMPOSITE_REL of the largest composite attenuation
# (only the order of each per-ray f32 sum differs)

COMPOSITE_REL = 1e-6


def torch_composite(s_raw, t_raw, z, i0, act, gate=None, images=True) -> dict:
    """``ops/render.py``'s composite of ``[R, S]`` raw densities, as the eval
    renders it in torch."""
    from nerfca_tpu_torch.ops.render import render_transmission, render_transmission_composite

    i0v = torch.full((s_raw.shape[0],), i0, device=s_raw.device)
    pix, s_sig, t_sig, dists = render_transmission_composite(
        s_raw[..., None], t_raw[..., None], i0v, z, act, temp_gate=gate)
    out = {"pix": pix, "static_sigma": s_sig, "temp_sigma": t_sig, "dists": dists}
    if images:
        out["pix_temp"] = render_transmission(t_raw[..., None], i0v, z, act, gate=gate)[0]
        out["pix_static"] = render_transmission(s_raw[..., None], i0v, z, act)[0]
    return out


def composite_gap(got: dict, want: dict, i0: float) -> float:
    """Asserts the sigmas and dists bit for bit; returns the images' worst
    gap over the largest composite attenuation."""
    assert set(got) == set(want)
    for k in ("static_sigma", "temp_sigma", "dists"):
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    scale = float((i0 - want["pix"].double()).abs().max())
    return max(float((got[k].double() - want[k].double()).abs().max())
               for k in want if k.startswith("pix")) / scale


def view_raw(params, o, d, ph, z, step, cfgs, hp, tile, suffix=""):
    """The pair's raw densities of a view, tile by tile as the eval renders
    them (K1 gives the same bits on every launch), joined ``[N, S]``."""
    from nerfca_tpu_torch.train.step import evaluate_fields, field_windows

    windows = field_windows(cfgs, step, o.device)
    with torch.no_grad():
        parts = [evaluate_fields(params, o[i:i + tile], d[i:i + tile], z, ph[i:i + tile],
                                 windows, cfgs, hp, suffix) for i in range(0, o.shape[0], tile)]
    return tuple(torch.cat([p[k][..., 0] for p in parts]) for k in (0, 1))


def check_composite(dev, act="softplus", gated=False, per_ray=False, images=True) -> float:
    """The kernel against the torch composite on densities across every
    branch of the activations (softplus past +-20, clamp on both bounds), a
    gate with exact zeros, 500 shared depths or the fine pair's 628 per-ray
    ones, in three tiles with a partial last one; the depths span 100, so
    that every activation attenuates by about one (a view's trained range)
    and an image's last rounding, i0 - sum near 2.16, is not what the limit
    reads. Returns the images' gap."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    r, s, tile, i0 = 777, 628 if per_ray else 500, 320, 2.16
    g = torch.Generator(device=dev).manual_seed(s + 7 * gated)
    s_raw = 8.0 * torch.randn(r, s, generator=g, device=dev)
    t_raw = 8.0 * torch.randn(r, s, generator=g, device=dev) - 2.0
    gate = None
    if gated:
        gate = torch.rand(r, s, generator=g, device=dev)
        gate = torch.where(gate < 0.2, torch.zeros_like(gate), gate)
    z = torch.sort(100.0 * torch.rand(r if per_ray else 1, s, generator=g, device=dev),
                   dim=1).values
    z = z if per_ray else z[0].contiguous()
    before = ft.LAUNCHES["eval_composite.kernel"]
    got = ft.eval_composite_buffers(r, z, images)
    for start in range(0, r, tile):
        rows = slice(start, start + tile)
        ft.eval_composite(s_raw[rows], t_raw[rows], z, i0, act, got, start,
                          None if gate is None else gate[rows])
    assert ft.LAUNCHES["eval_composite.kernel"] == before + 3
    gap = composite_gap(got, torch_composite(s_raw, t_raw, z, i0, act, gate, images), i0)
    assert gap <= COMPOSITE_REL, gap
    return gap


def check_composite_view(dev, seed=3_000_000_019) -> float:
    """``render_test_view`` on composite-k1-render's view (``portbench/``):
    40000 rays x 500 samples in ten 4096-ray tiles, output layers x50 and
    +20 (a trained field's densities); ten kernel launches, no torch
    composite, and the torch composite of the same raw densities. Returns
    the images' gap."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.train.evaluation import render_test_view
    from portbench import harness
    from portbench.mixes import render

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, "composite-k1-render")
    su = render.setup(cfg, traffic, seed, dev)
    view = su["views"][int(su["order"][0])]
    rays = (su["params"], view["origins"], view["directions"], view["phases"], su["z"],
            su["step"], su["fields"], su["hp"])
    before = dict(ft.LAUNCHES)
    got = render_test_view(*rays, su["i0"], tile=su["tile"])
    assert ft.LAUNCHES["eval_composite.kernel"] == before["eval_composite.kernel"] + 10
    assert ft.LAUNCHES["eval_composite.torch"] == before["eval_composite.torch"]
    want = torch_composite(*view_raw(*rays, su["tile"]), su["z"], su["i0"],
                           su["hp"].output_activation)
    gap = composite_gap(got, want, su["i0"])
    assert gap <= COMPOSITE_REL, gap
    return gap


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("per_ray,images", [(False, True), (False, False), (True, False),
                                            (True, True)])
def test_eval_composite_kernel_matches_torch(dev, act, gated, per_ray, images):
    gap = check_composite(dev, act, gated, per_ray, images)
    print(f"eval composite, {act} gated={gated} per_ray={per_ray} images={images}: "
          f"images within {gap:.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["kernel", "hull", "fine", "bf16", "plain"])
def test_eval_view_routes_its_composite(dev, case):
    # render_test_view on the card: with both fields on K1 each tile's
    # composite is one kernel launch (the hull-gated, fine-pair and bf16
    # evals too); the plain fields keep the torch composite, counted once
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.ops.hull import MotionHull, hull_gate_rays
    from nerfca_tpu_torch.train.evaluation import render_test_view
    from nerfca_tpu_torch.train.step import CompositeHParams

    args, _ = make(dev, r=600, s=64, shared_z=True)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, _, _ = args
    params, cfgs = {"static": ps, "temp": pt}, {"static": cfg_s, "temp": cfg_t}
    z_fine = None
    if case == "fine":
        fine, _ = make(dev, r=600, s=64, shared_z=True, seed=1)
        params.update(static_fine=fine[0], temp_fine=fine[1])
        cfgs.update(static_fine=cfg_s, temp_fine=cfg_t)
        z_fine = torch.linspace(3.7, 5.3, 90, device=dev)
    h = None
    if case == "hull":
        g = torch.Generator(device=dev).manual_seed(3)
        h = MotionHull(torch.rand(8, 8, 8, generator=g, device=dev),
                       torch.full((3,), 0.1, device=dev),
                       torch.tensor([0.25, -0.1, 0.0], device=dev))
    hp = CompositeHParams(use_pallas=case != "plain", depth_samples_coarse=64,
                          compute_dtype="bfloat16" if case == "bf16" else "float32")
    step, tile, i0 = 50, 256, 2.16
    ft.reset_launch_counts()
    got = render_test_view(params, o, d, ph, z, step, cfgs, hp, i0, tile=tile,
                           depth_values_fine=z_fine, hull=h)
    pairs = 2 if case == "fine" else 1
    assert ft.LAUNCHES["eval_composite.kernel"] == (0 if case == "plain" else 3 * pairs)
    assert ft.LAUNCHES["eval_composite.torch"] == (1 if case == "plain" else 0)
    s_raw, t_raw = view_raw(params, o, d, ph, z, step, cfgs, hp, tile)
    gate = None if h is None else hull_gate_rays(h, o, d, z)
    if h is not None:
        assert 0 < int((gate == 0).sum()) < gate.numel()
    want = torch_composite(s_raw, t_raw, z, i0, hp.output_activation, gate)
    if case == "fine":
        s_raw, t_raw = view_raw(params, o, d, ph, z_fine, step, cfgs, hp, tile, "_fine")
        fine = torch_composite(s_raw, t_raw, z_fine, i0, hp.output_activation, images=False)
        want.update({k + "_fine": v for k, v in fine.items()})
    gap = composite_gap(got, want, i0)
    print(f"eval composite, view ({case}): images within {gap:.3e}")
    assert gap <= COMPOSITE_REL


@pytest.mark.gpu
def test_eval_composite_on_the_cells_view(dev):
    gap = check_composite_view(dev)
    print(f"eval composite, the cell's view: images within {gap:.3e} of the largest "
          f"attenuation")


# ---------------------------------------------------------------------------
# The static method's view on the card: the one-field K1 in the ray form
# (ops/cuda/fused_field.py::StaticFieldRays) and the Beer-Lambert kernel's
# one-field sibling (ops/cuda/fused_train.py::eval_static). The densities
# bitwise the point form's on the same points; the sigma and dists bitwise
# ops/render.py's render_transmission, the image within COMPOSITE_REL of
# the largest attenuation (only the order of each per-ray f32 sum differs,
# as for the composite)


def static_rays(dev, r, s, shared_z, compute_dtype="float32", open_bands=False, seed=0,
                enc="free_windowed"):
    """The static field's params, config, window and ``make``'s rays, and
    the one-field K1 packed for them."""
    args, _ = make(dev, r=r, s=s, shared_z=shared_z, open_bands=open_bands, seed=seed, enc=enc)
    params, o, d, z, cfg, w = args[0], args[2], args[3], args[4], args[6], args[8]
    return params, cfg, w, o, d, z, ff.StaticFieldRays(params, cfg, w, compute_dtype, r)


def check_static_rays(dev, r, s, shared_z, compute_dtype="float32", enc="free_windowed"):
    """The one-field K1 on rays against the point form on the same points
    (one launch of the one-field K1 each, so the densities are bitwise
    equal); in f32 within K1_ATOL of the plain field, in bf16 within the
    bf16 gate of the twin; 1024 rays with every band open. Raises on a
    disagreement."""
    params, cfg, w, o, d, z, k1 = static_rays(dev, r, s, shared_z, compute_dtype,
                                              open_bands=r == 1024, enc=enc)
    before = dict(ff.LAUNCHES)
    with torch.no_grad():
        got = k1(o, d, z)
        pts = ff._points(o, d, z).contiguous()
        point = ff.fused_static_field(params, pts, cfg, w, compute_dtype)[..., 0]
        plain = ff.plain_static_field_rays(params, o, d, z, cfg, w)[..., 0]
    suffix = "_bf16" if compute_dtype == "bfloat16" else ""
    assert ff.LAUNCHES["fused_static_field_fwd.rays"] == before["fused_static_field_fwd.rays"] + 1
    assert (ff.LAUNCHES["fused_static_field_fwd" + suffix]
            == before["fused_static_field_fwd" + suffix] + 2)
    assert ff.LAUNCHES["fused_field_fwd" + suffix] == before["fused_field_fwd" + suffix]
    assert got.shape == (r, s) and torch.equal(got, point)
    if suffix:
        with torch.no_grad():
            twin = ff.twin_static_field(params, pts, cfg, w, compute_dtype)[..., 0]
        assert_bf16_forward([got], [twin], [plain])
    else:
        assert float((got - plain).abs().max()) <= K1_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared_z", [False, True])
@pytest.mark.parametrize("r,s", [(37, 100), (3, 43), (1024, 500)])
def test_static_field_rays_match_point_form(dev, r, s, shared_z, compute_dtype, enc):
    # the fourier field is phase 4f's (configs/3d.txt --static_pos_enc
    # fourier), whose eval takes this route
    check_static_rays(dev, r, s, shared_z, compute_dtype, enc)


@pytest.mark.gpu
def test_static_field_rays_check_inputs(dev):
    params, cfg, w, o, d, z, k1 = static_rays(dev, 4, 16, shared_z=True)
    with pytest.raises(ValueError):
        k1(o.double(), d, z)
    with pytest.raises(ValueError):
        k1(torch.cat([o, o]), torch.cat([d, d]), z)  # more rays than packed for
    with pytest.raises(ValueError):
        k1(o, d, z[None].expand(3, -1).contiguous())
    with pytest.raises(NotImplementedError):
        ff.StaticFieldRays(params, dataclasses.replace(cfg, num_filters=64), w, "float32", 4)


def torch_static(raw, z, i0, act) -> dict:
    """``ops/render.py``'s single-field render of ``[R, S]`` raw densities,
    as the static method's view renders it in torch."""
    from nerfca_tpu_torch.ops.render import render_transmission

    i0v = torch.full((raw.shape[0],), i0, device=raw.device)
    pix, sigma, dists = render_transmission(raw[..., None], i0v, z, act)
    return {"pix_static": pix, "static_sigma": sigma, "dists": dists}


def static_gap(got: dict, want: dict, i0: float) -> float:
    """Asserts the sigma and dists bit for bit; returns the image's gap over
    its largest attenuation."""
    assert set(got) == set(want)
    for k in ("static_sigma", "dists"):
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k
    scale = float((i0 - want["pix_static"].double()).abs().max())
    return float((got["pix_static"].double() - want["pix_static"].double()).abs().max()) / scale


def check_eval_static(dev, act, per_ray) -> float:
    """The one-field Beer-Lambert kernel against ``render_transmission``
    on densities across every branch of the activations (softplus past
    +-20, clamp on both bounds), 500 shared depths or 628 per-ray ones,
    three tiles with a partial last one; the depths span 100, so that the
    image attenuates by about one, as check_composite's. Raises on a
    disagreement; returns the image's gap."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    r, s, tile, i0 = 777, 628 if per_ray else 500, 320, 2.16
    g = torch.Generator(device=dev).manual_seed(s + 11)
    raw = 8.0 * torch.randn(r, s, generator=g, device=dev)
    z = torch.sort(100.0 * torch.rand(r if per_ray else 1, s, generator=g, device=dev),
                   dim=1).values
    z = z if per_ray else z[0].contiguous()
    before = dict(ft.LAUNCHES)
    got = ft.eval_static_buffers(r, z)
    for start in range(0, r, tile):
        ft.eval_static(raw[start:start + tile], z, i0, act, got, start)
    assert ft.LAUNCHES["eval_static.kernel"] == before["eval_static.kernel"] + 3
    assert ft.LAUNCHES["eval_composite.kernel"] == before["eval_composite.kernel"]
    gap = static_gap(got, torch_static(raw, z, i0, act), i0)
    assert gap <= COMPOSITE_REL, gap
    return gap


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["softplus", "sigmoid", "clamp"])
@pytest.mark.parametrize("per_ray", [False, True])
def test_eval_static_kernel_matches_torch(dev, act, per_ray):
    gap = check_eval_static(dev, act, per_ray)
    print(f"eval static, {act} per_ray={per_ray}: image within {gap:.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["kernel", "bf16", "plain"])
def test_static_view_routes_its_render(dev, case):
    # render_test_view with the static field alone: with use_pallas each
    # tile is one one-field K1 and one eval_static launch (bf16: K1's bf16
    # instantiation); without, the plain field and render_transmission over
    # the joined tiles, counted once as a torch composite
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.train.evaluation import render_static_test_view, render_test_view
    from nerfca_tpu_torch.train.step import StaticHParams

    cd = "bfloat16" if case == "bf16" else "float32"
    params, cfg, w, o, d, z, k1 = static_rays(dev, 600, 64, shared_z=True, compute_dtype=cd)
    hp = StaticHParams(use_pallas=case != "plain", depth_samples_coarse=64, compute_dtype=cd)
    step, tile, i0 = 70, 256, 2.16
    ft.reset_launch_counts()
    ff.reset_launch_counts()
    got = render_test_view({"static": params}, o, d, None, z, step, {"static": cfg}, hp, i0,
                           tile=tile)
    kernel = case != "plain"
    assert ff.LAUNCHES["fused_static_field_fwd.rays"] == 3 * kernel
    assert ft.LAUNCHES["eval_static.kernel"] == 3 * kernel
    assert ft.LAUNCHES["eval_composite.torch"] == 1 - kernel
    assert ft.LAUNCHES["eval_composite.kernel"] == ff.LAUNCHES["fused_field_fwd"] == 0
    with torch.no_grad():  # tile by tile, as the view runs them
        raw = torch.cat([k1(o[i:i + tile], d[i:i + tile], z) if kernel else
                         ff.plain_static_field_rays(params, o[i:i + tile], d[i:i + tile], z,
                                                    cfg, w)[..., 0]
                         for i in range(0, 600, tile)])
    gap = static_gap(got, torch_static(raw, z, i0, hp.output_activation), i0)
    print(f"eval static, view ({case}): image within {gap:.3e}")
    assert gap <= COMPOSITE_REL
    again = render_static_test_view({"static": params}, o, d, z, step, cfg, hp, i0, tile=tile)
    for k in got:
        assert torch.equal(got[k], again[k]), k


def check_static_view(dev) -> float:
    """static3d-k1-render's view (portbench/): 40000 rays x 500 samples in
    ten 4096-ray tiles: ten one-field K1 launches, ten eval_static launches,
    no torch composite; the image against render_transmission of the same
    raw densities. Raises on a disagreement; returns the image's gap."""
    from nerfca_tpu_torch.ops.cuda import fused_train as ft
    from nerfca_tpu_torch.train.evaluation import render_test_view
    from nerfca_tpu_torch.train.step import field_window
    from portbench import harness
    from portbench.mixes import render

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, "static3d-k1-render")
    su = render.setup(cfg, traffic, 3_000_000_029, dev)
    view = su["views"][int(su["order"][0])]
    o, d, z = view["origins"], view["directions"], su["z"]
    before = {**ff.LAUNCHES, **ft.LAUNCHES}
    got = render_test_view(su["params"], o, d, None, z, su["step"], su["fields"], su["hp"],
                           su["i0"], tile=su["tile"])
    made = {k: v - before[k] for k, v in {**ff.LAUNCHES, **ft.LAUNCHES}.items()}
    assert made["fused_static_field_fwd.rays"] == 10, made
    assert made["fused_static_field_fwd"] == 10, made
    assert made["eval_static.kernel"] == 10, made
    assert made["eval_composite.torch"] == made["eval_composite.kernel"] == 0, made
    cfg_s = su["fields"]["static"]
    k1 = ff.StaticFieldRays(su["params"]["static"], cfg_s, field_window(cfg_s, su["step"], dev),
                            "float32", su["tile"])
    with torch.no_grad():
        raw = torch.cat([k1(o[i:i + su["tile"]], d[i:i + su["tile"]], z)
                         for i in range(0, o.shape[0], su["tile"])])
    gap = static_gap(got, torch_static(raw, z, su["i0"], su["hp"].output_activation), su["i0"])
    assert gap <= COMPOSITE_REL, gap
    return gap


@pytest.mark.gpu
def test_static_view_on_the_cells_view(dev):
    gap = check_static_view(dev)
    print(f"eval static, the cell's view: image within {gap:.3e} of the largest attenuation")


@pytest.mark.gpu
def test_static_view_repacks_updated_weights(dev):
    # each view packs the one-field K1 from the weights as they are then
    # (train/evaluation.py::_tile_fields): an in-place update of the
    # weights, as Adam's, shows in the next view, as other tensors do
    from nerfca_tpu_torch.train.evaluation import render_test_view
    from nerfca_tpu_torch.train.step import StaticHParams

    params, cfg, _, o, d, z, _ = static_rays(dev, 600, 64, shared_z=True)
    hp = StaticHParams(use_pallas=True, depth_samples_coarse=64)

    def render(p):
        return render_test_view({"static": p}, o, d, None, z, 70, {"static": cfg}, hp, 2.16,
                                tile=256)["pix_static"]

    first = render(params)
    assert torch.equal(first, render(params))
    with torch.no_grad():
        params["out"]["b"].add_(1.0)
    updated = render(params)
    fresh = render({"early": [{k: t.detach().clone() for k, t in layer.items()}
                              for layer in params["early"]],
                    "out": {k: t.detach().clone() for k, t in params["out"].items()}})
    assert not torch.equal(first, updated) and torch.equal(updated, fresh)


# ---------------------------------------------------------------------------
# The eval renderer's views as CUDA graphs (train/evaluation.py::ViewGraphs):
# a key's first view runs eagerly and is captured, each later view of the
# key replays the graph. At the cells' shapes (40000 rays x 500 samples in
# 4096-ray tiles), both methods: every output of a replay bitwise the eager
# view's, after an in-place update of the weights and a step inside the
# window's anneal too


VIEW_CELLS = ("composite-k1-render", "static3d-k1-render")
# each cell's route counters: K1's launches and the Beer-Lambert kernel's
VIEW_ROUTES = {"composite-k1-render": (SHARED, "eval_composite.kernel"),
               "static3d-k1-render": ("fused_static_field_fwd.rays", "eval_static.kernel")}


def cell_setup(dev, cell: str, seed: int) -> dict:
    """The cell's views, depths and weights, as ``portbench/`` sets them up."""
    from portbench import harness
    from portbench.mixes import render

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, cell)
    return render.setup(cfg, traffic, seed, dev)


def cell_view(su: dict, v: int, params=None, step=None, eager: bool = False) -> dict:
    """View ``v`` of the cell's order through ``render_test_view`` (with
    ``eager``: through the renderer's eager body, no graph), of ``params``
    (the cell's weights) at ``step`` (the cell's)."""
    from nerfca_tpu_torch.train import evaluation

    view = su["views"][int(su["order"][v % len(su["views"])])]
    params = su["params"] if params is None else params
    step = su["step"] if step is None else step
    o, d = view["origins"], view["directions"]
    phases = view["phases"] if "temp" in su["fields"] else None
    if eager:
        windows = evaluation.view_windows(su["fields"], step, o.device)
        return evaluation._render_view(params, o, d, phases, [("", su["z"])], windows,
                                       su["fields"], su["hp"], su["tile"], su["p_hull"],
                                       su["i0"])
    return evaluation.render_test_view(params, o, d, phases, su["z"], step, su["fields"],
                                       su["hp"], su["i0"], tile=su["tile"], hull=su["p_hull"])


def assert_views_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and torch.equal(got[k], want[k]), k


def launch_counts() -> dict:
    from nerfca_tpu_torch.ops.cuda import fused_train as ft

    return {**ff.LAUNCHES, **ft.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", VIEW_CELLS)
def test_view_graph_replays_the_eager_view(dev, cell):
    # three views of the cell: one capture, two replays, no eager view; the
    # route counters count the three views' launches; each replay bitwise
    # the eager view; the first view's tensors unchanged by the replays
    su = cell_setup(dev, cell, 3_000_000_037)
    before = launch_counts()
    got = [cell_view(su, 0)]
    kept = {k: t.clone() for k, t in got[0].items()}
    got += [cell_view(su, v) for v in (1, 2)]
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert (made["eval_view.capture"], made["eval_view.replay"], made["eval_view.eager"]) == (
        1, 2, 0), made
    k1, bl = VIEW_ROUTES[cell]
    assert made[k1] == made[bl] == 30 and made["eval_composite.torch"] == 0, made
    for v in (1, 2):
        assert_views_equal(got[v], cell_view(su, v, eager=True))
    assert_views_equal(got[0], kept)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", VIEW_CELLS)
def test_view_graph_reads_updated_weights(dev, cell):
    # an Adam-style in-place update of every weight and a step inside the
    # window's anneal (the graph was captured with the window open): the
    # next view replays, bitwise a fresh eager render of the updated
    # weights at that step
    from nerfca_tpu_torch.train import evaluation
    from nerfca_tpu_torch.train.step import field_window

    su = cell_setup(dev, cell, 3_000_000_041)
    cell_view(su, 0)
    cfg = su["fields"]["static"]
    anneal = cfg.pos_enc_window_decay_steps // 2
    assert not torch.equal(field_window(cfg, anneal, dev), field_window(cfg, su["step"], dev))
    g = torch.Generator(device=dev).manual_seed(7)
    with torch.no_grad():
        for t in evaluation._tensors(su["params"]):
            t.add_(1e-3 * torch.randn(t.shape, generator=g, device=dev))
    before = launch_counts()
    got = cell_view(su, 1, step=anneal)
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert made["eval_view.replay"] == 1 and made["eval_view.capture"] == 0, made
    assert_views_equal(got, cell_view(su, 1, step=anneal, eager=True))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", VIEW_CELLS)
def test_view_graph_follows_the_weights_storage(dev, cell):
    # the same values in other storage capture anew (bitwise the first
    # weights' view); once the first weights are freed, their entry is gone
    import gc

    from nerfca_tpu_torch.train import evaluation
    from portbench import inputs

    entries = evaluation.VIEW_GRAPHS.entries
    su = cell_setup(dev, cell, 3_000_000_043)
    cell_view(su, 0)
    first = next(reversed(entries))
    other = inputs.clone_params(su["params"])
    before = launch_counts()
    got = cell_view(su, 1, params=other)
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert made["eval_view.capture"] == 1 and made["eval_view.replay"] == 0, made
    second = next(reversed(entries))
    assert second != first and first in entries
    assert_views_equal(got, cell_view(su, 1, eager=True))
    del su["params"]
    gc.collect()
    assert first not in entries and second in entries


def route_case(dev, case: str) -> tuple:
    """A 600-ray composite view of 64 shared depths for ``case``: the
    kernel path, with a motion hull, with the fine pair on 90 depths of
    its own, in bf16, or the plain fields. ``(params, o, d, ph, z, cfgs,
    hp, z_fine, hull)``."""
    from nerfca_tpu_torch.ops.hull import MotionHull
    from nerfca_tpu_torch.train.step import CompositeHParams

    args, _ = make(dev, r=600, s=64, shared_z=True)
    ps, pt, o, d, z, ph, cfg_s, cfg_t, _, _ = args
    params, cfgs = {"static": ps, "temp": pt}, {"static": cfg_s, "temp": cfg_t}
    z_fine = None
    if case == "fine":
        fine, _ = make(dev, r=600, s=64, shared_z=True, seed=1)
        params.update(static_fine=fine[0], temp_fine=fine[1])
        cfgs.update(static_fine=cfg_s, temp_fine=cfg_t)
        z_fine = torch.linspace(3.7, 5.3, 90, device=dev)
    h = None
    if case == "hull":
        g = torch.Generator(device=dev).manual_seed(3)
        h = MotionHull(torch.rand(8, 8, 8, generator=g, device=dev),
                       torch.full((3,), 0.1, device=dev),
                       torch.tensor([0.25, -0.1, 0.0], device=dev))
    hp = CompositeHParams(use_pallas=case != "plain", depth_samples_coarse=64,
                          compute_dtype="bfloat16" if case == "bf16" else "float32")
    return params, o, d, ph, z, cfgs, hp, z_fine, h


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["hull", "fine", "bf16"])
def test_view_graph_replays_hull_fine_and_bf16_views(dev, case):
    # the hull-gated view, the view with the fine pair and the bf16 view
    # are captured too: the second view replays, bitwise the first
    from nerfca_tpu_torch.train.evaluation import render_test_view

    params, o, d, ph, z, cfgs, hp, z_fine, h = route_case(dev, case)
    before = launch_counts()
    views = [render_test_view(params, o, d, ph, z, 50, cfgs, hp, 2.16, tile=256,
                              depth_values_fine=z_fine, hull=h) for _ in range(2)]
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert (made["eval_view.capture"], made["eval_view.replay"], made["eval_view.eager"]) == (
        1, 1, 0), made
    assert_views_equal(views[1], views[0])


@pytest.mark.gpu
def test_a_view_that_cannot_be_captured_runs_eagerly(dev, monkeypatch):
    # a hull gate that waits for the host fails the capture: the first view
    # is the eager one, every later view of the key runs eagerly (the
    # capture is not tried again), and all of them are the eager view
    from nerfca_tpu_torch.train import evaluation

    params, o, d, ph, z, cfgs, hp, _, h = route_case(dev, "hull")
    gate_rays = evaluation.hull_gate_rays

    def waits_for_the_host(*args):
        gate = gate_rays(*args)
        float(gate.sum())
        return gate

    monkeypatch.setattr(evaluation, "hull_gate_rays", waits_for_the_host)
    before = launch_counts()
    views = [evaluation.render_test_view(params, o, d, ph, z, 50, cfgs, hp, 2.16, tile=256,
                                         hull=h) for _ in range(3)]
    made = {k: v - before[k] for k, v in launch_counts().items()}
    assert (made["eval_view.capture"], made["eval_view.replay"], made["eval_view.eager"]) == (
        0, 0, 3), made
    for got in views[1:]:
        assert_views_equal(got, views[0])
    monkeypatch.undo()  # the card still captures and replays after the failed capture
    again = [evaluation.render_test_view(params, o, d, ph, z, 60, cfgs, hp, 2.16, tile=256)
             for _ in range(2)]
    assert_views_equal(again[1], again[0])
