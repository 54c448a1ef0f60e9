"""K1 in f32 on wgmma (``csrc/k1_wgmma.cuh``) emulated in torch on the CPU.

The kernel reads its weights from planes that ``fwd_kernel_wsplit`` writes
once a launch (``fused_field.wgmma_planes`` is their torch twin, which the
card tests hold bit for bit against the kernel's): per k-step of 8 inputs a
TF32 big and a small plane in wgmma's K-major core matrices, the k slots
permuted so that an accumulator's column pair (2t, 2t + 1) is A's slots t
and t + 4. This file checks that layout against the descriptor constants
of the source, the register mapping from accumulators (and from the
encoded input in shared memory) to A fragments, and the product order: per
layer the bias, then per k-step small*big, big*small, big*big, then the
ReLU; the output layer per thread over its 32 columns, then over the four
threads of a row. The emulated forward at the flagship widths is held
against the plain f32 fields."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerfca_tpu_torch.models.fields import FieldConfig, init_static_field, init_temporal_field
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import fused_field as ff
from nerfca_tpu_torch.ops.encoding import posenc

SOURCE = Path(ff.__file__).resolve().parents[2] / "csrc" / "k1_wgmma.cuh"
# raw densities within RAW_REL of their scale: each 3xTF32 product keeps
# ~2^-21 of itself, as the mma.sync emulation of test_torch_tf32_forward.py
RAW_REL = 1e-5
N_POINTS = 192


def define(name: str) -> int:
    m = re.search(rf"#define {name} (\d+)", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def fields(layers=4, enc="free_windowed", basis=12, seed=0):
    kw = dict(num_early_layers=layers, num_filters=128, pos_enc=enc, pos_enc_basis=basis,
              pos_enc_window_start=1, pos_enc_window_decay_steps=100, fourier_sigma=2.0)
    cfg_s, cfg_t = FieldConfig(**kw), FieldConfig(use_time_latents=True, num_time_dim=8, **kw)
    keys = prng.split(prng.key(seed))
    return (init_static_field(keys[0], cfg_s, "cpu"), init_temporal_field(keys[1], cfg_t, "cpu"),
            cfg_s, cfg_t)


def pack(params, cfg):
    return ff._Pack(cfg, ff._leaves(params), ff.enc_table(params, cfg, None), "cpu")


def decode(planes: torch.Tensor, k: int):
    """One layer's planes -> (big, small) as ``[k-steps, slot, n]``, read by
    the byte offsets of the descriptor: core matrix (n // 8, slot // 4) at
    (n // 8) SBO + (slot // 4) LBO, row n % 8 at 16 bytes, slot % 4 at 4."""
    lbo, sbo = define("K1W_LBO"), define("K1W_SBO")
    nk = planes.numel() // ff.KSTEP_FLOATS
    assert nk == -(-k // 8)
    n = torch.arange(128)[None, :]
    s = torch.arange(8)[:, None]
    off = ((n // 8) * sbo + (s // 4) * lbo + (n % 8) * 16 + (s % 4) * 4) // 4
    blocks = planes.view(nk, 2, 1024)
    return blocks[:, 0][:, off], blocks[:, 1][:, off]


def test_constants_match_the_source():
    assert define("K1W_KSTEP_FLOATS") == ff.KSTEP_FLOATS
    assert define("K1W_TP") == 128
    assert define("K1W_LDE") >= ff.MAX_ENCODED + ff.MAX_LAT
    # the slot order of the source's k1w_slot_input
    slot_input = [2 * s if s < 4 else 2 * s - 7 for s in range(8)]
    assert tuple(slot_input) == ff.SLOT_INPUT
    assert "return s < 4 ? 2 * s : 2 * s - 7;" in SOURCE.read_text()
    # shared memory: the encoded-input buffers, the ring and the mbarriers,
    # as the header's note gives them, within the 232,448 bytes a CTA may take
    smem = (define("K1W_ENC_BUFS") * define("K1W_TP") * define("K1W_LDE") * 4
            + define("K1W_STAGES") * 2 * define("K1W_KSTEP_FLOATS") * 4
            + (2 * define("K1W_STAGES") + 2 * define("K1W_ENC_BUFS")) * 8)
    assert smem == 221_296 <= 232_448
    assert "the barriers: 221,296 bytes." in SOURCE.read_text()


@pytest.mark.parametrize("layers", [0, 1, 4])
@pytest.mark.parametrize("field", ["static", "temp"])
def test_planes_layout_and_split(layers, field):
    ps, pt, cs, ct = fields(layers)
    pk = pack(ps, cs) if field == "static" else pack(pt, ct)
    planes = ff.wgmma_planes(pk)
    k0 = pk.w0.shape[0]
    nk0 = -(-k0 // 8)
    assert planes.numel() == (nk0 + 16 * layers) * ff.KSTEP_FLOATS
    weights = [pk.w0] + [pk.wh[l] for l in range(layers)]
    off = 0
    for w in weights:
        n = -(-w.shape[0] // 8) * ff.KSTEP_FLOATS
        big, small = decode(planes[off:off + n], w.shape[0])
        off += n
        padded = torch.zeros(big.shape[0] * 8, 128)
        padded[:w.shape[0]] = w
        want = padded.view(-1, 8, 128)[:, list(ff.SLOT_INPUT)]
        assert torch.equal(big, ff.tf32_rna(want))
        assert torch.equal(small, ff.tf32_rna(want - big))
        # big keeps 11 bits, big + small about 22
        err = (big.double() + small.double() - want.double()).abs()
        assert float(err.max()) <= 2.0 ** -21 * float(want.abs().max())
    assert off == planes.numel()
    two = ff.wgmma_planes(pack(ps, cs), pack(pt, ct))
    assert torch.equal(two, torch.cat([ff.wgmma_planes(pack(ps, cs)),
                                       ff.wgmma_planes(pack(pt, ct))]))


def test_fragment_mappings_follow_the_slot_order():
    # the accumulator layout of m64nNk8 (thread (g, t) of a warp holds
    # acc[4j + q] = row g + 8 (q >> 1), column 8j + 2t + (q & 1)) and the
    # A layout (a0 (g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
    # t + 4)): the kernel's k1w_frag(acc[4kk], acc[4kk + 2], acc[4kk + 1],
    # acc[4kk + 3]) and k1w_frag(lo.x, hi.x, lo.y, hi.y) of the encoded rows
    # g and g + 8 at inputs 2t, 2t + 1 put input 8kk + SLOT_INPUT[s] in slot s
    h = torch.arange(16 * 128, dtype=torch.float32).view(16, 128)
    for kk in range(16):
        a = torch.full((16, 8), -1.0)
        e = torch.full((16, 8), -1.0)
        for g in range(8):
            for t in range(4):
                acc = {4 * j + q: h[g + 8 * (q >> 1), 8 * j + 2 * t + (q & 1)]
                       for j in range(16) for q in range(4)}
                frag = (acc[4 * kk], acc[4 * kk + 2], acc[4 * kk + 1], acc[4 * kk + 3])
                lo, hi = h[g, 8 * kk + 2 * t: 8 * kk + 2 * t + 2], h[g + 8, 8 * kk + 2 * t:
                                                                    8 * kk + 2 * t + 2]
                smem = (lo[0], hi[0], lo[1], hi[1])
                for dst, vals in ((a, frag), (e, smem)):
                    dst[g, t], dst[g + 8, t], dst[g, t + 4], dst[g + 8, t + 4] = vals
        want = h[:, [8 * kk + s for s in ff.SLOT_INPUT]]
        assert torch.equal(a, want) and torch.equal(e, want)


def emulate_field(params, cfg, pk, x):
    """One field as the kernel computes it on its encoded input ``x [N, k]``:
    the input layer reads its k-steps' columns (``k1w_nk0``), so a wider
    ``x``, the shared units' buffer, gives it the temporal latents past its
    rows, against zero planes."""
    planes = ff.wgmma_planes(pk)
    ws = [pk.w0] + [pk.wh[l] for l in range(cfg.num_early_layers)]
    bs = [pk.b0] + [pk.bh[l] for l in range(cfg.num_early_layers)]
    h, off = x, 0
    for l, (w, b) in enumerate(zip(ws, bs)):
        n = -(-w.shape[0] // 8) * ff.KSTEP_FLOATS
        big, small = decode(planes[off:off + n], w.shape[0])
        off += n
        inp = torch.zeros(h.shape[0], big.shape[0] * 8)
        cols = min(h.shape[1], inp.shape[1])
        inp[:, :cols] = h[:, :cols]
        acc = b.expand(h.shape[0], 128).clone()
        for kk in range(big.shape[0]):
            a = inp[:, [8 * kk + s for s in ff.SLOT_INPUT]]
            a_big = ff.tf32_rna(a)
            a_small = ff.tf32_rna(a - a_big)
            acc = acc + a_small @ big[kk]
            acc = acc + a_big @ small[kk]
            acc = acc + a_big @ big[kk]
        h = torch.relu(acc)
    # output layer: thread t of a row sums columns 8j + 2t, 8j + 2t + 1 in
    # order with fma, then (s0 + s1) + (s2 + s3), then the bias
    wo = pk.wo.double()
    hd = h.double()
    part = []
    for t in range(4):
        s = torch.zeros(h.shape[0], dtype=torch.float32)
        for j in range(16):
            for c in (8 * j + 2 * t, 8 * j + 2 * t + 1):
                s = (hd[:, c] * wo[c] + s.double()).float()
        part.append(s)
    return ((part[0] + part[1]) + (part[2] + part[3])) + pk.bo


@pytest.mark.parametrize("case", [dict(), dict(layers=0), dict(layers=2, seed=3),
                                  dict(enc="fourier", basis=12, seed=1),
                                  dict(enc="nerfies_windowed", basis=5, layers=1)],
                         ids=["flagship", "no_hidden", "two_hidden", "fourier", "nerfies"])
def test_emulated_forward_matches_plain(case):
    ps, pt, cs, ct = fields(**case)
    rng = np.random.default_rng(7)
    pts = torch.tensor(rng.uniform(-0.6, 0.6, (N_POINTS, 3)), dtype=torch.float32)
    phases = torch.tensor(rng.integers(0, 10, N_POINTS))
    window = None if cs.pos_enc == "fourier" else torch.ones(cs.pos_enc_basis)
    packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, window), "cpu")
             for p, c in ((ps, cs), (pt, ct))]
    shared = None  # the shared units' buffer: the temporal field's encoded input
    if ff.encodings_agree(*packs):
        x = posenc(pts, ct.pos_enc, ct.pos_enc_basis, window=window)
        shared = torch.cat([x, pt["latents"][phases]], -1)
        shared = torch.cat([shared, torch.zeros(N_POINTS, -shared.shape[1] % 8)], -1)
    assert (shared is None) == (cs.pos_enc == "fourier")
    for params, cfg, latent, pk in ((ps, cs, False, packs[0]), (pt, ct, True, packs[1])):
        x = posenc(pts, cfg.pos_enc, cfg.pos_enc_basis, window=window,
                   fourier_coefficients=params.get("fourier"))
        if latent:
            x = torch.cat([x, params["latents"][phases]], -1)
        with torch.no_grad():
            got = emulate_field(params, cfg, pk, x)
            if shared is not None:
                if not latent:  # the static input layer's last k-step holds latents
                    k = -(-x.shape[1] // 8) * 8
                    assert k > x.shape[1] and bool((shared[:, x.shape[1]:k] != 0).any())
                same = emulate_field(params, cfg, pk, shared)
                assert torch.equal(same.view(torch.int32), got.view(torch.int32))
            if latent:
                want = ff.apply_temporal_field(params, pts[None], phases[None], cfg,
                                               window=window)[0, :, 0]
            else:
                want = ff.apply_static_field(params, pts[None], cfg, window=window)[0, :, 0]
        assert got.shape == want.shape and torch.isfinite(got).all()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= RAW_REL * max(scale, 1.0), cfg


def test_emulation_sees_a_wrong_slot_order():
    # the comparison above fails when the planes' slots do not follow the
    # fragments' (here: the plain order 0..7)
    ps, _, cs, _ = fields(layers=1)
    pk = pack(ps, cs)
    rng = np.random.default_rng(2)
    pts = torch.tensor(rng.uniform(-0.6, 0.6, (64, 3)), dtype=torch.float32)
    x = posenc(pts, cs.pos_enc, cs.pos_enc_basis, window=torch.ones(12))
    with torch.no_grad():
        want = ff.apply_static_field(ps, pts[None], cs, window=torch.ones(12))[0, :, 0]
        good = emulate_field(ps, cs, pk, x)
        saved = ff.SLOT_INPUT
        try:
            ff.SLOT_INPUT = tuple(range(8))
            planes = ff.wgmma_planes(pk)
        finally:
            ff.SLOT_INPUT = saved
        orig = ff.wgmma_planes
        try:
            ff.wgmma_planes = lambda *a: planes
            bad = emulate_field(ps, cs, pk, x)
        finally:
            ff.wgmma_planes = orig
    assert float((good - want).abs().max()) <= RAW_REL * max(float(want.abs().max()), 1.0)
    assert float((bad - want).abs().max()) > 1e-3 * float(want.abs().max())


def test_pack_has_the_kernel_shapes():
    ps, pt, cs, ct = fields(layers=3)
    for params, cfg in ((ps, cs), (pt, ct)):
        pk = pack(params, cfg)
        assert pk.w0.shape == (cfg.input_features, 128)
        assert pk.wh.shape == (3, 128, 128)
        cut = dataclasses.replace(cfg, num_early_layers=0)
        assert ff.wgmma_planes(ff._Pack(cut, [pk.w0.t(), pk.b0, pk.wo[None], pk.bo],
                                        pk.table, "cpu")).numel() == \
            -(-cfg.input_features // 8) * ff.KSTEP_FLOATS


# When K1 encodes each tile pair once for both fields: train.step's
# same_window_schedule / field_windows on the host, fused_field's
# encodings_agree on the packs.

COMPOSITE = Path(__file__).resolve().parents[1] / "configs" / "composite.txt"


def composite_cfgs():
    from nerfca_tpu_torch.train.config import parse_args
    from nerfca_tpu_torch.train.trainer import field_configs_from_args

    return field_configs_from_args(parse_args(["--config", str(COMPOSITE)]))


@pytest.mark.parametrize("step", [0, 75000, 150000])
def test_composite_pair_shares_its_encoding(step):
    from nerfca_tpu_torch.train.step import field_window, field_windows, same_window_schedule

    cfgs = composite_cfgs()
    cs, ct = cfgs["static"], cfgs["temp"]
    assert same_window_schedule(cs, ct)
    assert torch.equal(field_window(cs, step), field_window(ct, step))
    windows = field_windows(cfgs, step)
    assert windows["temp"] is windows["static"]
    assert torch.equal(windows["static"], field_window(cs, step))
    ps, pt = init_static_field(prng.key(0), cs, "cpu"), init_temporal_field(prng.key(1), ct, "cpu")
    packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, windows[k]), "cpu")
             for p, c, k in ((ps, cs, "static"), (pt, ct, "temp"))]
    assert ff.encodings_agree(*packs)
    # the same values in two tensors are not taken for one window
    other = ff._Pack(ct, ff._leaves(pt), windows["temp"].clone(), "cpu")
    assert not ff.encodings_agree(packs[0], other)
    assert not ff.encodings_agree(packs[0], None)


@pytest.mark.parametrize("change", [
    dict(pos_enc="fourier", fourier_sigma=2.0), dict(pos_enc_basis=10),
    dict(pos_enc_window_decay_steps=100000), dict(pos_enc_window_start=2),
    dict(pos_enc_window_max=6.0), dict(pos_enc="nerfies_windowed")],
    ids=["fourier", "basis", "decay", "start", "max", "kind"])
def test_other_encodings_take_per_field_units(change):
    from nerfca_tpu_torch.train.step import field_window, field_windows, same_window_schedule

    cfgs = composite_cfgs()
    cfgs["temp"] = dataclasses.replace(cfgs["temp"], **change)
    cs, ct = cfgs["static"], cfgs["temp"]
    assert not same_window_schedule(cs, ct)
    windows = field_windows(cfgs, 75000)
    assert windows["temp"] is not windows["static"] or windows["temp"] is None
    want = field_window(ct, 75000)
    assert (windows["temp"] is None) == (want is None)
    if want is not None:
        assert torch.equal(windows["temp"], want)
    ps, pt = init_static_field(prng.key(0), cs, "cpu"), init_temporal_field(prng.key(1), ct, "cpu")
    packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, windows[k]), "cpu")
             for p, c, k in ((ps, cs, "static"), (pt, ct, "temp"))]
    assert not ff.encodings_agree(*packs)


def test_open_windows_are_one_window():
    # every band open (no window given) in both fields is one encoding
    ps, pt, cs, ct = fields()
    assert ff.encodings_agree(pack(ps, cs), pack(pt, ct))
    ps, pt, cs, ct = fields(enc="none", basis=0)
    assert ff.encodings_agree(pack(ps, cs), pack(pt, ct))
    # the one-field launch and a static field with latents never share
    assert not ff.encodings_agree(pack(ps, cs), None)
    assert not ff.encodings_agree(pack(pt, ct), pack(pt, ct))
