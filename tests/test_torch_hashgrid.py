"""NAF's hash-grid attenuation field in the port, on the CPU: the
``hashgrid`` encoding and the field against the benchmark's plain reference
(``portbench/reference/hash_render.py``) at the published sizes, on seeded
points, points on cell faces, on the dense/hashed level edge and outside
the box; the hash-field kernel's torch twin against the plain field; the
static method's eval view of the field against the reference's image;
``run_nerf`` steps of ``configs/naf.txt``'s field with a checkpoint round
trip; the program's hash constants against the configuration file. The
kernel itself is held against its twin on the card
(``tests/test_torch_hash_gpu.py``)."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses
import json
import math
import os
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import encoding as te
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import hash_field as hf
from nerfca_tpu_torch.ops.cuda.fused_field import plain_static_field_rays
from nerfca_tpu_torch.train import checkpoint as tck
from nerfca_tpu_torch.train import config as tcfg
from nerfca_tpu_torch.train import evaluation, run_nerf
from nerfca_tpu_torch.train import step as ts
from nerfca_tpu_torch.train import trainer as ttr
from portbench.metrics import hash_roofline
from portbench.reference import hash_render as reference

REPO = Path(__file__).resolve().parents[1]
NAF = str(REPO / "configs" / "naf.txt")
CFG = json.loads((REPO / "portbench" / "configs" / "naf-hashgrid.json").read_text())
BOUND = 0.64
FIELD = tf.FieldConfig(num_early_layers=1, num_late_layers=1, num_filters=32,
                       pos_enc="hashgrid", hidden_activation="leaky_relu", hash_bound=BOUND)


def naf_params(seed: int, out_scale: float = 30.0, out_bias: float = -2.5) -> dict:
    """The port's NAF field from the seed, the table spread over
    U(-1, 1) as a trained table's, the output layer scaled as the
    benchmark's traffic scales it."""
    p = tf.init_static_field(prng.key(seed), FIELD)
    g = torch.Generator().manual_seed(seed)
    p["table"] = torch.rand(p["table"].shape, generator=g) * 2 - 1
    p["out"]["w"] = p["out"]["w"] * out_scale
    p["out"]["b"] = p["out"]["b"] + out_bias
    return p


def reference_params(p: dict) -> dict:
    return {"layers": [*p["early"], p["skip"], p["out"]], "table": p["table"]}


def points(kind: str, n: int = 300, seed: int = 0) -> torch.Tensor:
    """``n`` points of one kind, in the cube of half extent ``BOUND``
    unless ``outside``."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 3, generator=g)
    if kind == "faces":
        # u = k / N_l exactly, for a level's N_l: x + b over 2b is the
        # f32 value k / N_l, so pos = u N_l lands on a cell face
        res = torch.tensor(te.HASH_RES)[torch.randint(0, te.HASH_LEVELS, (n, 3), generator=g)]
        k = torch.floor(u * (res + 1).float())
        u = k / res.float()
        u[: n // 10] = 1.0  # the far face: the last cell, f = 1
        u[n // 10: n // 5] = 0.0
    elif kind == "level_edge":
        # the last dense level and the first hashed one: cells at the top
        # of the grid, whose corners reach N_l
        res = float(te.HASH_RES[4 if seed % 2 == 0 else 5])
        u = 1.0 - torch.rand(n, 3, generator=g) / res
    x = (u * 2 - 1) * BOUND
    if kind == "outside":
        x = x * 1.5 + torch.sign(x) * 0.1
    return x.float()


def test_hash_constants_are_the_configuration_files():
    assert (te.HASH_LEVELS, te.HASH_FEATURES, te.HASH_LOG2_T, te.HASH_N_MIN, te.HASH_N_MAX) == (
        CFG["hash_levels"], CFG["hash_features_per_level"], CFG["hash_log2_table_size"],
        CFG["hash_base_resolution"], CFG["hash_finest_resolution"])
    assert te.HASH_PRIMES == reference.PRIMES
    lv = reference.levels(CFG)
    assert te.HASH_RES == tuple(r[0] for r in lv)
    assert te.HASH_DENSE == tuple(r[1] for r in lv)
    assert te.HASH_ENTRIES == tuple(r[2] for r in lv)
    assert te.HASH_OFFSETS == tuple(r[3] for r in lv)
    assert te.HASH_TABLE_ENTRIES == reference.table_entries(CFG) == 6_098_944
    assert te.HASH_RES[0] == 16 and te.HASH_RES[-1] == 2048
    assert te.HASH_DENSE == (True,) * 5 + (False,) * 11
    assert tf.LEAKY_SLOPE == CFG["static_leaky_slope"]
    port = CFG["port_field"]
    cfg = tcfg.parse_args(["--config", NAF])
    assert (cfg.static_pos_enc, cfg.static_hidden_activation, cfg.static_num_early_layers,
            cfg.static_num_late_layers, cfg.static_num_filters) == (
        port["static_pos_enc"], port["static_hidden_activation"],
        port["static_num_early_layers"], port["static_num_late_layers"],
        port["static_num_filters"])
    assert cfg.depth_samples_per_ray_coarse == CFG["depth_samples_per_ray_coarse"]
    assert cfg.output_activation == CFG["output_activation"] == "sigmoid"
    assert (cfg.img_sample_size, cfg.lr) == (CFG["img_sample_size"], CFG["lr"])
    # NAF's 4,128 multiply-adds a point, as the benchmark counts them and
    # as the port's layers hold them
    p = tf.init_static_field(prng.key(0), FIELD)
    macs = sum(t.numel() for n, t in ts.param_items({"s": p}) if n.endswith("/w"))
    assert hash_roofline.mlp_macs(CFG) == macs == 4128
    assert FIELD.encoded_features == 32 and hf.kernel_supported(FIELD)


@pytest.mark.parametrize("kind", ["seeded", "faces", "level_edge", "outside"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_encoding_and_field_match_the_reference(kind, seed):
    p = naf_params(seed)
    x = points(kind if kind != "seeded" else "", seed=seed)
    enc = te.hash_encode(x, p["table"], BOUND)
    assert torch.equal(enc, reference.encode(x, p["table"], CFG, BOUND))
    raw = tf.apply_static_field(p, x, FIELD)[..., 0]
    want = reference.field(reference_params(p), CFG, x, BOUND, tf32=False)
    assert torch.allclose(raw, want, rtol=0, atol=1e-6 * float(want.abs().max()))


def test_level_edges_stay_inside_their_levels():
    # the far face's corners index the last entry of a dense level, and a
    # hashed level's indices stay under T: no level reads another's
    for n, dense, entries in zip(te.HASH_RES, te.HASH_DENSE, te.HASH_ENTRIES):
        top = (n + 1) ** 3 - 1 if dense else 2 ** te.HASH_LOG2_T - 1
        assert top < entries
    table = torch.zeros(te.HASH_TABLE_ENTRIES, 2)
    table[te.HASH_OFFSETS[4] + (te.HASH_RES[4] + 1) ** 3 - 1, 0] = 1.0
    enc = te.hash_encode(torch.full((1, 3), BOUND), table, BOUND)
    assert enc[0, 8].item() == 1.0 and enc[0].abs().sum().item() == 1.0


def test_the_encoding_reaches_only_the_table():
    p = naf_params(3)
    table = p["table"].clone().requires_grad_(True)
    x = points("", 50, 3).requires_grad_(True)
    te.hash_encode(x, table, BOUND).sum().backward()
    assert x.grad is None
    rows = (table.grad != 0).any(-1).sum().item()
    assert 0 < rows <= 50 * te.HASH_LEVELS * 8


def test_twin_matches_the_plain_field():
    p = naf_params(4)
    g = torch.Generator().manual_seed(4)
    o = torch.tensor([0.0, 0.0, -4.5]) + 0.05 * torch.randn(20, 3, generator=g)
    d = torch.tensor([0.0, 0.0, 1.0]) + 0.15 * torch.randn(20, 3, generator=g)
    z = torch.sort(3.6 + 1.8 * torch.rand(64, generator=g)).values
    twin = hf.twin_hash_field_rays(p, o, d, z, FIELD)
    plain = plain_static_field_rays(p, o, d, z, FIELD, None)[..., 0]
    assert torch.allclose(twin, plain, rtol=0, atol=2e-6 * float(plain.abs().max()))


@pytest.mark.parametrize("tile", [4096, 96])
def test_eval_view_matches_the_reference(tile):
    from portbench import geometry, inputs

    p = naf_params(5)
    acq = geometry.acquisition(50)
    o, d = geometry.view_rays(90, 0, acq, "cpu")
    z = inputs.eval_depths(acq, 48, 5, "cpu")
    hp = ts.StaticHParams(depth_samples_coarse=48, output_activation="sigmoid", use_pallas=True)
    i0 = math.log(geometry.MAX_PIXEL_VALUE)
    before = hf.LAUNCHES["hash_field.plain_views"]
    out = evaluation.render_test_view({"static": p}, o, d, None, z, 0, {"static": FIELD}, hp,
                                      i0, tile=tile)
    assert hf.LAUNCHES["hash_field.plain_views"] == before + 1
    pix, sigma = reference.render_view(reference_params(p), CFG, {"origins": o, "directions": d},
                                       z, i0, BOUND)
    assert float(sigma.min()) < 0.05 and float(sigma.max()) > 0.95
    assert torch.allclose(out["static_sigma"], sigma, rtol=0, atol=1e-6)
    atten = float((i0 - pix).abs().max())
    assert float((out["pix_static"] - pix[0]).abs().max()) <= 1e-5 * atten


# a 50 x 50 single-phase SYNTH build, 48 samples, 64 rays a step
TINY = ["--config", NAF, "--data_size", "50", "--synth_vol_size", "20",
        "--data_step_size", "120", "--data_numb_angles", "4",
        "--depth_samples_per_ray_coarse", "48", "--img_sample_size", "64",
        "--steps_per_chunk", "2", "--n_iters", "1", "--display_every", "2",
        "--save_every", "2", "--log_every", "1", "--platform", "cpu", "--use_pallas", "true"]


def test_run_nerf_trains_the_naf_field_and_round_trips_it(tmp_path):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = run_nerf.main([*TINY, "--data_root", str(tmp_path / "data"),
                             "--log_dir_root", str(tmp_path / "cases")])
    assert any("hashgrid field trains on the plain" in str(w.message) for w in caught)
    assert out["final_step"] == 2 and out["state"].step == 2
    with open(os.path.join(out["log_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert any("test_image_psnr" in r for r in rows)
    cfg = out["setup"]["cfg"]
    assert cfg.pos_enc == "hashgrid" and cfg.hidden_activation == "leaky_relu"
    assert cfg.hash_bound > 0
    # the table trained: Adam moved rows the batch's points read
    init = tf.init_static_field(prng.key(0), cfg)
    table = out["state"].params["static"]["table"]
    assert 0 < int((table != init["table"]).any(-1).sum()) < table.shape[0]
    # the checkpoint holds the table and the config, and restores both
    ckpt = os.path.join(out["log_dir"], "checkpoint-2")
    assert tck.load_field_configs(ckpt)["static"] == cfg
    example = ts.TrainState(params={"static": init}, opt_state=ts.init_opt_state(
        {"static": init}), step=0, rng=prng.key(1))
    back = tck.load_checkpoint(ckpt, example)
    for (n, a), (_, b) in zip(ts.param_items(back.params), ts.param_items(out["state"].params)):
        assert torch.equal(a, b), n
    assert back.step == 2
    assert torch.equal(back.opt_state["mu"][-1], out["state"].opt_state["mu"][-1])


def test_metadata_keeps_the_port_only_keys_off_relu_fields(tmp_path):
    relu = tf.FieldConfig()
    p = {"static": tf.init_static_field(prng.key(0), dataclasses.replace(relu, num_filters=8))}
    state = ts.TrainState(params=p, opt_state=ts.init_opt_state(p), step=0, rng=prng.key(0))
    tck.save_checkpoint(str(tmp_path / "a"), state, {"static": relu, "naf": FIELD})
    with open(tmp_path / "a" / "metadata.json") as f:
        meta = json.load(f)["field_configs"]
    assert not set(tf.PORT_ONLY_DEFAULTS) & set(meta["static"])
    assert meta["naf"]["hidden_activation"] == "leaky_relu" and meta["naf"]["hash_bound"] == BOUND
    assert tck.load_field_configs(str(tmp_path / "a")) == {"static": relu, "naf": FIELD}


def test_flags_and_the_kernel_path_choice():
    args = tcfg.parse_args(["--static_pos_enc", "hashgrid", "--static_hidden_activation",
                            "leaky_relu", "--static_num_filters", "32",
                            "--static_num_early_layers", "1", "--static_num_late_layers", "1"])
    cfg = dataclasses.replace(ttr.static_config_from_args(args), hash_bound=BOUND)
    assert cfg == FIELD
    defaults = vars(tcfg.parse_args([]))
    assert {k: defaults[k] for k in tcfg.PORT_ONLY_FLAGS} == tcfg.PORT_ONLY_FLAGS
    hp = ts.StaticHParams(use_pallas=True)
    with pytest.warns(UserWarning, match="hashgrid field trains on the plain"):
        assert ttr.resolve_pallas_support(hp, cfg) is hp
    # a hash field outside the kernel's envelope: the plain path throughout
    for bad in (dict(hidden_activation="relu"), dict(num_filters=64), dict(hash_bound=0.0)):
        other = dataclasses.replace(cfg, **bad)
        assert not hf.kernel_supported(other)
        with pytest.warns(UserWarning, match="envelope"):
            assert not ttr.resolve_pallas_support(hp, other).use_pallas
    # only the static method's one field takes the hash kernel, in f32, and
    # only on CUDA tensors (the check reads the rays' device alone)
    cpu = torch.zeros(4, 3)
    assert not evaluation.composite_on_kernel(cpu, {"static": cfg}, hp)
    card = SimpleNamespace(device=torch.device("cuda"))
    assert evaluation.composite_on_kernel(card, {"static": cfg}, hp)
    bf16 = dataclasses.replace(hp, compute_dtype="bfloat16")
    assert not evaluation.composite_on_kernel(card, {"static": cfg}, bf16)
    assert not evaluation.composite_on_kernel(card, {"static": cfg, "temp": cfg},
                                              ts.CompositeHParams(use_pallas=True))
    info = {"nVoxel": [20, 20, 20], "dVoxel": [0.064, 0.064, 0.064], "offOrigin": [0, 0, 0]}
    assert ttr.volume_half_extent(info) == pytest.approx(0.64)
    with pytest.raises(ValueError, match="half extent"):
        te.hash_encode(cpu, torch.zeros(te.HASH_TABLE_ENTRIES, 2), 0.0)
