"""The hash-field kernel (``csrc/hash_field.cu``) on the card: against its
torch twin and the plain field at the benchmark cell's shapes, and the
static method's eval view of NAF's field as a CUDA graph. Imports torch
only, so it runs on the machine with the card without this directory's
conftest:

    python -m pytest --noconftest -o "markers=gpu: needs a CUDA device" tests/test_torch_hash_gpu.py -q

On a machine without CUDA every test skips itself."""

import pytest
import torch

from nerfca_tpu_torch.ops.cuda import fused_train as ft
from nerfca_tpu_torch.ops.cuda import hash_field as hf
from nerfca_tpu_torch.ops.cuda.fused_field import plain_static_field_rays

CELL = "naf-hash-render"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hash-field kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def cell_setup(dev, seed: int) -> dict:
    """The cell's views, depths and weights, as ``portbench/`` sets them up."""
    from portbench import harness
    from portbench.mixes import hash_render

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell_files(bench, CELL)
    return hash_render.setup(cfg, traffic, seed, dev)


def rays(su: dict, v: int, rows: slice = slice(None)) -> tuple:
    view = su["views"][v]
    return view["origins"][rows].contiguous(), view["directions"][rows].contiguous()


def check_hash_view(dev, seed: int = 3_000_000_111, tile: int = 4096) -> dict:
    """The kernel on a whole test view of the cell (40000 rays x 192
    depths in ``tile``-ray launches, the table drawn U(-1, 1)) against the
    plain field on the same inputs, within 4e-6 of the view's largest raw
    density. Returns the gap and that scale; raises on a disagreement."""
    su = cell_setup(dev, seed)
    p, cfg, z = su["params"]["static"], su["fields"]["static"], su["z"]
    o, d = rays(su, int(su["order"][0]))
    field = hf.HashFieldRays(p, cfg, tile)
    gap = scale = 0.0
    for s in range(0, o.shape[0], tile):
        ot, dt = o[s:s + tile].contiguous(), d[s:s + tile].contiguous()
        raw = field(ot, dt, z)
        plain = plain_static_field_rays(p, ot, dt, z, cfg, None)[..., 0]
        gap = max(gap, float((raw - plain).abs().max()))
        scale = max(scale, float(raw.abs().max()))
    if not gap <= 4e-6 * scale:
        raise AssertionError(f"hash-field kernel vs the plain field: {gap:.3e} > 4e-6 x {scale:.3e}")
    return {"gap": gap, "scale": scale}


@pytest.mark.gpu
def test_kernel_matches_the_plain_field_on_a_whole_view(dev):
    # every tile of a view, 10 launches
    before = hf.LAUNCHES["hash_field.kernel"]
    check_hash_view(dev)
    assert hf.LAUNCHES["hash_field.kernel"] == before + 10


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [3_000_000_101, 3_000_000_102])
@pytest.mark.parametrize("rows", [slice(0, 4096), slice(38000, 40000), slice(17, 40)])
def test_kernel_matches_its_twin_and_the_plain_field(dev, seed, rows):
    # full, partial and odd tiles of a test view at the cell's 192 depths:
    # the twin's fmaf chains reproduce the kernel's (f64 double rounding
    # may miss a tie), the plain field's matmuls sum in another order
    su = cell_setup(dev, seed)
    p, cfg, z = su["params"]["static"], su["fields"]["static"], su["z"]
    o, d = rays(su, 0, rows)
    before = hf.LAUNCHES["hash_field.kernel"]
    raw = hf.HashFieldRays(p, cfg, 4096)(o, d, z)
    assert hf.LAUNCHES["hash_field.kernel"] == before + 1
    scale = float(raw.abs().max())
    sub = torch.arange(0, o.shape[0], max(1, o.shape[0] // 48), device=dev)
    twin = hf.twin_hash_field_rays(p, o[sub], d[sub], z, cfg)
    assert float((raw[sub] - twin).abs().max()) <= 1e-6 * scale
    assert float((raw[sub] == twin).float().mean()) >= 0.999
    plain = plain_static_field_rays(p, o, d, z, cfg, None)[..., 0]
    assert float((raw - plain).abs().max()) <= 4e-6 * scale


@pytest.mark.gpu
def test_kernel_encoding_is_the_plain_encoding(dev):
    # with the MLP an identity on the first feature (one path of exact
    # products by 1 and sums with 0), the raw density is the encoding's
    # first feature: bitwise the plain encoding's
    from nerfca_tpu_torch.ops.encoding import hash_encode

    su = cell_setup(dev, 3_000_000_103)
    p = {k: v for k, v in su["params"]["static"].items()}
    eye = torch.zeros(32, 32, device=dev)
    eye[0, 0] = 1.0
    zero = torch.zeros(32, device=dev)
    p["early"] = [{"w": eye.clone(), "b": zero.clone()}, {"w": eye.clone(), "b": zero.clone()}]
    p["skip"] = {"w": torch.cat([torch.zeros(32, 32, device=dev), eye], 1), "b": zero.clone()}
    p["out"] = {"w": eye[:1].clone(), "b": torch.zeros(1, device=dev)}
    cfg, z = su["fields"]["static"], su["z"]
    o, d = rays(su, 2, slice(0, 512))
    raw = hf.HashFieldRays(p, cfg, 512)(o, d, z)
    pts = (o[:, None, :] + d[:, None, :] * z[None, :, None]).reshape(-1, 3)
    first = hash_encode(pts, p["table"], cfg.hash_bound)[:, 0].reshape(raw.shape)
    keep = first > 0  # LeakyReLU scales the negatives
    assert keep.any() and torch.equal(raw[keep], first[keep])


@pytest.mark.gpu
def test_naf_views_replay_as_graphs_on_the_hash_kernel(dev):
    # three views: one capture, two replays, no eager view; 10 hash-field
    # launches and 10 Beer-Lambert launches a view, none on the plain
    # path; each replay bitwise the eager body's view
    from nerfca_tpu_torch.train import evaluation

    su = cell_setup(dev, 3_000_000_107)
    counters = (hf.LAUNCHES, ft.LAUNCHES)
    before = [dict(c) for c in counters]
    views = [int(su["order"][i]) for i in range(3)]
    got = []
    for v in views:
        view = su["views"][v]
        got.append(evaluation.render_test_view(
            su["params"], view["origins"], view["directions"], None, su["z"], su["step"],
            su["fields"], su["hp"], su["i0"], tile=su["tile"]))
    made = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c}
    assert (made["eval_view.capture"], made["eval_view.replay"], made["eval_view.eager"]) == (
        1, 2, 0), made
    assert made["hash_field.kernel"] == made["eval_static.kernel"] == 30, made
    assert made["hash_field.plain_views"] == 0 and made["eval_composite.torch"] == 0, made
    for v, out in zip(views[1:], got[1:]):
        view = su["views"][v]
        eager = evaluation._render_view(
            su["params"], view["origins"], view["directions"], None, [("", su["z"])],
            {"static": None}, su["fields"], su["hp"], su["tile"], None, su["i0"])
        assert set(out) == set(eager)
        for k in eager:
            assert torch.equal(out[k], eager[k]), k
