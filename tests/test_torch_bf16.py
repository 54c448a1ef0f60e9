"""bf16 compute and bf16 residual storage in the torch port, against the JAX
package on the same numpy inputs: the plain bf16 fields against JAX's
(``apply_*_field(compute_dtype=jnp.bfloat16)``), the kernels' bf16 twin
against JAX's Pallas entries in interpret mode (ray form, point form,
static field, fourier), K3 under bf16 compute and bf16 residuals against
``fused_train_loss_and_grads``, and one composite step and eval on the
plain, two-kernel and fused paths. The CUDA kernels themselves are held
against the twin on the card by ``tests/test_torch_gpu.py``.

The two JAX bf16 paths round at different points: autodiff through the
plain fields' ``astype`` rounds every weight gradient to bf16, while the
Pallas kernel's backward (``_field_bwd``) returns f32 gradients and rounds
``g``, ``dpre`` and ``h`` at each product. On the 4 x 64-point pair below
the two differ by 6.2e-3 of a leaf's scale and bf16 differs from f32 by
2.0e-2; each tolerance here is stated against those gaps."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfca_tpu.ops.pallas.fused_field as jff
from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.pallas.fused_train import fused_train_loss_and_grads as jax_k3
from nerfca_tpu.train import evaluation as jev
from nerfca_tpu.train import step as js
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops import prng
from nerfca_tpu_torch.ops.cuda import fused_field as tff
from nerfca_tpu_torch.train import evaluation as tev
from nerfca_tpu_torch.train import step as ts
from tests.test_torch_fused_field import loss_j, setup
from tests.test_torch_fused_train import run_both as k3_both
from tests.test_torch_step import (
    HULL_L1, assert_grads_match, assert_metrics_match, cfgs, grads_as_jax, hparams, hulls,
    problem, torch_params,
)

BF16 = "bfloat16"
# Both sides take bf16 operands and f32 sums, so only the f32 summation
# order, and the rare bf16 rounding of a hidden activation that it flips,
# separate them. Such a flip moves its point's output by up to ~2e-3 of
# the output's scale (1.9e-3 at the flagship shapes) and leaves the others
# alone, so the forward is held by its mean: mean |difference| within 5e-5
# of the mean |output| (measured up to 5.6e-6; bf16 moves it by 8.5e-4 to
# 1.5e-2), and no point beyond 2e-3 of scale. Gradients sum over the N
# points: one bf16 operand that the summation order flips at one point
# moves a leaf by ~2^-8 |g h| / |leaf|, ~1e-3 of its scale at N = 256
# (measured 1.6e-3 on one seed of six) and ~4e-4 at N = 1024, so the
# gradient checks take 1024 points a field and hold each leaf within 6e-4
# of its scale (measured <= 1.2e-5 over six seeds), 10x under the 6.2e-3
# Pallas-vs-plain gap.
FWD_MAE = 5e-5
FWD_MAX = 2e-3
GRAD_REL = 6e-4
R, S = 4, 256  # rays and samples of the field checks: 1024 points a field
R_STEP, S_STEP = 8, 128  # of the step and K3 checks


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jff, "_INTERPRET", True)


def bf16_exact(a) -> bool:
    a = np.asarray(a, np.float32)
    return np.array_equal(a, torch.tensor(a).to(torch.bfloat16).float().numpy())


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def assert_fwd(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).mean() <= FWD_MAE * np.abs(want).mean()
    assert rel_err(got, want) <= FWD_MAX


def leaf_rel(got, want) -> float:
    """Worst leaf's max-abs difference as a share of that leaf's scale."""
    return max(rel_err(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                             jax.tree_util.tree_leaves(want)))


def torch_run(c, fn, *extra, point_form=False):
    """Outputs and the gradients (JAX layout) of ``loss_j`` through the port's
    ``fn`` on the setup ``c``."""
    tps, tpt = tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"])
    leaves = [x for tree in (tps, tpt) for k, x in _named(tree) if k != "fourier"]
    for x in leaves:
        x.requires_grad_(True)
    w = None if c["w"] is None else torch.tensor(c["w"])
    o, d, z, ph = (torch.tensor(c[k]) for k in ("o", "d", "z", "ph"))
    if point_form:
        pts = o[:, None] + d[:, None] * z[..., None]
        rs, rt = fn(tps, tpt, pts, ph[:, None].expand(pts.shape[:2]), c["ts"], c["tt"], w, w,
                    *extra)
    else:
        rs, rt = fn(tps, tpt, o, d, z, ph, c["ts"], c["tt"], w, w, *extra)
    torch.sum(torch.sin(rs) * 0.3 + rt ** 2).backward()

    def grad_tree(tree):
        return tf.params_to_jax({k: (v if k == "fourier" else _grad(v)) for k, v in tree.items()})

    return (rs.detach().numpy(), rt.detach().numpy()), (grad_tree(tps), grad_tree(tpt))


def _named(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from ((k, x) for _, x in _named(v))
        elif isinstance(v, list):
            for layer in v:
                yield from ((k, x) for _, x in _named(layer))
        else:
            yield k, v


def _grad(v):
    if isinstance(v, dict):
        return {k: _grad(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_grad(x) for x in v]
    return v.grad


def jax_pallas(c, ps, pt, point_form=False):
    w = None if c["w"] is None else jnp.asarray(c["w"])
    o, d, z, ph = (jnp.asarray(c[k]) for k in ("o", "d", "z", "ph"))
    if point_form:
        pts = o[:, None] + d[:, None] * z[..., None]
        return jff.fused_composite_fields(ps, pt, pts, jnp.broadcast_to(ph[:, None], z.shape),
                                          c["js"], c["jt"], w, w, tile=128, compute_dtype=BF16)
    return jff.fused_composite_fields_rays(ps, pt, o, d, z, ph, c["js"], c["jt"], w, w,
                                           tile=128, compute_dtype=BF16)


def jax_plain(c, ps, pt, dtype):
    w = None if c["w"] is None else jnp.asarray(c["w"])
    pts = jnp.asarray(c["o"])[:, None] + jnp.asarray(c["d"])[:, None] * jnp.asarray(c["z"])[..., None]
    php = jnp.broadcast_to(jnp.asarray(c["ph"])[:, None], pts.shape[:2])
    return (jf.apply_static_field(ps, pts, c["js"], window=w, compute_dtype=dtype),
            jf.apply_temporal_field(pt, pts, php, c["jt"], window=w, compute_dtype=dtype))


def jax_grads(fn, c):
    return jax.grad(lambda a, b: loss_j(fn(a, b)), argnums=(0, 1))(c["ps"], c["pt"])


def without_fourier(trees):
    return tuple({k: v for k, v in t.items() if k != "fourier"} for t in trees)


@pytest.mark.parametrize("enc,basis", [("free_windowed", 4), ("fourier", 4)])
def test_plain_bf16_fields_match_jax(enc, basis):
    # forward as assert_fwd; gradients within one bf16 ulp (2^-8)
    # of each leaf's scale (both round every weight and activation
    # gradient to bf16, so a last-bit difference of the f32 sum may move
    # an element by one ulp); the port's weight gradients bf16-exact
    # exactly where JAX's are (every w leaf)
    c = setup(R, S, basis=basis, layers=2, enc=enc)
    (ts_, tt_), tg = torch_run(c, tff.plain_composite_fields_rays, BF16)
    js_, jt_ = jax_plain(c, c["ps"], c["pt"], jnp.bfloat16)
    assert_fwd(ts_, js_)
    assert_fwd(tt_, jt_)
    jg = jax_grads(lambda a, b: jax_plain(c, a, b, jnp.bfloat16), c)
    tg, jg = without_fourier(tg), without_fourier(jg)
    assert leaf_rel(tg, jg) <= 2.0 ** -8
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(tg)):
        assert bf16_exact(a) == bf16_exact(b), path
        assert bf16_exact(a) or path[-1].key != "w", path


def test_plain_bf16_differs_from_f32():
    # the comparison above is not vacuous: bf16 moves the forward by more
    # than 1e-3 of scale and the gradients by more than 5e-3
    c = setup(4, 64, basis=4, layers=2)
    (bs, bt), bg = torch_run(c, tff.plain_composite_fields_rays, BF16)
    (fs, ft), fg = torch_run(c, tff.plain_composite_fields_rays)
    assert max(rel_err(bs, fs), rel_err(bt, ft)) > 1e-3
    assert leaf_rel(bg, fg) > 5e-3


@pytest.mark.parametrize("form,enc,basis,layers", [
    ("rays", "free_windowed", 4, 2), ("rays", "fourier", 4, 2), ("rays", "none", 0, 1),
    ("points", "free_windowed", 4, 2)])
def test_twin_matches_pallas_interpret(form, enc, basis, layers):
    # the bf16 entries on CPU tensors (the kernels' twin, whose backward
    # mirrors _field_bwd) against JAX's Pallas bf16 entries: assert_fwd and
    # GRAD_REL; the twin's gradients stay f32 (not bf16-rounded), as the
    # kernel's do
    c = setup(R, S, basis=basis, layers=layers, enc=enc, seed=2)
    pf = form == "points"
    entry = tff.fused_composite_fields if pf else tff.fused_composite_fields_rays
    (ts_, tt_), tg = torch_run(c, entry, BF16, point_form=pf)
    js_, jt_ = jax_pallas(c, c["ps"], c["pt"], point_form=pf)
    assert_fwd(ts_, js_)
    assert_fwd(tt_, jt_)
    jg = jax_grads(lambda a, b: jax_pallas(c, a, b, point_form=pf), c)
    tg, jg = without_fourier(tg), without_fourier(jg)
    assert leaf_rel(tg, jg) <= GRAD_REL
    w_leaves = [a for (p, _), a in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                       jax.tree_util.tree_leaves(tg)) if p[-1].key == "w"]
    assert not all(bf16_exact(a) for a in w_leaves)


@pytest.mark.parametrize("enc", ["free_windowed", "fourier"])
def test_static_twin_matches_pallas_interpret(enc):
    # fused_static_field in bf16: JAX runs the pair with a zero temporal
    # field; forward and gradients as above
    c = setup(R, S, basis=4, layers=2, enc=enc, seed=5)
    pts = c["o"][:, None] + c["d"][:, None] * c["z"][..., None]
    w = None if c["w"] is None else jnp.asarray(c["w"])
    jout, jvjp = jax.vjp(lambda p: jff.fused_static_field(p, jnp.asarray(pts), c["js"], w,
                                                          tile=128, compute_dtype=BF16), c["ps"])
    cot = np.random.default_rng(1).normal(size=jout.shape).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(cot))
    tp = tf.params_from_jax(c["ps"])
    for k, x in _named(tp):
        if k != "fourier":
            x.requires_grad_(True)
    out = tff.fused_static_field(tp, torch.tensor(pts), c["ts"],
                                 None if c["w"] is None else torch.tensor(c["w"]), BF16)
    (out * torch.tensor(cot)).sum().backward()
    assert_fwd(out.detach().numpy(), jout)
    tg = tf.params_to_jax({k: _grad(v) for k, v in tp.items() if k != "fourier"})
    assert leaf_rel(tg, without_fourier([jg])[0]) <= GRAD_REL


@pytest.mark.parametrize("res_bf16", [False, True])
def test_twin_backward_casts_as_field_bwd(res_bf16):
    # the twin's backward against a transcription of _field_bwd's cast
    # points (dwo = r(g) r(hL); dh = r(wo) r(g); dW = r(dpre) r(h); dh =
    # r(W)^T r(dpre); dW1 = r(dpre1) r(enc); bias sums of the uncast dpre)
    # on one field, written out in f32. With bf16 residuals (f32 products)
    # r is the identity and the stored h are rounded instead. Within 1e-6
    # of each leaf's scale (f32 summation order)
    rng = np.random.default_rng(0)
    cfg = tf.FieldConfig(num_early_layers=2, num_filters=128, pos_enc="none", pos_enc_basis=0)
    params = tf.init_static_field(prng.key(4), cfg)
    enc = torch.tensor(rng.normal(size=(50, 3)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(50, 1)).astype(np.float32))
    leaves = [x.requires_grad_(True) for x in tff._leaves(params)]
    out = tff._TwinMLP.apply(cfg, not res_bf16, res_bf16, enc, None, *leaves)
    got = torch.autograd.grad((out * g).sum(), leaves)

    def bf(x):
        return x.to(torch.bfloat16).float()

    r = (lambda x: x) if res_bf16 else bf
    ws = [x.detach() for x in leaves[0::2]]
    bs = [x.detach() for x in leaves[1::2]]
    hs, h = [], enc
    for w, b in zip(ws[:-1], bs[:-1]):
        h = torch.relu(r(h) @ r(w).t() + b)
        hs.append(h)
    if res_bf16:
        hs = [bf(h) for h in hs]
    want = [None] * len(leaves)
    want[-2], want[-1] = r(g).t() @ r(hs[-1]), g.sum(0)
    dh = r(ws[-1]) * r(g)
    for l in range(len(hs) - 1, -1, -1):
        dpre = dh * (hs[l] > 0)
        want[2 * l] = r(dpre).t() @ r(enc if l == 0 else hs[l - 1])
        want[2 * l + 1] = dpre.sum(0)
        dh = r(dpre) @ r(ws[l])
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-6 * max(float(b.abs().max()), 1e-30)


def fused_both(hull=False, **kw):
    """JAX's fused-loss step (its K3 in interpret mode) and the port's (the
    plain K3) on one R_STEP x S_STEP batch: (loss, metrics, grads) each."""
    params, batch, z = problem(r=R_STEP, s=S_STEP)
    jh, th = hulls() if hull else (None, None)
    kw = dict(use_pallas=True, use_fused_loss=True, **HULL_L1, **kw)
    jl, jm, jg = js._fused_loss_metrics_grads(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z), jnp.int32(50),
        cfgs(jf), hparams(js, **kw), None, jax_k3, 2, hull=jh)
    tparams = torch_params(params)
    tl, tm, tg = ts._fused_loss_metrics_grads(
        tparams, {k: torch.tensor(v) for k, v in batch.items()}, torch.tensor(z), 50, cfgs(tf),
        hparams(ts, **kw), hull=th)
    return (float(jl), jm, jg), (float(tl), tm, grads_as_jax(tparams, tg))


@pytest.mark.parametrize("kw", [
    dict(compute_dtype=BF16), dict(compute_dtype=BF16, hull=True),
    dict(compute_dtype=BF16, output_activation="sigmoid"),
    dict(pallas_bf16_residuals=True), dict(pallas_bf16_residuals=True, hull=True),
    dict(compute_dtype=BF16, pallas_bf16_residuals=True),
], ids=["bf16", "bf16_hull", "bf16_sigmoid", "res", "res_hull", "bf16_res"])
def test_k3_matches_jax_kernel(kw):
    # K3 through the fused-loss step (the plain K3: the fields' twin under
    # the step's precision) against JAX's (its fused_train_loss_and_grads
    # in interpret mode): the loss and metrics at the f32 step's
    # tolerances, gradients within GRAD_REL of each leaf's scale
    (jl, jm, jg), (tl, tm, tg) = fused_both(**kw)
    assert_metrics_match(jl, jm, tl, tm)
    assert_grads_match(jg, tg, GRAD_REL)


@pytest.mark.parametrize("hull", [None, "random"])
def test_k3_bf16_residuals_keep_the_f32_loss(hull):
    # bf16 residual storage leaves the forward and the loss in f32: the
    # port's loss and every term equal the f32 K3's bit for bit, while the
    # gradients of the weights whose dW reads a stored activation (the hidden
    # and output layers) move by more than 1e-5 of their scale, and the
    # biases', the latents' and the input layer's (which read dpre and the
    # f32 encoding alone) stay within 1e-6 of theirs (f32 summation order)
    (_, tout_f), (_, tout_r) = k3_both(hull=hull), k3_both(
        hp_kw=dict(pallas_bf16_residuals=True), hull=hull)
    assert float(tout_f[0]) == float(tout_r[0])
    for k in tout_f[1]:
        assert float(tout_f[1][k]) == float(tout_r[1][k]), k
    for gf, gr in zip(tout_f[2:], tout_r[2:]):
        for (name, a), (_, b) in zip(ts.param_items({"f": gf}), ts.param_items({"f": gr})):
            rel = float((a - b).abs().max() / a.abs().max())
            reads_h = name.endswith("/w") and not name.startswith("f/early/0/")
            assert rel > 1e-5 if reads_h else rel <= 1e-6, (name, rel)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_composite_step_bf16_matches_jax(use_pallas):
    # one composite loss + gradients with compute_dtype bfloat16 on the
    # plain and two-kernel paths against JAX's on the same batch and depths
    # (the fused path is test_k3_matches_jax_kernel): the metrics at the
    # f32 step's tolerances; the gradients within one bf16 ulp of each
    # leaf's scale on the plain path (both round them to bf16) and within
    # GRAD_REL through the kernels' twin
    params, batch, z = problem(r=R_STEP, s=S_STEP)
    hp_kw = dict(weights="strong", use_pallas=use_pallas, compute_dtype=BF16)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: js.composite_loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(z), jnp.int32(50), cfgs(jf),
                                       hparams(js, **hp_kw)),
        has_aux=True)(params)
    tparams = torch_params(params)
    tloss, tm, tg = ts.composite_grads(tparams, {k: torch.tensor(v) for k, v in batch.items()},
                                       torch.tensor(z), 50, cfgs(tf), hparams(ts, **hp_kw))
    assert_metrics_match(float(jloss), jm, float(tloss), tm)
    assert_grads_match(jg, grads_as_jax(tparams, tg), GRAD_REL if use_pallas else 2.0 ** -8)


def test_eval_render_bf16_matches_jax():
    # render_test_view under bf16 through the ray entry (use_pallas) and
    # the plain fields: the composite intensities within 1e-5 of I0 of
    # JAX's (the render integrates the raw densities held above)
    params, batch, z = problem(r=6, s=40)
    o, d, ph = batch["origins"], batch["directions"], batch["phases"]
    for use_pallas in (False, True):
        jhp = hparams(js, compute_dtype=BF16, use_pallas=use_pallas, pallas_tile=128)
        jr = jev.render_test_view(params, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ph),
                                  jnp.asarray(z), jnp.int32(50), cfgs(jf), jhp, 2.16, tile=6)
        tr = tev.render_test_view(torch_params(params), torch.tensor(o), torch.tensor(d),
                                  torch.tensor(ph), torch.tensor(z), 50, cfgs(tf),
                                  hparams(ts, compute_dtype=BF16, use_pallas=use_pallas), 2.16)
        for k in ("pix", "pix_static", "pix_temp"):
            np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), atol=1e-5 * 2.16,
                                       rtol=0, err_msg=f"{k} use_pallas={use_pallas}")


def static_problem():
    cfg = cfgs(jf)["static"]
    params = {"static": jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(3),
                                                                      cfg))}
    _, batch, z = problem(r=4, s=40)
    return params, batch, z


@pytest.mark.parametrize("use_pallas", [False, True])
def test_static_step_dtype_as_jax(use_pallas):
    # the static method under compute_dtype bfloat16: the plain branch in
    # bf16 and the kernel branch in f32 (JAX passes no dtype to its kernel,
    # nerfca_tpu/train/step.py:843), each matching JAX's loss (rel 1e-5)
    # and gradients (within 1e-3 of scale on the kernel branch, the Pallas
    # interpret mode's f32 tolerance; one bf16 ulp on the plain branch); the
    # kernel branch equals the f32 step bit for bit
    params, batch, z = static_problem()
    jhp = js.StaticHParams(img_sample_size=4, depth_samples_coarse=40, compute_dtype=BF16,
                           use_pallas=use_pallas)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.value_and_grad(
        lambda p: js.static_loss_fn(p, jb, jnp.asarray(z), jnp.int32(50), cfgs(jf)["static"], jhp),
        has_aux=True)(params)
    tparams = torch_params(params)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    thp = ts.StaticHParams(img_sample_size=4, depth_samples_coarse=40, compute_dtype=BF16,
                           use_pallas=use_pallas)
    tl, _, tg = ts.static_grads(tparams, tb, torch.tensor(z), 50, cfgs(tf)["static"], thp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    assert_grads_match(jg, grads_as_jax(tparams, tg), 1e-3 if use_pallas else 2.0 ** -8)
    f32 = ts.static_grads(torch_params(params), tb, torch.tensor(z), 50, cfgs(tf)["static"],
                          dataclasses.replace(thp, compute_dtype="float32"))
    assert (float(f32[0]) == float(tl)) == use_pallas
