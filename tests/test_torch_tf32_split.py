"""K2's arithmetic on the CPU. K2 (``csrc/fused_field.cu::bwd_kernel``) runs
its three matrix products on the tensor cores in 3xTF32: each f32 operand
x is split into big = tf32(x) and small = tf32(x - big), both rounded to
nearest with ties away from zero, and a product is accumulated in f32 as
small*big + big*small + big*big. This file emulates that split in torch,
runs the field backward through it as K2 does (the encoding, the output
layer, the bias sums and the latent cotangent in plain f32) and holds the
result against ``jax.vjp`` of the JAX package's jnp fields."""

from tests import torch_cpu  # noqa: F401 (first: one CPU thread for torch)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfca_tpu.models import fields as jf
from nerfca_tpu.ops.encoding import free_window_mask
from nerfca_tpu_torch.models import fields as tf
from nerfca_tpu_torch.ops.encoding import posenc

# per leaf, of the leaf's own scale: the split keeps ~2^-21 of each product
# (the f32 reference 2^-24), far inside K2's 2e-2 on the card
LEAF_REL = 1e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: what ``cvt.rna.tf32.f32`` does, on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as K2's mma.sync computes it; every TF32 product is exact
    in f32, the sums are f32."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass, the product the split improves on."""
    return tf32_rna(a) @ tf32_rna(b)


def k2_field_grads(params, x, g, phases=None, n_phases=0):
    """Gradients of ``sum(g * field(x))`` for one field on the encoded (and,
    for the temporal field, latent-extended) input ``x [N, k0]``, in K2's
    order: 3xTF32 forward recompute, then per layer from the last dW = H^T D,
    db = sum_p D and (hidden layers) dX = D W masked by the ReLU; the output
    layer and the latent cotangent in f32."""
    early = params["early"]
    hs = [x]
    for layer in early:
        hs.append(torch.relu(layer["b"] + mm_3xtf32(hs[-1], layer["w"].t())))
    h_last = hs.pop()
    wo = params["out"]["w"][0]
    grads = {"out": {"w": (g @ h_last)[None], "b": g.sum()[None]}}
    d = (wo[None] * g[:, None]) * (h_last > 0)
    layers = [None] * len(early)
    for l in range(len(early) - 1, -1, -1):
        layers[l] = {"w": mm_3xtf32(hs[l].t(), d).t(), "b": d.sum(0)}
        if l > 0:
            d = mm_3xtf32(d, early[l]["w"]) * (hs[l] > 0)
    grads["early"] = layers
    if phases is not None:
        n_lat = params["latents"].shape[1]
        dlat = d @ early[0]["w"][:, -n_lat:]
        grads["latents"] = torch.zeros(n_phases, n_lat).index_add_(0, phases, dlat)
    return grads


def flagship_case(seed, open_bands):
    """The flagship widths (4 x 128 hidden, free_windowed basis 12, 8-d
    latents) on 6 rays x 64 samples; inputs from numpy."""
    kw = dict(num_early_layers=4, num_filters=128, pos_enc="free_windowed", pos_enc_basis=12,
              pos_enc_window_start=1, pos_enc_window_decay_steps=150000)
    js, jt = jf.FieldConfig(**kw), jf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)
    ts, tt = tf.FieldConfig(**kw), tf.FieldConfig(use_time_latents=True, num_time_dim=8, **kw)
    ps = jax.tree.map(np.asarray, jf.init_static_field(jax.random.PRNGKey(seed), js))
    pt = jax.tree.map(np.asarray, jf.init_temporal_field(jax.random.PRNGKey(seed + 1), jt))
    rng = np.random.default_rng(seed)
    r, s = 6, 64
    o = np.tile(np.array([[0.1, -0.2, -4.5]], np.float32), (r, 1))
    d = np.concatenate([rng.uniform(-0.1, 0.1, (r, 2)), np.ones((r, 1))], 1).astype(np.float32)
    z = np.sort(rng.uniform(3.6, 5.4, (r, s)), axis=1).astype(np.float32)
    pts = (o[:, None] + d[:, None] * z[..., None]).astype(np.float32)
    ph = np.repeat(rng.integers(0, 10, r), s).reshape(r, s).astype(np.int32)
    w = (np.ones(12, np.float32) if open_bands
         else np.asarray(free_window_mask(12, 90000, 150000, 1), np.float32))
    g_s = rng.standard_normal((r, s, 1)).astype(np.float32)
    g_t = rng.standard_normal((r, s, 1)).astype(np.float32)
    return dict(js=js, jt=jt, ts=ts, tt=tt, ps=ps, pt=pt, pts=pts, ph=ph, w=w, g_s=g_s, g_t=g_t)


def jax_grads(c):
    w = jnp.asarray(c["w"])

    def fields(ps, pt):
        return (jf.apply_static_field(ps, jnp.asarray(c["pts"]), c["js"], window=w),
                jf.apply_temporal_field(pt, jnp.asarray(c["pts"]), jnp.asarray(c["ph"]),
                                        c["jt"], window=w))

    _, vjp = jax.vjp(fields, c["ps"], c["pt"])
    return vjp((jnp.asarray(c["g_s"]), jnp.asarray(c["g_t"])))


def emulated_grads(c):
    tps, tpt = tf.params_from_jax(c["ps"]), tf.params_from_jax(c["pt"])
    pts = torch.tensor(c["pts"]).reshape(-1, 3)
    ph = torch.tensor(c["ph"]).reshape(-1).long()
    w = torch.tensor(c["w"])
    enc_s = posenc(pts, c["ts"].pos_enc, c["ts"].pos_enc_basis, window=w)
    enc_t = torch.cat([posenc(pts, c["tt"].pos_enc, c["tt"].pos_enc_basis, window=w),
                       tpt["latents"][ph]], dim=-1)
    gs = k2_field_grads(tps, enc_s, torch.tensor(c["g_s"]).reshape(-1))
    gt = k2_field_grads(tpt, enc_t, torch.tensor(c["g_t"]).reshape(-1), ph, tpt["latents"].shape[0])
    return tf.params_to_jax(gs), tf.params_to_jax(gt)


@pytest.mark.parametrize("open_bands", [True, False])
def test_3xtf32_backward_matches_jnp_fields(open_bands):
    c = flagship_case(5, open_bands)
    want = jax_grads(c)
    got = emulated_grads(c)
    for g_tree, w_tree in zip(got, want):
        flat_w = jax.tree_util.tree_flatten_with_path(w_tree)[0]
        flat_g = jax.tree_util.tree_leaves(g_tree)
        assert len(flat_g) == len(flat_w)
        for (path, b), a in zip(flat_w, flat_g):
            b = np.asarray(b)
            assert a.shape == b.shape, path
            scale = np.abs(b).max()
            assert scale > 0, path
            assert np.abs(a - b).max() <= LEAF_REL * scale, (path, np.abs(a - b).max(), scale)


@pytest.mark.parametrize("product", ["forward", "dX", "dW"])
def test_split_keeps_the_low_part(product):
    # operands whose values carry a low part of 2^-12 of themselves, which
    # TF32's 10 mantissa bits cannot hold (it lies below half an ulp): one
    # TF32 pass drops it (relative error ~2^-11), the split keeps it
    rng = np.random.default_rng(1)

    def with_low_part(shape):
        hi = tf32_rna(torch.tensor(rng.uniform(0.25, 1.0, shape).astype(np.float32)))
        x = hi * (1 + 2.0**-12)  # exact in f32: 11 + 12 significant bits
        assert torch.equal(tf32_rna(x), hi)
        return x

    h, d = with_low_part((128, 96)), with_low_part((128, 128))
    w = with_low_part((128, 128))
    a, b = {"forward": (h, w[:96]), "dX": (d, w), "dW": (h.t(), d)}[product]
    exact = a.double() @ b.double()

    def rel(x):
        return float(((x.double() - exact).abs() / exact.abs()).max())

    assert rel(mm_3xtf32(a, b)) < 1e-6
    assert rel(mm_1xtf32(a, b)) > 4e-4
