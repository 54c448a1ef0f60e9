"""The plain reference of the NeRF-CA configurations, in plain PyTorch and
float32 with TF32 off, written from the method's description: here the
fields, the hull gate and what the renders share; each traffic kind's
pieces in a module of their own (``train.py``: the loss batteries, a
step's draws and Adam; ``render.py``: a test view).

It imports nothing of the program: a step's random numbers come from the
frozen Threefry copy (``threefry.py``), its inputs from ``inputs.py``.
``tf32=True`` computes every matrix product, forward and backward, with
its operands rounded to TF32 (10 mantissa bits, to nearest even) and f32
sums: the control, one precision below the configuration's.

A field: the position encoded as ``[x, sin(2^j x), cos(2^j x)]`` over
``basis`` bands (cos as ``sin(t + pi/2)``), each band scaled by the
FreeNeRF window; a temporal field appends its phase's latent row; then
``num_early_layers + 1`` ReLU layers of ``num_filters`` and a linear
output. Rendering is Beer-Lambert in log space, ``I0 - sum sigma * dist``,
the last dist 1e-10; the composite scales both densities by 1e-2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32: 10 mantissa bits, to nearest even."""
    r = x.contiguous().view(torch.int32)
    r = (r + 0x0FFF + ((r >> 13) & 1)) & ~0x1FFF
    return r.view(torch.float32)


class _Tf32Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.linear(_tf32(x), _tf32(w), b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = _tf32(g.reshape(-1, g.shape[-1]))
        gx = (g2 @ _tf32(w)).reshape(x.shape)
        gw = g2.T @ _tf32(x.reshape(-1, x.shape[-1]))
        return gx, gw, g.reshape(-1, g.shape[-1]).sum(0)


def linear(x, layer, tf32: bool):
    if tf32:
        return _Tf32Linear.apply(x, layer["w"], layer["b"])
    return F.linear(x, layer["w"], layer["b"])


def window(f: dict, step: int, device) -> torch.Tensor:
    """FreeNeRF's band mask at ``step``: ``clip(ptr - band, 0, 1)`` within
    [1e-8, 1 - 1e-8], ``ptr = basis * step / decay + start``; ones past
    the decay."""
    basis = f["pos_enc_basis"]
    if step >= f["pos_enc_window_decay_steps"]:
        return torch.ones(basis, device=device)
    bands = torch.arange(basis, dtype=torch.float32, device=device)
    ptr = torch.tensor(basis * step / f["pos_enc_window_decay_steps"]
                       + f["pos_enc_window_start"], dtype=torch.float32, device=device)
    return torch.clamp(torch.clamp(ptr - bands, 0.0, 1.0), 1e-8, 1.0 - 1e-8)


def encode(x: torch.Tensor, basis: int, win: torch.Tensor) -> torch.Tensor:
    scales = 2.0 ** torch.arange(basis, dtype=torch.float32, device=x.device)
    xb = x[..., None, :] * scales[:, None]
    feats = torch.sin(torch.stack([xb, xb + 0.5 * math.pi], dim=-2)) * win[:, None, None]
    return torch.cat([x, feats.reshape(*x.shape[:-1], -1)], dim=-1)


def field(params: dict, f: dict, pts, phases, win, tf32: bool) -> torch.Tensor:
    """Raw density ``[...]`` of one field at ``pts [..., 3]``."""
    h = encode(pts, f["pos_enc_basis"], win)
    if f["use_time_latents"]:
        h = torch.cat([h, params["latents"][phases.long()]], dim=-1)
    for layer in params["early"]:
        h = torch.relu(linear(h, layer, tf32))
    return linear(h, params["out"], tf32)[..., 0]


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def dists_of(z: torch.Tensor) -> torch.Tensor:
    return torch.cat([z[1:] - z[:-1], torch.full_like(z[:1], 1e-10)])


def gate_of(hull: dict, pts: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of the hull grid at ``pts [..., 3]``; 0 outside."""
    grid = hull["grid"]
    res = torch.tensor(grid.shape, device=pts.device)
    g = (pts - hull["off"]) / hull["d_voxel"] + (res - 1) / 2
    inside = ((g >= 0) & (g <= res - 1)).all(-1)
    g = torch.minimum(torch.clamp(g, min=0.0), (res - 1).float())
    i0 = torch.minimum(torch.floor(g).long(), res - 2)
    f = g - i0
    out = torch.zeros(pts.shape[:-1], device=pts.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                out = out + w * grid[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]
    return torch.where(inside, out, torch.zeros_like(out))
