"""The reference of the hash-grid field's test view (NAF's attenuation
field: Instant-NGP's multiresolution hash encoding feeding a small MLP),
written from the two papers' description, with every size read from the
configuration file.

The encoding: a point is mapped to the unit cube over the volume's box,
``u = clamp((x + bound) / (2 bound), 0, 1)``. Level ``l`` of ``L`` has
``N_l = floor(N_min * b^l)`` cells a side, ``b = (N_max / N_min)^(1 / (L -
1))``; ``pos = u * N_l``, the cell ``g = min(floor(pos), N_l - 1)`` and
its 8 corners ``g + {0, 1}^3``. A level whose ``(N_l + 1)^3`` corners fit
its ``T = 2^log2_T`` entries indexes them densely, ``g0 + (N_l + 1) (g1 +
(N_l + 1) g2)``; the others hash, ``(g0 * 1 ^ g1 * 2654435761 ^ g2 *
805459861) mod T`` in uint32. A level's ``F`` features are the corners'
entries under the trilinear weights of ``pos - g``; the levels' features
are concatenated, the coarsest first. The table is one ``[E, F]`` array,
the levels one after the other, each level's entries rounded up to a
multiple of 8.

The MLP: ``num_layers`` linear layers of ``hidden_dim``, the encoding
concatenated before each layer named in ``skips`` (``[encoded, h]``),
LeakyReLU with slope ``leaky_slope`` after each but the last, whose one
output is the raw density. The view: ``i0 - 1e-2 sum act(raw) * dist``
over the shared depths, the last dist 1e-10, as the static method renders.

It imports nothing of the program. ``tf32=True`` takes every product's
operands rounded to TF32 (the control); ``table_dtype`` reads the table
rounded to that dtype (the bf16-table control).
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dists_of, linear

PRIMES = (1, 2654435761, 805459861)


def levels(cfg: dict) -> list:
    """Per level ``(N, dense, entries, offset)``."""
    n_levels, t = cfg["hash_levels"], 2 ** cfg["hash_log2_table_size"]
    n_min, n_max = cfg["hash_base_resolution"], cfg["hash_finest_resolution"]
    growth = math.log2(n_max / n_min) / (n_levels - 1)
    out, offset = [], 0
    for lv in range(n_levels):
        n = int(math.floor(n_min * 2.0 ** (lv * growth)))
        dense = (n + 1) ** 3 <= t
        entries = -(-((n + 1) ** 3 if dense else t) // 8) * 8
        out.append((n, dense, entries, offset))
        offset += entries
    return out


def table_entries(cfg: dict) -> int:
    n, _, entries, offset = levels(cfg)[-1]
    return offset + entries


def encode(pts: torch.Tensor, table: torch.Tensor, cfg: dict, bound: float) -> torch.Tensor:
    """``pts [..., 3] -> [..., L * F]``."""
    shape = pts.shape[:-1]
    x = pts.reshape(-1, 3).float()
    b = torch.tensor(bound, dtype=torch.float32, device=x.device)
    u = torch.clamp((x + b) / (b + b), 0.0, 1.0)
    t_mask = 2 ** cfg["hash_log2_table_size"] - 1
    feats = []
    for n, dense, _, offset in levels(cfg):
        pos = u * float(n)
        g = torch.clamp(torch.floor(pos), max=float(n - 1)).long()
        f = pos - g.float()
        acc = torch.zeros(x.shape[0], table.shape[1], dtype=torch.float32, device=x.device)
        for c in range(8):
            bits = [(c >> k) & 1 for k in range(3)]
            corner = [g[:, k] + bits[k] for k in range(3)]
            if dense:
                idx = corner[0] + (n + 1) * (corner[1] + (n + 1) * corner[2])
            else:
                idx = (corner[0] * PRIMES[0]) ^ (corner[1] * PRIMES[1]) ^ (corner[2] * PRIMES[2])
                idx = (idx & 0xFFFFFFFF) & t_mask
            w = [f[:, k] if bits[k] else 1.0 - f[:, k] for k in range(3)]
            acc = acc + ((w[0] * w[1]) * w[2])[:, None] * table[offset + idx]
        feats.append(acc)
    return torch.cat(feats, dim=-1).reshape(*shape, -1)


def field(params: dict, cfg: dict, pts: torch.Tensor, bound: float, tf32: bool) -> torch.Tensor:
    """Raw density ``[...]`` at ``pts [..., 3]``."""
    enc = encode(pts, params["table"], cfg, bound)
    h = enc
    layers = params["layers"]
    for i, layer in enumerate(layers):
        if i in cfg["static_skips"]:
            h = torch.cat([enc, h], dim=-1)
        h = linear(h, layer, tf32)
        if i < len(layers) - 1:
            h = torch.nn.functional.leaky_relu(h, cfg["static_leaky_slope"])
    return h[..., 0]


def activation(raw: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "sigmoid":
        return torch.sigmoid(raw)
    raise ValueError(f"the reference renders the sigmoid output, not {kind!r}")


@torch.no_grad()
def render_view(params: dict, cfg: dict, view: dict, z, i0: float, bound: float,
                tf32: bool = False, table_dtype=None, block: int = 1024) -> tuple:
    """The field's image ``[1, W * H]`` of one test view over the shared
    depths ``z`` and its densities ``act(raw) [W * H, S]``, ``block`` rays
    at a time."""
    if table_dtype is not None:
        params = dict(params, table=params["table"].to(table_dtype).float())
    dists = dists_of(z)
    pix, sigma = [], []
    for start in range(0, view["origins"].shape[0], block):
        o = view["origins"][start:start + block]
        d = view["directions"][start:start + block]
        pts = o[:, None, :] + d[:, None, :] * z[None, :, None]
        sigma.append(activation(field(params, cfg, pts, bound, tf32), cfg["output_activation"]))
        pix.append(i0 - (sigma[-1] * dists * 1e-2).sum(-1))
    return torch.cat(pix)[None], torch.cat(sigma)
