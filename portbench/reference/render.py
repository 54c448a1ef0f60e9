"""The reference of a test view: the composite, static-only and
dynamic-only images, over the fields of ``portbench.reference``."""

from __future__ import annotations

import torch

from portbench.reference import dists_of, field, gate_of, softplus, window


@torch.no_grad()
def render_view(params: dict, cfg: dict, view: dict, z, step: int, i0: float, hull=None,
                tf32: bool = False, block: int = 2048) -> torch.Tensor:
    """The composite, static-only and dynamic-only images ``[3, W * H]`` of
    one test view, ``block`` rays at a time."""
    fs, ft = cfg["fields"]["static"], cfg["fields"]["temp"]
    dists = dists_of(z)
    ws, wt = window(fs, step, z.device), window(ft, step, z.device)
    parts = []
    for start in range(0, view["origins"].shape[0], block):
        o = view["origins"][start:start + block]
        d = view["directions"][start:start + block]
        pts = o[:, None, :] + d[:, None, :] * z[None, :, None]
        ph = view["phases"][start:start + block, None].expand(-1, z.shape[0])
        s_sig = softplus(field(params["static"], fs, pts, ph, ws, tf32))
        t_sig = softplus(field(params["temp"], ft, pts, ph, wt, tf32))
        if hull is not None:
            t_sig = t_sig * gate_of(hull, pts)
        s_line = (s_sig * 1e-2 * dists).sum(-1)
        t_line = (t_sig * 1e-2 * dists).sum(-1)
        both = ((s_sig * 1e-2 + t_sig * 1e-2) * dists).sum(-1)
        parts.append(torch.stack([i0 - both, i0 - s_line, i0 - t_line]))
    return torch.cat(parts, dim=1)
