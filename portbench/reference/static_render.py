"""The reference of the static method's test view: the one image of its
one field, over the fields of ``portbench.reference``."""

from __future__ import annotations

import torch

from portbench.reference import dists_of, field, softplus, window


@torch.no_grad()
def render_view(params: dict, cfg: dict, view: dict, z, step: int, i0: float,
                tf32: bool = False, block: int = 2048) -> torch.Tensor:
    """The static field's image ``[1, W * H]`` of one test view,
    ``i0 - sum softplus(raw) * dist * 1e-2`` over the shared depths ``z``,
    ``block`` rays at a time."""
    f = cfg["fields"]["static"]
    dists = dists_of(z)
    win = window(f, step, z.device)
    parts = []
    for start in range(0, view["origins"].shape[0], block):
        o = view["origins"][start:start + block]
        d = view["directions"][start:start + block]
        pts = o[:, None, :] + d[:, None, :] * z[None, :, None]
        sig = softplus(field(params["static"], f, pts, None, win, tf32))
        parts.append(i0 - (sig * dists * 1e-2).sum(-1))
    return torch.cat(parts)[None]
