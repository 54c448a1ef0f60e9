"""The benchmark's inputs, made on the device from ``--seed``: a phantom
with analytic line integrals, the ray table of a configuration's
acquisition, the variance weights and split, the test views, the eval's
depth grid, a motion-hull grid and the fields' initial weights.

Nothing here calls the program: the program and the plain reference are
handed the same tensors.

The phantom is a static background (a body ellipsoid and a few dense
ellipsoids) and a vessel, a chain of Gaussian blobs along a bent curve
that moves with the cardiac phase; a pixel is ``log(MAX_PIXEL_VALUE)``
less the ray's line integral (Beer-Lambert in log space), the integral
taken along the ray's unnormalised direction as the renderer takes it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import geometry, threefry

N_BLOBS = 48
N_DENSE = 6
CARDIAC_PHASES = 10


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A torch generator for one stream of the seed's draws."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + stream) % (2 ** 63))
    return g


def phantom(seed: int, device) -> dict:
    """The phantom's parameters: ellipsoid centres, semi-axes and densities
    (the body first), and the vessel's blobs per phase ``[P, B, 3]``."""
    g = generator(seed, device, 1)
    u = torch.rand(4096, generator=g, device=device, dtype=torch.float64)
    it = iter(torch.split(u, [3, 3 * N_DENSE, 3 * N_DENSE, N_DENSE, 12, N_BLOBS, 2,
                              4096 - 17 - 7 * N_DENSE - N_BLOBS]))
    body_axes = torch.tensor([0.55, 0.45, 0.6], dtype=torch.float64, device=device)
    body_axes = body_axes * (0.95 + 0.1 * next(it))
    centres = torch.cat([torch.zeros(1, 3, dtype=torch.float64, device=device),
                         (next(it).reshape(N_DENSE, 3) - 0.5) * 0.7])
    axes = torch.cat([body_axes[None], 0.03 + 0.09 * next(it).reshape(N_DENSE, 3)])
    density = torch.cat([torch.tensor([0.6], dtype=torch.float64, device=device),
                         1.0 + next(it)])
    # the vessel: a bent curve inside the field of view at the isocentre
    # (about +-0.18 there), moving with the phase
    c = next(it).reshape(4, 3) - 0.5
    p0, p1, bend, motion = 0.2 * c[0], 0.2 * c[1], 0.1 * c[2], 0.06 * c[3]
    s = torch.linspace(0.0, 1.0, N_BLOBS, dtype=torch.float64, device=device)[:, None]
    amp = 1.5 + next(it)[:, None]
    phase = torch.arange(CARDIAC_PHASES, dtype=torch.float64, device=device)[:, None, None]
    offs = next(it)
    shift = torch.sin(2 * math.pi * phase / CARDIAC_PHASES + math.pi * s[None] + 6.28 * offs[0])
    blobs = (p0 + s * (p1 - p0) + torch.sin(math.pi * s) * bend)[None] + shift * motion
    return {"centres": centres, "axes": axes, "density": density, "blobs": blobs,
            "amp": amp[:, 0], "width": 0.012 + 0.004 * offs[1]}


def _static_integral(ph: dict, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Chords through the ellipsoids times their densities, along ``d``."""
    o, d = o.double(), d.double()
    total = torch.zeros(o.shape[0], dtype=torch.float64, device=o.device)
    for c, r, rho in zip(ph["centres"], ph["axes"], ph["density"]):
        oc = (o - c) / r
        dd = d / r
        a = (dd * dd).sum(-1)
        b = 2 * (oc * dd).sum(-1)
        cc = (oc * oc).sum(-1) - 1
        disc = torch.clamp(b * b - 4 * a * cc, min=0.0)
        total = total + rho * torch.sqrt(disc) / a
    return total


def _vessel_integral(ph: dict, phase: int, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Line integrals of the phase's Gaussian blobs along ``d``:
    ``a sqrt(2 pi) w / |d| exp(-r^2 / (2 w^2))`` with ``r`` the distance
    from the blob's centre to the line."""
    o, d = o.double(), d.double()
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    u = d / dn
    w = ph["width"]
    total = torch.zeros(o.shape[0], dtype=torch.float64, device=o.device)
    for c, a in zip(ph["blobs"][phase], ph["amp"]):
        oc = c - o
        along = (oc * u).sum(-1, keepdim=True)
        r2 = (oc * oc).sum(-1) - along[:, 0] ** 2
        total = total + a * math.sqrt(2 * math.pi) * w / dn[:, 0] * torch.exp(-r2 / (2 * w * w))
    return total


def train_rays(cfg: dict, seed: int, device) -> dict:
    """The ray table ``[N, 4, 3]`` (origin, direction, pixel, weight; images
    ordered by phase, then view; pixel ``(a, b)`` at ``a * H + b``), the
    phases ``[N]``, and the high-variance id split."""
    acq = geometry.acquisition(cfg["data_size"])
    angles = geometry.train_angles(cfg["data_limited_range"], cfg["data_step_size"],
                                   cfg.get("data_numb_angles"))
    phases = list(range(cfg["data_time_range_start"], cfg["data_time_range_end"]))
    ph = phantom(seed, device)
    log_i0 = math.log(geometry.MAX_PIXEL_VALUE)
    n_pix = acq["n_detector"] ** 2
    views = [geometry.view_rays(t, p, acq, device) for t, p in angles]
    pixels = torch.empty(len(phases), len(views), n_pix, dtype=torch.float64, device=device)
    for vi, (o, d) in enumerate(views):
        static = _static_integral(ph, o, d)
        for pi, p in enumerate(phases):
            pixels[pi, vi] = log_i0 - (static + _vessel_integral(ph, p, o, d))
    weights = torch.ones(len(views), n_pix, dtype=torch.float64, device=device)
    if len(phases) == CARDIAC_PHASES and cfg["var_sample_perc"] > 0:
        # the temporal variance of the absorption over the phases, min-max
        # normalised per view and shifted to [1, 2]
        var = torch.var(torch.exp(pixels - log_i0), dim=0, unbiased=False)
        lo, hi = var.min(-1, keepdim=True).values, var.max(-1, keepdim=True).values
        weights = (var - lo) / (hi - lo + 1e-10) + 1.0
        weights = (weights - 1.0) * cfg["weighted_loss_max"] + 1.0
    n_img = len(phases) * len(views)
    table = torch.empty(n_img, n_pix, 4, 3, dtype=torch.float32, device=device)
    for pi in range(len(phases)):
        for vi, (o, d) in enumerate(views):
            row = table[pi * len(views) + vi]
            row[:, 0], row[:, 1] = o, d
            row[:, 2] = pixels[pi, vi, :, None].float()
            row[:, 3] = weights[vi, :, None].float()
    table = table.reshape(-1, 4, 3)
    ray_phases = torch.tensor(phases, dtype=torch.int32, device=device).repeat_interleave(
        len(views) * n_pix)
    high = table[:, 3, 0] > 1.0 + cfg["var_sample_thre"] / 100.0
    var_ids = torch.nonzero(high)[:, 0]
    non_var_ids = torch.nonzero(~high)[:, 0]
    if var_ids.numel() == 0:  # an empty id set is passed as one zero id
        var_ids = torch.zeros(1, dtype=torch.int64, device=device)
    return {"rays": table, "phases": ray_phases, "var_ids": var_ids,
            "non_var_ids": non_var_ids, "n_var": int(high.sum()), "phantom": ph, "acq": acq,
            "initial_intensity": log_i0}


def test_views(cfg: dict, device) -> list:
    """The test views, ordered by phase, then clinical angle: each view's
    origins, directions and phases."""
    acq = geometry.acquisition(cfg["data_size"])
    out = []
    for p in range(cfg["data_time_range_start"], cfg["data_time_range_end"]):
        for t, f in geometry.CLINICAL_TEST_ANGLES:
            o, d = geometry.view_rays(t, f, acq, device)
            out.append({"origins": o, "directions": d, "phase": p,
                        "phases": torch.full((o.shape[0],), p, dtype=torch.int32,
                                             device=device)})
    return out


def base_depths(acq: dict, n: int, device) -> torch.Tensor:
    """``n`` evenly spaced depths over [near, far]: ``i * f32(1 / (n - 1))``,
    the last exactly 1."""
    t = torch.arange(n, dtype=torch.float32, device=device) * float(np.float32(1.0 / (n - 1)))
    t[-1] = 1.0
    return acq["near"] * (1.0 - t) + acq["far"] * t


def eval_depths(acq: dict, n: int, seed: int, device) -> torch.Tensor:
    """The eval's fixed jittered grid: each depth uniform within its
    midpoint interval, the uniforms drawn from the seed."""
    z = base_depths(acq, n, device)
    u = torch.from_numpy(threefry.uniform(threefry.fold_in(threefry.key(seed), 2), n)).to(device)
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    return lower + (upper - lower) * u


def hull_grid(ph: dict, res: int, half: float, radius: float, device) -> dict:
    """A motion-hull grid ``[res]^3`` over the volume: a Gaussian of the
    distance from each voxel centre to the vessel's nearest blob over all
    phases; ``d_voxel`` and ``off`` place it as the port's hull does."""
    dv = 2 * half / res
    idx = (torch.arange(res, dtype=torch.float32, device=device) - (res - 1) / 2) * dv
    gx, gy, gz = torch.meshgrid(idx, idx, idx, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(-1, 3)
    centres = ph["blobs"].reshape(-1, 3).float()
    dmin = torch.full((pts.shape[0],), float("inf"), device=device)
    for start in range(0, pts.shape[0], 65536):
        dmin[start:start + 65536] = torch.cdist(pts[start:start + 65536], centres).min(-1).values
    grid = torch.exp(-dmin ** 2 / (2 * radius ** 2)).reshape(res, res, res)
    return {"grid": grid.contiguous(),
            "d_voxel": torch.full((3,), dv, dtype=torch.float32, device=device),
            "off": torch.zeros(3, dtype=torch.float32, device=device)}


def field_weights(fields: dict, seed: int, device) -> dict:
    """Every field's initial weights in the port's layout (``w`` as
    ``[out, in]``): ``nn.Linear``'s default Uniform(+-1/sqrt(fan_in)) for
    weights and biases, Uniform[0, 1) for a temporal field's latent table,
    from one draw on the device."""
    shapes = []
    for name, f in fields.items():
        f_in = f["encoded_features"] + (f["num_time_dim"] if f["use_time_latents"] else 0)
        dims = [f_in] + [f["num_filters"]] * (f["num_early_layers"] + 1) + [1]
        for i in range(len(dims) - 1):
            shapes.append((name, i, "w", (dims[i + 1], dims[i]), dims[i]))
            shapes.append((name, i, "b", (dims[i + 1],), dims[i]))
        if f["use_time_latents"]:
            shapes.append((name, None, "latents", (CARDIAC_PHASES, f["num_time_dim"]), None))
    sizes = [int(np.prod(s[3])) for s in shapes]
    u = torch.rand(sum(sizes), generator=generator(seed, device, 2), device=device)
    params = {}
    for (name, layer, kind, shape, fan_in), part in zip(shapes, torch.split(u, sizes)):
        p = params.setdefault(name, {"early": []})
        if kind == "latents":
            p["latents"] = part.reshape(shape).clone()
            continue
        bound = 1.0 / math.sqrt(fan_in)
        t = ((2 * part - 1) * bound).reshape(shape).clone()
        n_layers = len([s for s in shapes if s[0] == name and s[2] == "w"])
        if layer == n_layers - 1:
            p.setdefault("out", {})[kind] = t
        else:
            if kind == "w":
                p["early"].append({})
            p["early"][-1][kind] = t
    return params


def clone_params(params: dict) -> dict:
    """A deep copy of a parameter tree."""
    if isinstance(params, dict):
        return {k: clone_params(v) for k, v in params.items()}
    if isinstance(params, list):
        return [clone_params(v) for v in params]
    return params.detach().clone()
