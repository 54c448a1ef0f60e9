"""The reference of a train step: the composite and static methods' loss
batteries, a step's draws (from the frozen Threefry copy), the ray jitter
and Adam, over the fields of ``portbench.reference``."""

from __future__ import annotations

import numpy as np
import torch

from portbench import threefry
from portbench.reference import dists_of, field, gate_of, softplus, window


def clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def ray_entropy(sigma, dists, mask_thre, clip_thre, extra_mask=None):
    """Per-ray entropy of the density distribution on rays whose
    attenuation reaches ``mask_thre`` (or ``extra_mask``); its mean and
    the mean attenuation. Rays of all-zero density give no cotangent
    through the normaliser."""
    sd = sigma * dists
    total = sd.sum(-1, keepdim=True)
    mask = total[..., 0] >= mask_thre
    if extra_mask is not None:
        mask = mask | extra_mask
    clipped = clip(total, lo=clip_thre)
    denom = torch.where(total < 1e-15, clipped.detach(), clipped)
    p = sd / denom
    ent = mask * -(p * torch.log(p + 1e-10)).sum(-1)
    return ent.mean(), total.mean()


def decay(step, start, end, steps, delay=0) -> float:
    """Linear ramp from ``start`` to ``end`` over ``steps``, 0 before ``delay``; f32."""
    f = np.float32
    if f(step) < f(delay):
        return 0.0
    a = min(f(f(step) - f(delay)) / f(steps), f(1.0))
    return float((f(1.0) - a) * f(start) + a * f(end))


def composite_loss(params, cfg: dict, batch: dict, z, step: int, hull, tf32: bool):
    """The composite objective of one batch and its read-back terms."""
    fs, ft = cfg["fields"]["static"], cfg["fields"]["temp"]
    dev = z.device
    pts = batch["origins"][:, None, :] + batch["directions"][:, None, :] * z[None, :, None]
    ph = batch["phases"][:, None].expand(-1, z.shape[0])
    raw_s = field(params["static"], fs, pts, ph, window(fs, step, dev), tf32)
    raw_t = field(params["temp"], ft, pts, ph, window(ft, step, dev), tf32)
    dists = dists_of(z)
    s_sig = softplus(raw_s) * 1e-2
    t_sig = softplus(raw_t) * 1e-2
    gate = None
    if hull is not None:
        gate = gate_of(hull, pts)
        t_sig = t_sig * gate
    pix = batch["i0"] - ((s_sig + t_sig) * dists).sum(-1)
    w = batch["weights"]
    pixel_loss = ((pix - batch["pixels"]) ** 2 * w).mean()
    blendw = t_sig / (s_sig + t_sig + 1e-10)
    b = clip(blendw ** cfg["skewness_val"], 1e-19, 1 - 1e-19)
    rev = clip(1 - b, lo=1e-19)
    favor = (-(b * torch.log(b) + rev * torch.log(rev))).mean(-1).mean()
    s_ent, s_sum = ray_entropy(s_sig, dists, cfg["entro_mask_thre"], cfg["entro_clip_threshold"])
    d_ent, d_sum = ray_entropy(
        t_sig, dists, cfg["entro_mask_thre"], cfg["entro_clip_threshold"],
        w > 1.0 + cfg["entro_weighted_thresh"] if cfg["entro_use_weighting"] else None)
    occl = (t_sig * dists).sum(-1).mean()  # the occlusion mask covers the whole ray
    l1 = (s_sig * dists).sum()
    l2 = ((s_sig * dists) ** 2).sum()
    d = cfg["hyperparam_decay_steps"]
    wf = decay(step, cfg["favor_s_weight_start"], cfg["favor_s_weight_end"], d,
               cfg["favor_s_weight_delay_steps"])
    wd = decay(step, cfg["dynamic_entro_weight_start"], cfg["dynamic_entro_weight_end"], d)
    wo = decay(step, cfg["occl_weight_start"], cfg["occl_weight_end"], d,
               cfg["favor_s_weight_delay_steps"])
    wl = decay(step, cfg["l1_weight_start"], cfg["l1_weight_end"], d)
    loss = pixel_loss + wf * favor + wd * d_ent + wo * occl + wl * l2 + wl * l1
    hull_l1 = torch.zeros((), device=dev)
    if gate is not None:
        hull_l1 = (s_sig * dists * gate).sum(-1).mean()
        loss = loss + decay(step, cfg.get("hull_static_l1_weight_start", 0.0),
                            cfg.get("hull_static_l1_weight_end", 0.0), d) * hull_l1
    terms = {"train_pixel_loss_coarse": pixel_loss, "train_blendw": blendw.mean(),
             "train_sigma_s_max": s_sig.max(), "train_sigma_d_max": t_sig.max(),
             "train_favor_s_loss": favor, "train_s_entropy_loss": s_ent,
             "train_d_entropy_loss": d_ent, "train_s_entropy_sum": s_sum,
             "train_d_entropy_sum": d_sum, "train_d_occl_loss": occl, "train_s_l1": l1,
             "train_s_l2": l2, "train_hull_s_l1": hull_l1, "train_loss": loss}
    return loss, {k: v.detach() for k, v in terms.items()}


def static_loss(params, cfg: dict, batch: dict, z, step: int, hull, tf32: bool):
    """The static method's objective: pixel loss plus the occlusion loss
    on the unscaled density."""
    del hull
    f = cfg["fields"]["static"]
    pts = batch["origins"][:, None, :] + batch["directions"][:, None, :] * z[None, :, None]
    raw = field(params["static"], f, pts, None, window(f, step, z.device), tf32)
    sigma = softplus(raw)
    dists = dists_of(z)
    pix = batch["i0"] - (sigma * dists * 1e-2).sum(-1)
    pixel_loss = ((pix - batch["pixels"]) ** 2 * batch["weights"]).mean()
    occl = (sigma * dists).sum(-1).mean()
    loss = pixel_loss + cfg["occl_weight_start"] * occl
    terms = {"train_pixel_loss": pixel_loss, "train_occl_loss": occl, "train_loss": loss}
    return loss, {k: v.detach() for k, v in terms.items()}



def leaves(params: dict) -> list:
    """``(name, tensor)`` of every leaf: fields in name order, then the
    early layers, the output layer and the latent table."""
    out = []
    for name in sorted(params):
        p = params[name]
        for i, layer in enumerate(p["early"]):
            out += [(f"{name}/early/{i}/{k}", layer[k]) for k in sorted(layer)]
        out += [(f"{name}/out/{k}", p["out"][k]) for k in sorted(p["out"])]
        if "latents" in p:
            out.append((f"{name}/latents", p["latents"]))
    return out


def draws(rng: np.ndarray, cfg: dict, n_var_ids: int, n_non_var_ids: int, n_rays: int):
    """One step's batch positions, jitter uniforms ``[n, 2]`` (or None) and
    depth uniforms, and the next key: the composite step splits its key in
    four (next, sample, depth, fine) and draws the jitter under
    ``fold_in(fine, 1)``; the static step splits it in three."""
    n, nv, s = cfg["img_sample_size"], cfg["nb_var_rays"], cfg["depth_samples_per_ray_coarse"]
    if cfg["method"] == "composite":
        rng, k_sample, k_depth, k_fine = threefry.split(rng, 4)
    else:
        rng, k_sample, k_depth = threefry.split(rng, 3)
    if nv > 0:
        k_var, k_non_var = threefry.split(k_sample)
        pos = np.concatenate([threefry.randint(k_var, nv, n_var_ids),
                              threefry.randint(k_non_var, n - nv, n_non_var_ids)])
    else:
        pos = threefry.randint(k_sample, n, n_rays)
    u = None
    if cfg["method"] == "composite" and cfg["ray_jitter"] > 0:
        u = threefry.uniform(threefry.fold_in(k_fine, 1), 2 * n).reshape(n, 2)
    return rng, pos, u, threefry.uniform(k_depth, s)


def jitter(d: torch.Tensor, amount: float, u: torch.Tensor) -> torch.Tensor:
    """Directions moved by ``(u - 1/2) * amount`` along two axes
    perpendicular to each ray."""
    up = torch.where(torch.abs(d[:, 2:3]) < 0.9, d.new_tensor([0.0, 0.0, 1.0]),
                     d.new_tensor([1.0, 0.0, 0.0]))
    e1 = torch.linalg.cross(d, up.expand_as(d))
    e1 = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(d, e1)
    e2 = e2 / torch.linalg.norm(e2, dim=-1, keepdim=True)
    u = (u - 0.5) * amount
    return d + u[:, 0:1] * e1 + u[:, 1:2] * e2


def train_steps(params: dict, cfg: dict, data: dict, z_base, rng, n_steps: int,
                hull=None, tf32: bool = False, loss_wrap=None) -> list:
    """``n_steps`` steps from ``params`` (updated in place) and the key
    ``rng``: each step's terms, and after the first step each leaf's
    gradient. Adam: linear LR decay at the pre-increment count, bias
    correction at the incremented count, eps outside the square root.
    ``loss_wrap`` wraps the loss function (a planted fault, for the
    control's tests only)."""
    loss_fn = composite_loss if cfg["method"] == "composite" else static_loss
    if loss_wrap is not None:
        loss_fn = loss_wrap(loss_fn)
    items = leaves(params)
    mu = [torch.zeros_like(t) for _, t in items]
    nu = [torch.zeros_like(t) for _, t in items]
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = []
    rays = data["rays"]
    for step in range(n_steps):
        rng, pos, u, t = draws(rng, cfg, data["var_ids"].shape[0], data["non_var_ids"].shape[0],
                               rays.shape[0])
        pos = torch.from_numpy(pos).to(rays.device)
        nv = cfg["nb_var_rays"]
        idx = (torch.cat([data["var_ids"][pos[:nv]], data["non_var_ids"][pos[nv:]]]) if nv > 0
               else pos)
        rows = rays[idx]
        batch = {"origins": rows[:, 0], "directions": rows[:, 1], "pixels": rows[:, 2, 0],
                 "weights": rows[:, 3, 0], "phases": data["phases"][idx],
                 "i0": data["initial_intensity"]}
        if u is not None:
            batch["directions"] = jitter(batch["directions"], cfg["ray_jitter"],
                                         torch.from_numpy(u).to(rays.device))
        t = torch.from_numpy(t).to(rays.device)
        mids = 0.5 * (z_base[1:] + z_base[:-1])
        lower = torch.cat([z_base[:1], mids])
        upper = torch.cat([mids, z_base[-1:]])
        z = lower + (upper - lower) * t
        for _, p in items:
            p.requires_grad_(True)
        loss, terms = loss_fn(params, cfg, batch, z, step, hull, tf32)
        grads = torch.autograd.grad(loss, [p for _, p in items])
        rec = {"terms": terms}
        if step == 0:
            rec["grads"] = {n: g.detach().clone() for (n, _), g in zip(items, grads)}
        with torch.no_grad():
            f = np.float32
            lr0, lr1 = f(cfg["lr"]), f(cfg["lr"] * cfg["lr_end_factor"])
            c = f(min(step, cfg["lr_decay_steps"]))
            lr = float((lr0 - lr1) * (f(1) - c / f(cfg["lr_decay_steps"])) + lr1)
            bc1 = float(1 - f(b1) ** f(step + 1))
            bc2 = float(1 - f(b2) ** f(step + 1))
            for (_, p), g, m, v in zip(items, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g * g, alpha=1 - b2)
                p.add_((m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr)
        out.append(rec)
    for _, p in items:
        p.requires_grad_(False)
    return out
