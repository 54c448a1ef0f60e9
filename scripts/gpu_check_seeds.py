#!/usr/bin/env python3
"""How often the K2 check of ``tests/test_torch_gpu.py`` exceeds its gate,
by the seed of the global generator its cotangents came from, and what
each excess is.

    python3 scripts/gpu_check_seeds.py [--root .] [--seeds 40] [--out flips.json]

For each seed, the case of ``test_kernels_match_plain_shared_depths`` (50
rays x 77 samples, shared depths) with cotangents drawn as ``check`` drew
them before it was seeded (``torch.randn_like`` after
``torch.manual_seed(seed)``): K1/K2 against the plain f32 version, each
leaf's error as a share of its gate (``K2_REL`` of max(leaf scale, 1e-2 x
global max)), and beside it the plain f32 gradients against the plain f64
ones on the same inputs, which no kernel enters. For each seed over the
gate: the offending element, the f64 pre-activation of its ReLU unit at
every point of the batch (in ``--out``), and the points where K1's own
mask (``kernel_masks``), the plain f32 mask and the f64 mask differ, with
the rounding bound of the test. Then the test's rule (``compare_grads``:
the units whose kernel mask differs from the plain f32 one left out, each
flipped point within its bound, at most ``max_flipped_units``) on every
seed: its failures must be 0. Prints one JSON line; ``--root`` is the
checkout whose package and tests are used. Needs one CUDA device.

    python3 scripts/gpu_check_seeds.py --survey 40

measures instead how often the kernels' ReLU masks differ from the plain
f32 version's, the rate behind the test's cap on flipped units: for each
parameter seed below ``--survey`` and each encoding (free_windowed,
fourier), the test's largest case (64 rays x 500 samples, two 4 x 128
fields) through ``relu_flips``; prints the flipped units of every case,
the pooled rate (units per point), the largest count per point of one
case, and the cases whose count exceeds ``max_flipped_units``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys


def shares(names, got, want, k2_rel: float) -> list:
    top = max(float(b.abs().max()) for b in want)
    return [(float((a - b).abs().max()) / (k2_rel * max(float(b.abs().max()), 1e-2 * top)), n)
            for n, a, b in zip(names, got, want)]


def survey(t, ff, dev, n_seeds: int) -> dict:
    """Flipped ReLU units of the test's largest case over ``n_seeds``
    parameter seeds and both encodings (see the module's docstring)."""
    import torch

    cases, units, points = [], 0, 0
    for enc in ("free_windowed", "fourier"):
        for seed in range(n_seeds):
            fargs, _ = t.make(dev, r=64, s=500, enc=enc, seed=seed)
            ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = fargs
            with torch.no_grad():
                pts = ff._points(o, d, z)
            phases = ph[:, None].expand(pts.shape[:2])
            rays = (o, d, z, ph.to(torch.int32), pt["latents"].detach())
            flips = t.relu_flips((ps, pt), (cfg_s, cfg_t), (w_s, w_t), rays, pts, phases)
            n = phases.numel()
            outside = [f for f in flips if any(abs(q["pre64"]) > q["bound"] for q in f["points"])]
            cases.append({"enc": enc, "seed": seed, "points": n, "units": len(flips),
                          "limit": t.max_flipped_units(n), "outside_bound": len(outside),
                          "flips": [[f["field"], f["layer"], f["unit"], len(f["points"])]
                                    for f in flips]})
            units += len(flips)
            points += n
    return {"seeds": n_seeds, "cases": cases, "units": units, "points": points,
            "rate_units_per_point": units / points,
            "largest_units_per_point": max(c["units"] / c["points"] for c in cases),
            "largest_units": max(c["units"] for c in cases),
            "over_limit": [[c["enc"], c["seed"], c["units"], c["limit"]] for c in cases
                           if c["units"] > c["limit"]],
            "outside_bound": sum(c["outside_bound"] for c in cases)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--seeds", type=int, default=40)
    ap.add_argument("--out", default=None, help="write every over-gate seed's detail here")
    ap.add_argument("--survey", type=int, default=0,
                    help="measure the flip rate over this many parameter seeds instead")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    import test_torch_gpu as t
    from nerfca_tpu_torch.ops.cuda import fused_field as ff
    from nerfca_tpu_torch.train.step import param_items

    if not torch.cuda.is_available():
        print("gpu_check_seeds: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if args.survey:
        print(json.dumps(survey(t, ff, dev, args.survey)))
        return 0
    out = {"root": root, "seeds": args.seeds, "kernel_over_gate": [], "f64_over_gate": [],
           "flipped_units_by_seed": {}, "test_rule_failures": []}
    detail = []
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        fargs, leaves = t.make(dev, r=50, s=77, shared_z=True)
        ps, pt, o, d, z, ph, cfg_s, cfg_t, w_s, w_t = fargs
        names = t.leaf_names(ps, pt)
        with torch.no_grad():
            ref = ff.plain_composite_fields_rays(*fargs)
        cot = [torch.randn_like(x) for x in ref]  # as check() drew them
        _, k_g = t.grads(ff.fused_composite_fields_rays, fargs, leaves, cot)
        _, p_g = t.grads(ff.plain_composite_fields_rays, fargs, leaves, cot)
        params64 = {k: {"early": [{n: v.detach().double().requires_grad_(True)
                                   for n, v in layer.items()} for layer in fargs[k]["early"]],
                        "out": {n: v.detach().double().requires_grad_(True)
                                for n, v in fargs[k]["out"].items()},
                        **({"latents": fargs[k]["latents"].detach().double().requires_grad_(True)}
                           if "latents" in fargs[k] else {})}
                    for k in (0, 1)}
        args64 = (params64[0], params64[1], *(x.double() for x in fargs[2:5]), fargs[5],
                  *fargs[6:8], *(None if w is None else w.double() for w in fargs[8:]))
        leaves64 = [v for _, v in param_items({"static": params64[0], "temp": params64[1]})]
        _, p64_g = t.grads(ff.plain_composite_fields_rays, args64, leaves64,
                           [c.double() for c in cot])
        with torch.no_grad():
            pts = ff._points(o, d, z)
        phases = ph[:, None].expand(pts.shape[:2])
        rays = (o, d, z, ph.to(torch.int32), pt["latents"].detach())
        flips = t.relu_flips((ps, pt), (cfg_s, cfg_t), (w_s, w_t), rays, pts, phases)
        out["flipped_units_by_seed"][seed] = [[f["field"], f["layer"], f["unit"],
                                               len(f["points"])] for f in flips]
        try:
            with contextlib.redirect_stdout(io.StringIO()):  # the test prints its flips
                t.compare_grads(names, k_g, p_g, flips, phases.numel())
        except AssertionError as e:
            out["test_rule_failures"].append([seed, str(e)[:300]])
        for key, got, want in (("kernel_over_gate", k_g, p_g),
                               ("f64_over_gate", p_g, [g.float() for g in p64_g])):
            worst = max(shares(names, got, want, t.K2_REL))
            if worst[0] <= 1:
                continue
            out[key].append([seed, worst[1], round(worst[0], 4)])
            if key != "kernel_over_gate":
                continue
            # the offending element and its ReLU unit
            i = names.index(worst[1])
            err = (got[i] - want[i]).abs()
            idx = [int(v) for v in torch.nonzero(err == err.max())[0].tolist()]
            field, _, layer, kind = worst[1].split("/")
            layer, unit = int(layer), idx[0]
            pi, ci, wi = (ps, cfg_s, w_s) if field == "static" else (pt, cfg_t, w_t)
            p64 = {"early": [{k: v.detach().double() for k, v in lay.items()}
                             for lay in pi["early"]],
                   **{k: pi[k].detach().double() for k in ("latents", "fourier") if k in pi}}
            with torch.no_grad():
                pre32, _ = t.plain_preacts(pi, ci, pts, phases, wi)[layer]
                pre64, scale = t.plain_preacts(p64, ci, pts.double(), phases,
                                               None if wi is None else wi.double())[layer]
                packs = [ff._Pack(c, ff._leaves(p), ff.enc_table(p, c, w), dev)
                         for p, c, w in ((ps, cfg_s, w_s), (pt, cfg_t, w_t))]
                km = t.kernel_masks(packs, rays, layer)[0 if field == "static" else 1]
            m_k, m_32, m_64 = km[:, unit], pre32[:, unit] > 0, pre64[:, unit] > 0
            differ = torch.nonzero((m_k != m_32) | (m_k != m_64) | (m_32 != m_64)).flatten()
            bound = t.flip_bound(layer, pi["early"][layer]["w"].shape[1])
            detail.append({
                "seed": seed, "leaf": worst[1], "element": idx, "share_of_gate": worst[0],
                "error": float(err.max()), "field": field, "layer": layer, "unit": unit,
                "points_where_masks_differ": [
                    {"point": int(q), "pre64": float(pre64[q, unit]),
                     "pre32": float(pre32[q, unit]), "bound": bound * float(scale[q, unit]),
                     "kernel": bool(m_k[q]), "f32": bool(m_32[q]), "f64": bool(m_64[q])}
                    for q in differ.tolist()],
                "pre64_all_points": [float(v) for v in pre64[:, unit].tolist()]})
    out["over_gate_detail"] = [{k: v for k, v in d.items() if k != "pre64_all_points"}
                               for d in detail]
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**out, "over_gate_detail": detail}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
