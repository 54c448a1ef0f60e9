#!/usr/bin/env python3
"""How often the K2 check of ``tests/test_torch_gpu.py`` exceeds its gate,
by the seed of the global generator its cotangents come from.

    python3 scripts/gpu_check_seeds.py [--root .] [--seeds 40]

For each seed, the case of ``test_kernels_match_plain_shared_depths`` (50
rays x 77 samples, shared depths) as the test's ``check`` runs it: K1/K2
against the plain f32 version, each leaf's error as a share of its gate
(``K2_REL`` of max(leaf scale, 1e-2 x global max)). Beside it the same
shares for the plain f32 gradients against the plain f64 ones on the same
inputs, which no kernel enters. Prints one JSON line: the seeds over the
gate on each side, with the worst leaf and share. ``--root`` is the
checkout whose package and tests are used. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def shares(names, got, want, k2_rel: float) -> list:
    top = max(float(b.abs().max()) for b in want)
    return [(float((a - b).abs().max()) / (k2_rel * max(float(b.abs().max()), 1e-2 * top)), n)
            for n, a, b in zip(names, got, want)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--seeds", type=int, default=40)
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
    out = {"root": root, "seeds": args.seeds, "kernel_over_gate": [], "f64_over_gate": []}
    for seed in range(args.seeds):
        torch.manual_seed(seed)
        fargs, leaves = t.make(dev, r=50, s=77, shared_z=True)
        names = [n for n, _ in param_items({"static": fargs[0], "temp": fargs[1]})]
        with torch.no_grad():
            ref = ff.plain_composite_fields_rays(*fargs)
        cot = [torch.randn_like(x) for x in ref]  # as check() draws them
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
        for key, got, want in (("kernel_over_gate", k_g, p_g),
                               ("f64_over_gate", p_g, [g.float() for g in p64_g])):
            worst = max(shares(names, got, want, t.K2_REL))
            if worst[0] > 1:
                out[key].append([seed, worst[1], round(worst[0], 4)])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
