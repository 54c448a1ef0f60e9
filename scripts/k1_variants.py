#!/usr/bin/env python3
"""Where the time of K1 in f32 goes on the card: builds variants of
``nerfca_tpu_torch/csrc/`` (text edits on a copy, as ``k2_variants.py``
does) and times K1 (``fwd_kernel_wsplit`` + ``fwd_kernel_wgmma``,
``csrc/k1_wgmma.cuh``) in each at the flagship shapes of
``chip_smoke.check_kernels`` (1024 rays x 500 samples, both 4x128 fields,
every band open) with CUDA events, in turns and then in the reverse order.
Prints each build's ptxas lines for K1 (registers, spills).

    python3 scripts/k1_variants.py [--out k1_variants.json]

Variants (all but base compute wrong densities; only their times count):
  base       the source as it is
  one_pass   one TF32 product (big*big) instead of three: the tensor pipe's share
  no_mma     no products at all: what K1 spends outside them
  no_split   three products of unsplit operands (activations and weight
             planes): what the TF32 split of the activations costs
  no_encode  the encoder warps skip the encoding: whether it hides under
             the products

Needs one CUDA device and nvcc; imports torch and this repository only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.k2_variants import MMA, build_variant  # noqa: E402

K1W = "k1_wgmma.cuh"
SPLIT = "  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n"
PRODUCTS = ("wgmma_tf32(acc, a.small, k1w_desc(b));", "wgmma_tf32(acc, a.big, k1w_desc(b + 4096));",
            "wgmma_tf32(acc, a.big, k1w_desc(b));")
ENCODE = "k1w_encode<FOURIER>(f, r, tile_of(u), enc + eb * K1W_ENC_FLOATS, et);"
VARIANTS = {
    "base": [],
    "one_pass": [(K1W, PRODUCTS[0], ";"), (K1W, PRODUCTS[1], ";")],
    "no_mma": [(K1W, line, ";") for line in PRODUCTS],
    "no_split": [(MMA, SPLIT, "  big = __float_as_uint(x);\n  small = 0u;\n")],
    "no_encode": [(K1W, ENCODE, ";")],
}
CHECKED = ("base",)  # the variants that compute K1


def main() -> int:
    import shutil
    import tempfile

    import torch

    import chip_smoke as cs
    from nerfca_tpu_torch.ops.cuda import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"nvidia-smi: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    workdir = tempfile.mkdtemp(prefix="k1_variants_")
    try:
        started = {name: build_variant(name, edits, workdir) for name, edits in VARIANTS.items()}
        libs, ptxas = {}, {}
        for name, (lib, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            libs[name] = lib
            # the lines after K1's entry, up to the next entry
            k1_lines, in_k1 = [], False
            for line in log.splitlines():
                if "Compiling entry" in line:
                    in_k1 = "fwd_kernel_wgmma" in line
                elif in_k1 and ("registers" in line or "spill" in line):
                    k1_lines.append(line.split(":", 1)[-1].strip())
            ptxas[name] = k1_lines

        dev = torch.device("cuda")
        cfg_s, cfg_t = cs.flagship_cfgs()
        params = cs.flagship_params(0, dev)
        origins, dirs, z, phases = cs.flagship_rays(1024, 500, 0, dev)
        window = torch.ones(12, device=dev)
        pack_s = ff._Pack(cfg_s, ff._leaves(params["static"]), window, dev)
        pack_t = ff._Pack(cfg_t, ff._leaves(params["temp"]), window, dev)
        ph32 = phases.to(torch.int32)
        lat = params["temp"]["latents"].detach()
        fargs = (params["static"], params["temp"], origins, dirs, z, phases, cfg_s, cfg_t,
                 window, window)
        with torch.no_grad():
            want = ff.plain_composite_fields_rays(*fargs)

        def k1():
            return ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat)

        def bind(lib):
            ff._LIB = None
            load = build.load
            build.load = lambda name: ctypes.CDLL(lib)
            try:
                ff._lib()
            finally:
                build.load = load

        times, errors = {}, {}
        order = list(libs)
        for name in order + order[::-1]:
            bind(libs[name])
            got = k1()
            torch.cuda.synchronize()
            if name in CHECKED:
                errors[name] = max(float((a - b.reshape(-1)).abs().max())
                                   for a, b in zip(got, want))
                if not errors[name] <= cs.K1_ATOL:
                    raise AssertionError(f"{name}: K1 error {errors[name]:.3e} > {cs.K1_ATOL}")
            times.setdefault(name, []).append(cs.cuda_time_ms(k1, iters=10))
        ff._LIB = None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for name, ms in times.items():
        err = f"  max abs err {errors[name]:.3e}" if name in errors else ""
        print(f"{name:11s} ms {', '.join(f'{t:.3f}' for t in ms)}{err}  "
              f"ptxas {'; '.join(ptxas[name])}")
    result = {"card": card, "ms": times, "max_abs_err": errors, "ptxas": ptxas}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
