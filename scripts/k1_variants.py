#!/usr/bin/env python3
"""Where K1's time goes on the card: builds variants of
``nerfca_tpu_torch/csrc/`` (text edits on a copy, as ``k2_variants.py``
does) and times K1 in each at the flagship shapes of
``chip_smoke.check_kernels`` (1024 rays x 500 samples, both 4x128 fields,
every band open) with CUDA events, in turns and then in the reverse order.
Prints each build's ptxas lines for K1 (registers, spills).

    python3 scripts/k1_variants.py [--out k1_variants.json]

Variants (the last three compute wrong densities; only their times count):
  base       the source as it is (128-point tiles, 32-row weight chunks,
             two CTAs per SM)
  tile64     64-point tiles, 64-row weight chunks, two CTAs per SM
  tile128_c64  128-point tiles, 64-row weight chunks, one CTA per SM
  one_pass  one TF32 product instead of three: the tensor pipe's share
  no_mma    no products at all: what K1 spends outside them
  no_split  three products of unsplit operands: what the TF32 split costs

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

from scripts.k2_variants import FF, MMA, THREE, build_variant  # noqa: E402

SPLIT = "  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n"
TILE, CHUNK = "#define K1_TP 128 ", "#define K1_WCH 32 "
VARIANTS = {
    "base": [],
    "tile64": [(FF, TILE, "#define K1_TP 64 "), (FF, CHUNK, "#define K1_WCH 64 ")],
    "tile128_c64": [(FF, CHUNK, "#define K1_WCH 64 ")],
    "one_pass": [(MMA, THREE[0], ";"), (MMA, THREE[1], ";")],
    "no_mma": [(MMA, line, ";") for line in THREE],
    "no_split": [(MMA, SPLIT, "  big = __float_as_uint(x);\n  small = 0u;\n")],
}
CHECKED = ("base", "tile64", "tile128_c64")  # the variants that compute K1


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
                    in_k1 = "fwd_kernel" in line
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
