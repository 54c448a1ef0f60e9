#!/usr/bin/env python3
"""Where the time of K1 in f32 goes on the card: builds variants of
``nerfca_tpu_torch/csrc/`` (text edits on a copy, as ``k2_variants.py``
does) and times K1 (``fwd_kernel_wsplit`` + ``fwd_kernel_wgmma``,
``csrc/k1_wgmma.cuh``) in each with CUDA events, in turns: ``ROUNDS``
passes over the builds, every other one in the reverse order (three passes
left the medians of two builds of the same work up to 2% apart). Prints
each build's ptxas lines for K1 (registers, spills) and each build's median
time a problem.

    python3 scripts/k1_variants.py [--parent DIR] [--out k1_variants.json]

Every variant on every problem (``chip_smoke``'s inputs, every band open):
  flagship  both 4x128 fields, 1024 rays x 500 samples (``check_kernels``)
  fourier   the pair on the fourier encoding, the same rays
  static    the one field of ``configs/3d.txt`` alone (NF = 1), the same rays
  fine      the pair at the fine pass's per-ray depths, 1024 x (500 + 128)
            (``check_kernels_fine``)

Variants:
  base         the source as it is
  per_field    K1's per-field units on every problem: the C entry never takes
               the shared units (one encoding of a tile pair for both fields)
  pingpong     the consumer warpgroups take turns to issue their groups
               (two named barriers, FlashAttention-3's ping-pong)
  one_pass     one TF32 product (big*big) instead of three: the tensor pipe's share
  no_mma       no products at all: what K1 spends outside them
  no_split     three products of unsplit operands (activations and weight
               planes): what the TF32 split of the activations costs
  no_encode    the encoder warps skip the encoding (each unit's one call,
               both fields' with the shared units): whether it hides under
               the products
  parent       with ``--parent DIR``: DIR's ``nerfca_tpu_torch/csrc`` as it is;
               a build from before the shared units takes no flag for them
               (the wrapper's last argument is then left unread) and runs
               its own units

The variants that compute K1 (base, per_field, pingpong, parent) must give base's
densities bit for bit on every problem, and base must lie within
``chip_smoke.K1_ATOL`` of the plain version; the others compute wrong
densities and only their times count.

Needs one CUDA device and nvcc; imports torch and this repository only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts.k2_variants import FF, MMA, build_variant  # noqa: E402

K1W = "k1_wgmma.cuh"
SPLIT = "  big = tf32_rna(x);\n  small = tf32_rna(x - __uint_as_float(big));\n"
PRODUCTS = ("wgmma_tf32(acc, a.small, k1w_desc(b));", "wgmma_tf32(acc, a.big, k1w_desc(b + 4096));",
            "wgmma_tf32(acc, a.big, k1w_desc(b));")
ENCODE = "k1w_encode<FOURIER>(f, r, tile_of(u), enc + eb * K1W_ENC_FLOATS, et);"
# FlashAttention-3's ping-pong: named barrier 1 + w (over both consumer
# warpgroups, 256 threads) is warpgroup w's turn to issue a group;
# warpgroup 1 hands warpgroup 0 the first turn, each passes the turn on once
# its group is committed, and warpgroup 1's last pass stays unanswered (a
# wait for it after the loop makes ptxas give the consumers the launch's 128
# registers, and they spill).
TURN_HELPERS = """__device__ __forceinline__ void k1w_turn_wait(int wg) {
  if (wg == 0) asm volatile("bar.sync 1, 256;\\n" ::: "memory");
  else asm volatile("bar.sync 2, 256;\\n" ::: "memory");
}

__device__ __forceinline__ void k1w_turn_pass(int wg) {
  if (wg == 0) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");
  else asm volatile("bar.arrive 2, 256;\\n" ::: "memory");
}

"""
GROUP_INPUT = "        const uint32_t b0 = take(0), b1 = kn > 2 ? take(1) : b0;\n        wgmma_fence();\n"
GROUP_HIDDEN = "          const uint32_t b0 = take(0), b1 = take(1);\n          wgmma_fence();\n"
COMMIT = "    wgmma_commit();\n    wgmma_wait<0>();\n"
PINGPONG = [
    (K1W, "__device__ __forceinline__ void wgmma_fence()",
     TURN_HELPERS + "__device__ __forceinline__ void wgmma_fence()"),
    (K1W, "  float acc[64], prev[64];\n", "  if (wg == 1) k1w_turn_pass(0);\n  float acc[64], prev[64];\n"),
    (K1W, GROUP_INPUT,
     GROUP_INPUT.replace("        wgmma_fence();", "        k1w_turn_wait(wg);\n        wgmma_fence();")),
    (K1W, GROUP_HIDDEN,
     GROUP_HIDDEN.replace("          wgmma_fence();", "          k1w_turn_wait(wg);\n          wgmma_fence();")),
    (K1W, COMMIT, "    wgmma_commit();\n    k1w_turn_pass(wg ^ 1);\n    wgmma_wait<0>();\n"),
]
# the C entry never takes the shared units
SHARED_UNITS = "  if (shared_enc) return launch_fwd_wgmma<2, false, true>"
VARIANTS = {
    "base": [],
    "per_field": [(FF, SHARED_UNITS, SHARED_UNITS.replace("shared_enc", "false"))],
    "pingpong": PINGPONG,
    "one_pass": [(K1W, PRODUCTS[0], ";"), (K1W, PRODUCTS[1], ";")],
    "no_mma": [(K1W, line, ";") for line in PRODUCTS],
    "no_split": [(MMA, SPLIT, "  big = __float_as_uint(x);\n  small = 0u;\n")],
    "no_encode": [(K1W, ENCODE, ";")],
}
CHECKED = ("base", "per_field", "pingpong", "parent")  # the variants that compute K1
PROBLEMS = ("flagship", "fourier", "static", "fine")
ROUNDS = 15  # passes over the builds, each timing every build once a problem


def build_parent(parent: str, workdir: str):
    """Starts nvcc on the parent's csrc as it is; returns (library path, process)."""
    from nerfca_tpu_torch.ops.cuda import build

    src = os.path.join(workdir, "parent")
    shutil.copytree(os.path.join(parent, "nerfca_tpu_torch", "csrc"), src)
    lib = os.path.join(src, "libfused_field.so")
    cmd = [build._nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
           os.path.join(src, FF)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def problem(name: str, dev):
    """(K1 on packed inputs, the plain version's densities) for one problem."""
    import torch

    import chip_smoke as cs
    from nerfca_tpu_torch.models.fields import init_static_field
    from nerfca_tpu_torch.ops import prng
    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    fourier = name == "fourier"
    cfg_s, cfg_t = cs.flagship_cfgs(fourier)
    params = cs.flagship_params(0, dev, fourier)
    if name == "fine":
        origins, dirs, z, phases = cs.fine_rays(params, 1024, 500, cs.FINE_SAMPLES, 0, dev)
    else:
        origins, dirs, z, phases = cs.flagship_rays(1024, 500, 0, dev)
    window = None if fourier else torch.ones(12, device=dev)
    ph32 = phases.to(torch.int32)
    if name == "static":
        cfg = cs.static_cfg()
        p = init_static_field(prng.key(0), cfg, dev)
        w = torch.ones(cfg.pos_enc_basis, device=dev)
        pack = ff._Pack(cfg, ff._leaves(p), ff.enc_table(p, cfg, w), dev)
        lat = torch.zeros(1, ff.MAX_LAT, device=dev)
        with torch.no_grad():
            want = (ff.plain_static_field(p, ff._points(origins, dirs, z), cfg, w),)
        return (lambda: ff.fused_field_fwd(pack, None, origins, dirs, z, ph32, lat)[:1]), want
    pack_s, pack_t = cs.packs(params, (cfg_s, cfg_t), window, dev)
    lat = params["temp"]["latents"].detach()
    with torch.no_grad():
        want = ff.plain_composite_fields_rays(params["static"], params["temp"], origins, dirs,
                                              z, phases, cfg_s, cfg_t, window, window)
    return (lambda: ff.fused_field_fwd(pack_s, pack_t, origins, dirs, z, ph32, lat)), want


def main() -> int:
    import tempfile

    import torch

    import chip_smoke as cs
    from nerfca_tpu_torch.ops.cuda import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose nerfca_tpu_torch/csrc is timed as variant 'parent'")
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
        if args.parent:
            started["parent"] = build_parent(args.parent, workdir)
        libs, ptxas = {}, {}
        for name, (lib, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            libs[name] = lib
            # the lines after K1's entries, up to the next entry
            k1_lines, in_k1 = [], False
            for line in log.splitlines():
                if "Compiling entry" in line:
                    in_k1 = "fwd_kernel_wgmma" in line
                elif in_k1 and ("registers" in line or "spill" in line):
                    k1_lines.append(line.split(":", 1)[-1].strip())
            ptxas[name] = k1_lines

        def bind(lib):
            ff._LIB = None
            load = build.load
            build.load = lambda name: ctypes.CDLL(lib)
            try:
                ff._lib()
            finally:
                build.load = load

        dev = torch.device("cuda")
        times, errors, bitwise = {}, {}, {}
        order = list(libs)
        for prob in PROBLEMS:
            k1, want = problem(prob, dev)
            outs = {}
            passes = [order if i % 2 == 0 else order[::-1] for i in range(ROUNDS)]
            for name in [n for one in passes for n in one]:
                bind(libs[name])
                with torch.no_grad():
                    got = k1()
                torch.cuda.synchronize()
                if name in CHECKED and name not in outs:
                    outs[name] = [t.clone() for t in got]
                with torch.no_grad():
                    times.setdefault(prob, {}).setdefault(name, []).append(
                        cs.cuda_time_ms(k1, iters=10))
            err = max(float((a - b.reshape(-1)).abs().max()) for a, b in zip(outs["base"], want))
            errors[prob] = err
            if not err <= cs.K1_ATOL:
                raise AssertionError(f"{prob}: K1 error {err:.3e} > {cs.K1_ATOL}")
            bitwise[prob] = {
                name: all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                          for a, b in zip(outs[name], outs["base"]))
                for name in outs}
            ff._LIB = None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for prob in PROBLEMS:
        print(f"{prob}: base max abs err {errors[prob]:.3e}")
        for name, ms in times[prob].items():
            same = f"  bitwise as base: {bitwise[prob][name]}" if name in bitwise[prob] else ""
            print(f"  {name:11s} median {statistics.median(ms):.4f} ms "
                  f"({', '.join(f'{t:.3f}' for t in ms)}){same}")
    for name in libs:
        print(f"ptxas {name}: {'; '.join(ptxas[name])}")
    result = {"card": card, "ms": times, "max_abs_err": errors, "bitwise_as_base": bitwise,
              "ptxas": ptxas}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    failed = [(p, n) for p in PROBLEMS for n, same in bitwise[p].items() if not same]
    if failed:
        print(f"k1_variants: not bitwise as base: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
