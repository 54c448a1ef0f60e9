#!/usr/bin/env python3
"""Where K2's time goes on the card: builds variants of
``nerfca_tpu_torch/csrc/fused_field.cu`` (text edits on a copy of ``csrc``),
times each at the flagship shapes (``chip_smoke.flagship_rays``: 1024 rays x
500 samples, both 4x128 fields, every band open) with CUDA events, in turns
and then in the reverse order, and prints the cycles each phase of K2 takes
on thread 0 of every CTA.

    python3 scripts/k2_variants.py [--out chiprun_out/k2_variants.json]

Variants (all but ``base`` compute wrong gradients; only their times count):
  base      the source as it is
  one_pass  one TF32 product instead of three: the tensor pipe's share
  no_mma    no products at all: what K2 spends outside them
  phases    ``base`` with ``clock64`` read at each phase boundary

Needs one CUDA device and nvcc; imports torch and this repository only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FF = "fused_field.cu"
MMA = "field_mma.cuh"
THREE = ("mma_tf32(acc[i][j], a[i].small, b[j].big);", "mma_tf32(acc[i][j], a[i].big, b[j].small);",
         "mma_tf32(acc[i][j], a[i].big, b[j].big);")

PHASES = ["ring start", "g + encode", "input copy + layer 0", "hidden layers forward",
          "output layer + dpre", "dW", "db", "ReLU mask", "dX", "barrier after dX",
          "ring top-up + D write", "latent cotangent", "layer-top barrier"]


def _phase_edits() -> list:
    pt = ("#define PT(i) do { if (threadIdx.x == 0) { long long _t = clock64(); "
          "k2_acc[i] += _t - k2_t0; k2_t0 = _t; } } while (0)\n")
    marks = [
        ("    WeightRing ring = ring_begin(f, ring_buf);\n", 0, "after"),
        ("  __syncthreads();\n  for (int t = threadIdx.x; t < BTP * (k_pad / 4); t += NTHREADS) {", 1, "mid"),
        ("  mma_layer_fwd<MT, WCH, BF16>(f, ring, H, f.b0, BF16 ? round16(k0) : k_pad, acc);\n", 2,
         "after"),
        ("  store_relu_frag(D, LDD, acc);", 3, "before"),
        ("  float* lat_w = ring.buf;", 4, "before"),
        ("    cp_async_wait<2>();  // H's copy; the next layer's weight may still be in flight\n"
         "    __syncthreads();\n", 12, "after"),
        ("                      part + (l > 0 ? L.wh + (long)(l - 1) * WIDTH * WIDTH : L.w0));\n", 5,
         "after"),
        ("    accumulate_db(D, part + (l > 0 ? L.bh + (long)(l - 1) * WIDTH : L.b0));\n", 6, "after"),
        ("      const int c = ring_acquire_pair(ring);", 7, "before"),
        ("      mma_dx<BF16>(D, ring.buf + ((c + (warp >> 2)) & 1) * WCH * LDW, acc);\n", 8,
         "after"),
        ("      __syncthreads();  // every read of D and of the ring is done\n", 9, "after"),
        ("    } else if (f.n_lat > 0) {", 10, "before"),
        ("        *lat_acc += s;\n      }\n", 11, "after"),
    ]
    edits = [
        (FF, '#include "field_mma.cuh"\n',
         '#include "field_mma.cuh"\n__device__ unsigned long long k2_prof[16];\n'
         "__shared__ unsigned long long k2_acc[16];\n__shared__ long long k2_t0;\n" + pt),
        (FF, "  float lat_acc = 0.f;\n  for (long tile",
         "  if (threadIdx.x == 0) { for (int i = 0; i < 16; ++i) k2_acc[i] = 0; k2_t0 = clock64(); }\n"
         "  float lat_acc = 0.f;\n  for (long tile"),
        (FF, "    fpart[grad_layout(f, r.n_phases).lat + threadIdx.x] += lat_acc;\n}",
         "    fpart[grad_layout(f, r.n_phases).lat + threadIdx.x] += lat_acc;\n"
         "  if (threadIdx.x == 0) for (int i = 0; i < 16; ++i) atomicAdd(&k2_prof[i], k2_acc[i]);\n}"),
        (FF, '}  // extern "C"',
         "int k2_prof_read(unsigned long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, k2_prof, sizeof(k2_prof));\n}\n"
         "int k2_prof_reset() {\n  unsigned long long z[16] = {0};\n"
         "  return (int)cudaMemcpyToSymbol(k2_prof, z, sizeof(z));\n}\n"
         '}  // extern "C"'),
    ]
    for anchor, i, where in marks:
        if where == "after":
            edits.append((FF, anchor, f"{anchor}PT({i});\n"))
        elif where == "before":
            edits.append((FF, anchor, f"PT({i});\n{anchor}"))
        else:
            head, tail = anchor.split("\n", 1)
            edits.append((FF, anchor, f"{head}\nPT({i});\n{tail}"))
    return edits


VARIANTS = {
    "base": [],
    "one_pass": [(MMA, THREE[0], ";"), (MMA, THREE[1], ";")],
    "no_mma": [(MMA, line, ";") for line in THREE],
    "phases": _phase_edits(),
}


def write_variant(name: str, edits: list, workdir: str) -> str:
    """Copies csrc into workdir/name and applies the edits (each anchor must
    occur exactly once); returns the copy's directory."""
    src = os.path.join(workdir, name)
    shutil.copytree(os.path.join(REPO, "nerfca_tpu_torch", "csrc"), src)
    for fname, old, new in edits:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: anchor not found once in {fname}: {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return src


def build_variant(name: str, edits: list, workdir: str):
    """Writes the variant and starts nvcc; returns (library path, process)."""
    from nerfca_tpu_torch.ops.cuda import build

    src = write_variant(name, edits, workdir)
    lib = os.path.join(src, "libfused_field.so")
    cmd = [build._nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
           os.path.join(src, FF)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from nerfca_tpu_torch.ops.cuda import build
    from nerfca_tpu_torch.ops.cuda import fused_field as ff

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"nvidia-smi: {card}", flush=True)

    workdir = tempfile.mkdtemp(prefix="k2_variants_")
    try:
        started = {name: build_variant(name, edits, workdir) for name, edits in VARIANTS.items()}
        libs, registers = {}, {}
        for name, (lib, proc) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            libs[name] = lib
            registers[name] = [line.split(":", 1)[1].strip() for line in log.splitlines()
                               if "registers" in line]

        dev = torch.device("cuda")
        cfg_s, cfg_t = cs.flagship_cfgs()
        params = cs.flagship_params(0, dev)
        origins, dirs, z, phases = cs.flagship_rays(1024, 500, 0, dev)
        window = torch.ones(12, device=dev)
        pack_s = ff._Pack(cfg_s, ff._leaves(params["static"]), window, dev)
        pack_t = ff._Pack(cfg_t, ff._leaves(params["temp"]), window, dev)
        ph32 = phases.to(torch.int32)
        lat = params["temp"]["latents"].detach()
        gen = torch.Generator(device=dev).manual_seed(1)
        g_s = torch.randn(origins.shape[0] * z.shape[-1], generator=gen, device=dev)
        g_t = torch.randn(origins.shape[0] * z.shape[-1], generator=gen, device=dev)

        def k2():
            return ff.fused_field_bwd(pack_s, pack_t, origins, dirs, z, ph32, lat, g_s, g_t)

        def bind(lib):
            ff._LIB = None
            load = build.load
            build.load = lambda name: ctypes.CDLL(lib)
            try:
                ff._lib()
            finally:
                build.load = load

        times = {}
        order = list(libs)
        for name in order + order[::-1]:
            bind(libs[name])
            times.setdefault(name, []).append(cs.cuda_time_ms(k2, iters=10))
        # the phase profile: one launch, cycles summed over CTAs
        lib = ctypes.CDLL(libs["phases"])
        bind(libs["phases"])
        k2()
        torch.cuda.synchronize()
        lib.k2_prof_reset()
        k2()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        lib.k2_prof_read(buf)
        ff._LIB = None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    n_ctas = min(ff.BWD_CTAS, 2 * -(-origins.shape[0] * z.shape[-1] // ff.BWD_TILE_POINTS))
    total = sum(buf)
    phases_out = {name: {"cycles_per_cta": buf[i] / n_ctas, "share": buf[i] / total}
                  for i, name in enumerate(PHASES)}
    for name, ms in times.items():
        print(f"{name:10s} ms {', '.join(f'{t:.3f}' for t in ms)}   {'; '.join(registers[name])}")
    print(f"phases (thread 0 of each of {n_ctas} CTAs, cycles per CTA, share):")
    for name, v in phases_out.items():
        print(f"  {name:24s} {v['cycles_per_cta']:12.0f} {100 * v['share']:6.2f}%")
    result = {"card": card, "ms": times, "registers": registers, "phases": phases_out,
              "cycles_per_cta": total / n_ctas}
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
