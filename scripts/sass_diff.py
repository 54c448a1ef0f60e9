#!/usr/bin/env python3
"""Compare the SASS of the field kernels with another copy of their source.

    python3 scripts/sass_diff.py --parent <dir holding an older csrc/> [--replaced REGEX ...]
                                 [--out sass.json]

Compiles ``fused_field.cu`` from ``nerfca_tpu_torch/csrc`` and from
``--parent`` to cubins with the device flags of ``ops/cuda/build.py``
(``sm_90a``, ``-O3``), disassembles both with ``cuobjdump -sass`` and
compares every kernel of the parent with its counterpart here instruction by
instruction (addresses and encodings dropped). A kernel that gained template
parameters since is paired by the parent's arguments followed by ``false``
for each new one: the parent's ``fwd_kernel<2, 32, NF, FOURIER>`` and
``bwd_kernel<NF, FOURIER>`` with ``fwd_kernel<2, 32, NF, FOURIER, false>``
and ``bwd_kernel<NF, FOURIER, false, false>`` here (the f32 instantiations,
without bf16 compute or bf16 residuals), and so on back to the older names.
A parent kernel that a change replaced on purpose is named by ``--replaced``
(a regular expression on the demangled name, searched): it is listed as
replaced and not compared. The f32 ``fwd_kernel`` instantiations gave way to
``fwd_kernel_wgmma``:

    python3 scripts/sass_diff.py --parent <dir> --replaced 'fwd_kernel<2, 32, [12], (true|false), false>'

Prints one JSON object (per kernel: identical or not, instruction counts,
the first differing line; branch labels are renamed per kernel, since their
numbers run across the whole cubin) and exits 1 when a pair differs or a
parent kernel that is not replaced has no counterpart. Needs ``nvcc`` and
``cuobjdump``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "nerfca_tpu_torch", "csrc")
CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
FAMILIES = ("fwd_kernel<", "bwd_kernel<", "reduce_kernel(")
MAX_NEW_PARAMS = 4


def tool(name: str) -> str:
    path = os.path.join(CUDA_BIN, name)
    return path if os.path.isfile(path) else name


def sass(csrc: str, workdir: str, tag: str) -> dict:
    """Demangled kernel name -> its instructions, for fused_field.cu in csrc."""
    cubin = os.path.join(workdir, f"{tag}.cubin")
    subprocess.run([tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-cubin", "-o", cubin, os.path.join(csrc, "fused_field.cu")],
                   check=True, capture_output=True, text=True)
    dump = subprocess.run([tool("cuobjdump"), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    names = subprocess.run([tool("cu++filt")], input="\n".join(
        re.findall(r"Function : (\S+)", dump)), capture_output=True, text=True).stdout.split("\n")
    kernels, current = {}, None
    mangled = iter(names)
    for line in dump.splitlines():
        if line.strip().startswith("Function :"):
            # template arguments demangle as "(int)2" or "(bool)0": keep
            # the value alone, a bool as its word
            current = (next(mangled).strip().replace("(int)", "")
                       .replace("(bool)0", "false").replace("(bool)1", "true"))
            kernels[current] = []
        elif current is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                kernels[current].append(m.group(1))
    return {k: relabel(v) for k, v in kernels.items()}


def relabel(lines: list) -> list:
    """Branch labels (``.L_x_N``, numbered across the whole cubin) renamed
    in their order of first use within the kernel."""
    seen: dict = {}

    def sub(m):
        return seen.setdefault(m.group(0), f".L{len(seen)}")

    return [re.sub(r"\.L_x_\d+", sub, line) for line in lines]


def counterpart(parent: str, kernels: dict):
    """The kernel here that is ``parent`` with zero or more ``false``
    template arguments appended (None if there is none)."""
    head, sep, tail = parent.partition(">(")
    if not sep:
        return parent if parent in kernels else None
    for extra in range(MAX_NEW_PARAMS + 1):
        name = head + ", false" * extra + ">(" + tail
        if name in kernels:
            return name
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory holding the older fused_field.cu")
    ap.add_argument("--replaced", action="append", default=[],
                    help="regex of parent kernels replaced on purpose (not compared)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as work:
        old, new = sass(args.parent, work, "parent"), sass(CSRC, work, "this")
    result, same = {"kernels_here": sorted(new)}, True
    for p_old in sorted(k for k in old if any(f in k for f in FAMILIES)):
        if any(re.search(r, p_old) for r in args.replaced):
            result.setdefault("replaced", []).append(p_old)
            continue
        p_new = counterpart(p_old, new)
        if p_new is None:
            result[p_old] = {"identical": False, "counterpart": None}
            same = False
            continue
        a, b = old[p_old], new[p_new]
        diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    None if len(a) == len(b) else min(len(a), len(b)))
        result[p_new.split("(")[0]] = {
            "parent": p_old, "identical": diff is None,
            "instructions": [len(a), len(b)],
            "first_difference": None if diff is None else
            [a[diff] if diff < len(a) else None, b[diff] if diff < len(b) else None]}
        same = same and diff is None
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
