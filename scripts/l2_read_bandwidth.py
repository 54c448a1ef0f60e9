#!/usr/bin/env python3
"""The card's read bandwidth from L2 and from HBM, for the hash-field
kernel's roofline (``portbench/metrics/hash_roofline.py``).

    python3 scripts/l2_read_bandwidth.py

A Triton kernel streams a float32 buffer with L2-only loads (``.cg``: no
L1 hits), each program reading 16 KB blocks round the buffer, many passes
in one launch; CUDA events time 20 launches after 3 of warm-up. Buffers of
8 to 40 MB stay in the 50 MB L2 between passes, one of 4 GB comes from HBM.
Prints one line a buffer size and launch shape (GB/s), then the card's name
and power limit. Needs a CUDA device and the ``triton`` package.
"""

from __future__ import annotations

import subprocess


def main() -> None:
    import torch
    import triton
    import triton.language as tl

    @triton.jit
    def read_kernel(x_ptr, out_ptr, n_blocks, passes, BLOCK: tl.constexpr):
        pid, n_prog = tl.program_id(0), tl.num_programs(0)
        offs = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        for r in range(passes):
            block = (pid + r * n_prog) % n_blocks
            acc += tl.load(x_ptr + block * BLOCK + offs, cache_modifier=".cg")
        tl.store(out_ptr + pid * BLOCK + offs, acc)

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    block = 4096
    for mb in (8, 16, 24, 32, 40, 4096):
        n_blocks = mb * 2**20 // (4 * block)
        x = torch.rand(n_blocks * block, device=dev)
        for per_sm, warps in ((4, 4), (8, 8), (16, 4)):
            n_prog = sms * per_sm
            passes = max(1, (256 if mb < 1024 else 4) * n_blocks // n_prog)
            out = torch.empty(n_prog * block, device=dev)

            def launch():
                read_kernel[(n_prog,)](x, out, n_blocks, passes, BLOCK=block, num_warps=warps)

            for _ in range(3):
                launch()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for _ in range(20):
                launch()
            b.record()
            torch.cuda.synchronize()
            seconds = a.elapsed_time(b) / 20 * 1e-3
            gbs = n_prog * passes * block * 4 / seconds / 1e9
            print(f"buffer {mb} MB, {per_sm} programs an SM, {warps} warps: {gbs:.1f} GB/s",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
