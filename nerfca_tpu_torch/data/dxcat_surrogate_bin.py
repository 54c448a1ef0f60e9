#!/usr/bin/env python3
"""Stand-in ``dxcat1_bin``: the CLI contract of the proprietary XCAT
generator (``<bin> <par_file> <save_name>``, run with cwd = the XCAT data
dir), emitting ``<save_name>_atn_1.bin`` raw float32 volumes from
``nerfca_tpu_torch.data.xcat_surrogate`` (the port's counterpart of
``scripts/dxcat_surrogate_bin.py``; it imports only the port, and no torch).

Install by copying it to ``<xcat_path>/dxcat1_bin`` with the executable bit
set (:func:`install`); ``data/xcat.py::run_xcat_binary`` then invokes it
exactly as it would the real binary. The copy finds the repository through
``NERFCA_REPO`` (default: three directories above this file, which is
where it sits before the copy). The cardiac phase comes from the
``hrt_start_phase_index`` line of the par file (first tab-separated token,
the reference's override convention); ``noarteries`` in the save name
selects the artery-free paired run. The phase-static background is cached
beside the binary.

Env overrides for reduced-scale runs:
  XCAT_SURR_DIMS="64,64,50"  XCAT_SURR_DVOXEL="2.0"
"""
import os
import shutil
import sys


def install(xcat_path: str) -> str:
    """Copy this file to ``<xcat_path>/dxcat1_bin``, executable; returns
    the installed path."""
    os.makedirs(xcat_path, exist_ok=True)
    dst = os.path.join(xcat_path, "dxcat1_bin")
    shutil.copy(os.path.abspath(__file__), dst)
    os.chmod(dst, 0o755)
    return dst


def main() -> None:
    sys.path.insert(0, os.environ.get(
        "NERFCA_REPO", os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
    from nerfca_tpu_torch.data.xcat_surrogate import D_VOXEL_MM, XCAT_DIMS, write_bin

    par_file, save_name = sys.argv[1], sys.argv[2]
    phase = 0.0
    with open(par_file) as f:
        for line in f:
            if "hrt_start_phase_index" in line:
                phase = float(line.split("\t")[0])
                break
    dims, d_voxel = XCAT_DIMS, D_VOXEL_MM
    if os.environ.get("XCAT_SURR_DIMS"):
        dims = tuple(int(v) for v in os.environ["XCAT_SURR_DIMS"].split(","))
        d_voxel = float(os.environ.get("XCAT_SURR_DVOXEL", d_voxel))
    bg_cache = os.path.join(os.path.dirname(os.path.abspath(sys.argv[0])),
                            f"surrogate_bg_{'x'.join(map(str, dims))}.raw")
    write_bin(save_name, phase, with_arteries="noarteries" not in os.path.basename(save_name),
              bg_cache=bg_cache, dims=dims, d_voxel_mm=d_voxel)


if __name__ == "__main__":
    main()
