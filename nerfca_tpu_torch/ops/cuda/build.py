"""Build and load the port's CUDA kernels.

Each ``nerfca_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface,
``build/kernels/lib<name>-<hash>.so``, and loaded with ``ctypes``. The hash
covers the source and the shared headers, so an edit rebuilds and an
unchanged source is never rebuilt. :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them together.

The kernels are built without ``--use_fast_math``: the loss math guards
with 1e-19 and 1e-10 constants that flush-to-zero and approximate
``logf``/division would move.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
HEADERS = ("field_common.cuh", "field_mma.cuh")
LIBRARIES = ("fused_field", "fused_train")
# per-library nvcc flags: the loss kernel keeps multiply and add separate
# (no FMA contraction) so its arithmetic matches the plain version's
EXTRA_FLAGS = {"fused_field": [], "fused_train": ["-fmad=false"]}

_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for f in (f"{name}.cu", *HEADERS):
        digest.update((CSRC / f).read_bytes())
    digest.update(" ".join(EXTRA_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=LIBRARIES, verbose: bool = False) -> dict:
    """Compile the named libraries that are not built yet, in parallel.
    Returns ``{name: (library path, nvcc's output)}``; raises if any
    ``nvcc`` fails. ``verbose`` adds ``-Xptxas -v`` (registers, spills)."""
    out, running = {}, []
    for name in names:
        lib = library_path(name)
        if lib.is_file():
            out[name] = (lib, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", *EXTRA_FLAGS[name],
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    errors = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu ({proc.returncode}):\n{log}")
            continue
        tmp.replace(lib)
        out[name] = (lib, log)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LOADED:
        path, _ = build((name,))[name]
        _LOADED[name] = ctypes.CDLL(str(path))
    return _LOADED[name]
