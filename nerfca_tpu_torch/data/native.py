"""ctypes bindings for the native C++ cone-beam projector (port of
``nerfca_tpu/data/native.py``).

``native/cone_projector.cc`` is a CPU (OpenMP) projector with the contract
of ``ops/projector.py::project_view``: the independent cross-check of the
card's projector, as it is of XLA's in the JAX package. It is compiled
with ``g++`` and ``native/Makefile``'s flags on first use into
``build/native/libcone_projector-<hash>.so`` (the hash covers the source
and the flags, so an edit rebuilds) and loaded with ``ctypes``.

The library is built under ``build/`` (git-ignored) and never in
``native/``: ``native/libcone_projector.so`` is a tracked file, which a
build in place would overwrite. :func:`is_available` says whether the
library builds and loads here; :func:`native_project_view` raises with the
compiler's output when it does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from nerfca_tpu_torch.geometry.rays import detector_rays

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "cone_projector.cc"
BUILD_DIR = REPO / "build" / "native"
# native/Makefile's CXXFLAGS and link step
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libcone_projector-{digest.hexdigest()[:12]}.so"


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (and ``_error`` set)
    when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        lib_path = library_path()
        try:
            if not lib_path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                # g++ itself, not $CXX: a CXX wrapper may lack OpenMP's spec file
                subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                               capture_output=True, text=True, timeout=300)
                tmp.replace(lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except subprocess.CalledProcessError as e:
            _error = f"g++ failed ({e.returncode}):\n{e.stdout}{e.stderr}"
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        lib.cone_project.argtypes = [
            fp,  # volume
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            fp,  # origins
            fp,  # dirs
            ctypes.c_int64,
            fp,  # depths
            ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # dvoxel
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # off (xyz)
            ctypes.c_int,
            fp,  # out
        ]
        lib.cone_project.restype = None
        lib.cone_projector_num_threads.restype = ctypes.c_int
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def padded_volume(volume: np.ndarray) -> np.ndarray:
    """The flat f32 volume followed by ``ny * nz + nz + 1`` zeros.

    The C source clamps a sample to ``n - 1 - 1e-6``, which f32 rounds to
    ``n - 1`` for ``n`` from ~64 up, and then reads the ``+1`` corner with
    weight 0: past the array's end on the last x slab. The zeroed tail
    keeps that read in memory and its product 0 (the JAX binding passes the
    bare array, which can read a NaN there or fault)."""
    vol = np.asarray(volume, np.float32)
    _, ny, nz = vol.shape
    buf = np.zeros(vol.size + ny * nz + nz + 1, np.float32)
    buf[:vol.size] = vol.ravel()
    return buf


def project_rays(volume: np.ndarray, origins: np.ndarray, dirs: np.ndarray, depths: np.ndarray,
                 d_voxel, off_xyz, mode: str = "ct") -> np.ndarray:
    """The C projector on ``[N, 3]`` rays at the shared ``depths``: the
    ``[N]`` line integrals (``ct``) or maxima (``mip``) through the
    (x, y, z)-indexed ``volume`` of pitch ``d_voxel`` centered at
    ``off_xyz``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native projector unavailable: {_error}")
    if mode not in ("ct", "mip"):
        raise ValueError(f"unknown projection mode {mode!r}")
    nx, ny, nz = np.shape(volume)
    buf = padded_volume(volume)
    o = np.ascontiguousarray(origins, np.float32).reshape(-1, 3)
    d = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
    z = np.ascontiguousarray(depths, np.float32)
    out = np.zeros(o.shape[0], np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.cone_project(
        buf.ctypes.data_as(fp), nx, ny, nz, o.ctypes.data_as(fp), d.ctypes.data_as(fp),
        ctypes.c_int64(o.shape[0]), z.ctypes.data_as(fp), z.shape[0],
        *(ctypes.c_float(float(v)) for v in d_voxel), *(ctypes.c_float(float(v)) for v in off_xyz),
        1 if mode == "mip" else 0, out.ctypes.data_as(fp),
    )
    return out


def native_project_view(volume: np.ndarray, geo_info: dict, theta_deg: float, phi_deg: float,
                        larm_deg: float = 0.0, n_samples: int = 1000,
                        mode: str = "ct") -> np.ndarray:
    """Project one view with the C++ projector on the host; the contract of
    ``ops.projector.project_view`` (returns the ``[W, H]`` image)."""
    origins, dirs = detector_rays(theta_deg, phi_deg, larm_deg, geo_info)
    w, h = (int(v) for v in geo_info["nDetector"])
    depths = np.linspace(float(geo_info["near_thresh"]), float(geo_info["far_thresh"]),
                         n_samples).astype(np.float32)
    off = np.asarray(geo_info["offOrigin"], np.float64)[::-1]
    return project_rays(volume, origins.numpy(), dirs.numpy(), depths, geo_info["dVoxel"], off,
                        mode).reshape(w, h)
