"""Builds, loads and counts the port's hand-written CUDA kernels.

Every source under ``hifi_fusion_tpu_torch/csrc/*.cu`` compiles in ONE
``nvcc`` call into ``hifi_fusion_tpu_torch/_build/libhifi_kernels.so``
(``sm_90a``, a plain C interface, no PyTorch headers), at first use and
only from the sources in the checkout.  The library is loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``.  A launcher
returns ``cudaGetLastError()`` and ``check`` raises when it is not 0.

``-fmad=false`` keeps every f32 multiply and add separately rounded, so
kernels whose results feed a ``floor`` or a strict comparison (K1's cell
ids, K3's cylinder gate) agree bit for bit with their plain versions;
``--use_fast_math`` is never used.

``LAUNCHES`` counts the launches of each kernel; the wrappers in ``ops/``
add one where they launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_PATH = BUILD_DIR / "libhifi_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

LAUNCHES = {"depth_frontend": 0, "hash_insert": 0, "dep_stream": 0,
            "normal_fit": 0}

# the build's wall seconds and the ptxas register / shared-memory / spill
# report of the last build in this process (empty when loaded from disk)
BUILD_INFO = {"seconds": 0.0, "ptxas": ""}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # depth, rgb565, counts, poses, rays, K, N, geo_f, geo_i, zmin, zmax,
    # world, ids, rgb, stream
    "launch_depth_frontend": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _F, _F,
                              _P, _P, _P, _P],
    # keys, ids, n, capacity, max_probes, slots, n_failed, stream
    "launch_hash_insert": [_P, _P, _I, _I, _I, _P, _P, _P],
    # pts, n, slots, key, normal, dep, dep_count, D, geo_f, geo_i, radius,
    # cyl_stats, stream
    "launch_dep_stream": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _F, _P,
                          _P],
    # cand, U, key, occ_bits, W, viewpoint, geo_f, geo_i, k, min_nb,
    # nvec, gated, normal, normal_found, stream
    "launch_normal_fit": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                          _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libhifi_kernels.so`` unless a
    library built from the same sources and flags is already there."""
    stamp = BUILD_DIR / "libhifi_kernels.sha256"
    digest = _digest()
    if LIB_PATH.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libhifi_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    BUILD_INFO.update(seconds=time.monotonic() - t0,
                      ptxas=proc.stdout + proc.stderr)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.hifi_error_string.argtypes = [ctypes.c_int]
            lib.hifi_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if rc != 0:
        msg = library().hifi_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")


def geometry_args(config):
    """Host arrays for the launchers' ``geo_f`` (origin, resolution, bbox
    lower and upper corner, 12 f32) and ``geo_i`` (dims, 3 i32) pointers.
    The arrays must stay referenced until the launch returns."""
    b = config.bbox
    f = np.asarray(list(config.origin) + list(config.resolution)
                   + [b[0], b[2], b[4], b[1], b[3], b[5]], np.float32)
    i = np.asarray(config.dims, np.int32)
    return f, i


def ptr(a) -> int:
    """Address of a host numpy array or a device tensor's data."""
    return a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
