"""ctypes bindings for the native host runtime, and the ``g++`` build.

``fusion_native.cpp`` is a copy of the JAX package's
``runtime/native/fusion_native.cpp`` (a test holds it byte-equal): the
PointCloud2 decode, a host z-clip, and the ASCII writers of the PCD table
and the metadata CSV.  It builds with ``g++`` at first use into
``hifi_fusion_tpu_torch/_build/``, with the JAX package's Makefile flags
(``-O3 -march=native -ffp-contract=off -fPIC -std=c++17``, and
``-fopenmp`` for the decode).  The library's name carries a digest of the
source, the flags and the host's CPU (``-march=native``), so a library
built on one host is never loaded on another; a build writes a file of its
own and moves it into place with ``os.replace``, so processes building at
once do not race.  A failed build raises: the port's decode and ASCII
writers have no silent fallback.  Their NumPy versions stay beside them
(``runtime/decode._decode_numpy``, ``io/pcd._write_*_numpy``) as the format
oracles the tests hold the library to.

ctypes releases the GIL for the length of each call, so a writer on one
thread runs beside Python on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parents[2]
BUILD_DIR = _PKG / "_build"
SOURCE = Path(__file__).resolve().parent / "fusion_native.cpp"

# runtime/native/Makefile of the JAX package
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
            "-std=c++17", "-Wall")
FLAGS = CXXFLAGS + ("-fopenmp", "-shared")

# wall seconds of each library built in this process, by stem
BUILD_SECONDS: Dict[str, float] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _host_cpu() -> str:
    """The host's CPU model and feature flags: what ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
        keep = []
        for key in ("model name", "flags"):
            keep += [ln for ln in lines if ln.startswith(key)][:1]
        if keep:
            return "\n".join(keep)
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path(source: Path, stem: str, flags: Sequence[str]) -> Path:
    """Where the library built from ``source`` with ``flags`` on this host
    lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(flags).encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_library(source: Path, stem: str, flags: Sequence[str]) -> Path:
    """Compile ``source`` with ``g++`` unless this host's library of the
    same source and flags exists; raises with the compiler's output when
    the build fails."""
    path = library_path(source, stem, flags)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.monotonic()
    out = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({out.returncode}) on {source}:\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    BUILD_SECONDS[stem] = time.monotonic() - t0
    return path


def load(source: Path, stem: str, flags: Sequence[str], bind) -> ctypes.CDLL:
    """The loaded library of ``stem``, built on first use; ``bind(lib)``
    declares its functions' argument and result types."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(source, stem, flags)))
            bind(lib)
            _libs[stem] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.hf_decode_xyzrgb.argtypes = [u8p, i64, i64, i64, i64, i64, i64,
                                     ctypes.c_int, f32p, f32p]
    lib.hf_decode_xyzrgb.restype = None
    lib.hf_zclip_compact.argtypes = [f32p, f32p, i64, ctypes.c_float,
                                     ctypes.c_float, f32p, f32p]
    lib.hf_zclip_compact.restype = i64
    lib.hf_write_ascii_table.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         f32p, i64, i64, ctypes.c_int]
    lib.hf_write_ascii_table.restype = ctypes.c_int
    lib.hf_write_metadata_csv.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          f64p, i64p, i64]
    lib.hf_write_metadata_csv.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The host runtime library, built on first use."""
    return load(SOURCE, "libfusion_native", FLAGS, _bind)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_xyzrgb(data: bytes, n_points: int, point_step: int,
                  off_x: int, off_y: int, off_z: int, off_rgb: int,
                  blue_shift_bug: bool = False):
    """``n_points`` interleaved records -> ((n,3) f32 xyz, (n,3) f32 rgb);
    ``off_rgb`` -1 when the records carry no colour (rgb zeros)."""
    lib = library()
    if len(data) < n_points * point_step or n_points < 0:
        raise ValueError(f"{len(data)} bytes hold fewer than {n_points} "
                         f"records of {point_step} bytes")
    if max(off_x, off_y, off_z, off_rgb) + 4 > point_step \
            or min(off_x, off_y, off_z) < 0:
        raise ValueError("a field lies outside the point record")
    buf = np.frombuffer(data, np.uint8)
    out_xyz = np.empty((n_points, 3), np.float32)
    out_rgb = np.empty((n_points, 3), np.float32)
    lib.hf_decode_xyzrgb(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_points, point_step, off_x, off_y, off_z, off_rgb,
        1 if blue_shift_bug else 0, _fptr(out_xyz), _fptr(out_rgb))
    return out_xyz, out_rgb


def zclip_compact(xyz: np.ndarray, rgb: np.ndarray, zmin: float,
                  zmax: float):
    """The (n,3) points with zmin < z < zmax and their colours, in order."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or rgb.shape != xyz.shape:
        raise ValueError(f"expected two (n,3) arrays, got {xyz.shape} "
                         f"and {rgb.shape}")
    out_xyz = np.empty_like(xyz)
    out_rgb = np.empty_like(rgb)
    m = lib.hf_zclip_compact(_fptr(xyz), _fptr(rgb), xyz.shape[0], zmin,
                             zmax, _fptr(out_xyz), _fptr(out_rgb))
    return out_xyz[:m], out_rgb[:m]


def write_pcd_ascii(path: str, header: str, cols: np.ndarray) -> None:
    """``header``, then one row of ``%.9g`` values per row of ``cols``."""
    lib = library()
    cols = np.ascontiguousarray(cols, np.float32)
    if cols.ndim != 2:
        raise ValueError(f"expected an (n,k) table, got {cols.shape}")
    rc = lib.hf_write_ascii_table(os.fsencode(path), header.encode(),
                                  _fptr(cols), cols.shape[0], cols.shape[1],
                                  0)
    if rc != 0:
        raise IOError(f"native ascii write failed for {path}")


def write_metadata_csv(path: str, header: str, cols5: np.ndarray,
                       count: np.ndarray) -> None:
    """``header``, then ``i,c0,..,c4,count`` rows (``%.6g`` of float64,
    byte-equal to the NumPy writer)."""
    lib = library()
    cols5 = np.ascontiguousarray(cols5, np.float64)
    count = np.ascontiguousarray(count, np.int64)
    if cols5.ndim != 2 or cols5.shape[1] != 5 \
            or count.shape != (cols5.shape[0],):
        raise ValueError(f"expected (n,5) and (n,), got {cols5.shape} and "
                         f"{count.shape}")
    rc = lib.hf_write_metadata_csv(
        os.fsencode(path), header.encode(),
        cols5.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols5.shape[0])
    if rc != 0:
        raise IOError(f"native csv write failed for {path}")
