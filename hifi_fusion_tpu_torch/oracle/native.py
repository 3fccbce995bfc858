"""ctypes wrapper for the C++ reference-equivalent oracle.

``oracle_native.cpp`` is a copy of the JAX package's
``oracle/oracle_native.cpp`` (a test holds it byte-equal).  It builds with
``g++`` at first use into ``hifi_fusion_tpu_torch/_build/`` as the host
runtime does (``runtime/native``: the JAX package's Makefile flags,
without ``-fopenmp``; a library keyed by source, flags and host CPU; a
failed build raises), so the oracle loads on a machine without JAX.

``NativeOracle`` mirrors the JAX package's ``OracleGrid`` API
(integrate_frame / refine / extract) at C++ speed: the full-sweep
reference ``chip_smoke.py`` holds the card's extract to, and the
single-threaded CPU baseline (the reference integrates serially; survey
§6).  ``NativeTsdfOracle`` is the TSDF family's (BASELINE config 5).
Nothing on the session's path imports this module.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..config import FusionConfig
from ..runtime import native as _native

SOURCE = Path(__file__).resolve().parent / "oracle_native.cpp"
FLAGS = _native.CXXFLAGS + ("-shared",)


def _bind(lib: ctypes.CDLL) -> None:
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.hf_oracle_create.argtypes = [f64p, f32p, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, i64p]
    lib.hf_oracle_create.restype = ctypes.c_void_p
    lib.hf_oracle_add_frame.argtypes = [ctypes.c_void_p, f32p, i64, f32p]
    lib.hf_oracle_add_frame.restype = None
    lib.hf_oracle_refine.argtypes = [ctypes.c_void_p]
    lib.hf_oracle_refine.restype = None
    lib.hf_oracle_set_reclaim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hf_oracle_set_reclaim.restype = None
    lib.hf_oracle_extract.argtypes = [ctypes.c_void_p, f32p, f32p, f64p,
                                      f64p, i64p, i64p, i64]
    lib.hf_oracle_extract.restype = i64
    lib.hf_oracle_n_voxels.argtypes = [ctypes.c_void_p]
    lib.hf_oracle_n_voxels.restype = i64
    lib.hf_oracle_destroy.argtypes = [ctypes.c_void_p]
    lib.hf_oracle_destroy.restype = None
    lib.hf_tsdf_create.argtypes = [f64p, f32p, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, i64p]
    lib.hf_tsdf_create.restype = ctypes.c_void_p
    lib.hf_tsdf_add_frame.argtypes = [ctypes.c_void_p, f32p, i64, f32p]
    lib.hf_tsdf_add_frame.restype = None
    lib.hf_tsdf_extract.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                    ctypes.c_float, i64p, f32p, f32p,
                                    i64]
    lib.hf_tsdf_extract.restype = i64
    lib.hf_tsdf_n_cells.argtypes = [ctypes.c_void_p]
    lib.hf_tsdf_n_cells.restype = i64
    lib.hf_tsdf_destroy.argtypes = [ctypes.c_void_p]
    lib.hf_tsdf_destroy.restype = None


def library() -> ctypes.CDLL:
    """The oracle library, built on first use."""
    return _native.load(SOURCE, "liboracle_native", FLAGS, _bind)


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _frame(points_cam, pose):
    """(N,3) f32 camera points and a (4,4) f32 pose, C-contiguous."""
    pts = np.ascontiguousarray(points_cam, np.float32)
    pose = np.ascontiguousarray(pose, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or pose.shape != (4, 4):
        raise ValueError(f"expected (N,3) points and a (4,4) pose, got "
                         f"{pts.shape} and {pose.shape}")
    return pts, pose


class NativeOracle:
    def __init__(self, config: FusionConfig):
        lib = library()
        self._lib = lib
        self.config = config
        bbox = np.asarray(config.bbox, np.float64)
        res = np.asarray(config.resolution, np.float32)
        dims = np.asarray(config.dims, np.int64)
        self._h = lib.hf_oracle_create(
            bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _f32p(res), config.z_clip[0], config.z_clip[1],
            config.cylinder_radius, config.k_neighborhood, config.line_k,
            config.min_neighbors,
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        lib.hf_oracle_set_reclaim(self._h,
                                  1 if config.reclaim_buffer else 0)

    def integrate_frame(self, points_cam: np.ndarray,
                        rgb: Optional[np.ndarray],
                        pose: np.ndarray) -> None:
        pts, pose = _frame(points_cam, pose)
        self._lib.hf_oracle_add_frame(self._h, _f32p(pts), pts.shape[0],
                                      _f32p(pose))

    def refine(self) -> None:
        self._lib.hf_oracle_refine(self._h)

    def n_voxels(self) -> int:
        return int(self._lib.hf_oracle_n_voxels(self._h))

    def extract(self, cap: int = 1 << 22) -> Dict[str, np.ndarray]:
        centroid = np.empty((cap, 3), np.float32)
        normal = np.empty((cap, 3), np.float32)
        sd = np.empty((cap, 3), np.float64)
        dist = np.empty((cap, 2), np.float64)
        count = np.empty(cap, np.int64)
        cell = np.empty(cap, np.int64)
        n = int(self._lib.hf_oracle_extract(
            self._h, _f32p(centroid), _f32p(normal),
            sd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            dist.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap))
        return {
            "cell": cell[:n].copy(),
            "centroid": centroid[:n].astype(np.float64),
            "normal": normal[:n].astype(np.float64),
            "sd": sd[:n].copy(),
            "mean_dist": dist[:n, 0].copy(),
            "sd_dist": dist[:n, 1].copy(),
            "count": count[:n].copy(),
        }

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.hf_oracle_destroy(self._h)
                self._h = None
        except Exception:
            pass


class NativeTsdfOracle:
    """Single-threaded C++ TSDF band integrator — the BASELINE config-5
    denominator.  Mirrors the JAX package's oracle/tsdf_oracle.py semantics
    (geometry path; color accumulation omitted, as in the flagship
    baseline timing)."""

    def __init__(self, tsdf_config):
        lib = library()
        self._lib = lib
        self.cfg = tsdf_config
        base = tsdf_config.base
        bbox = np.asarray(base.bbox, np.float64)
        res = np.asarray(base.resolution, np.float32)
        dims = np.asarray(base.dims, np.int64)
        self._h = lib.hf_tsdf_create(
            bbox.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _f32p(res), base.z_clip[0], base.z_clip[1],
            tsdf_config.truncation, tsdf_config.n_samples,
            dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))

    def integrate_frame(self, points_cam: np.ndarray,
                        pose: np.ndarray) -> None:
        pts, pose = _frame(points_cam, pose)
        self._lib.hf_tsdf_add_frame(self._h, _f32p(pts), pts.shape[0],
                                    _f32p(pose))

    def n_cells(self) -> int:
        return int(self._lib.hf_tsdf_n_cells(self._h))

    def extract(self, cap: int = 1 << 22) -> Dict[str, np.ndarray]:
        cell = np.empty(cap, np.int64)
        tsdf = np.empty(cap, np.float32)
        weight = np.empty(cap, np.float32)
        n = int(self._lib.hf_tsdf_extract(
            self._h, self.cfg.min_weight, self.cfg.surface_band,
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _f32p(tsdf), _f32p(weight), cap))
        n = min(n, cap)
        return {"cell": cell[:n].copy(), "tsdf": tsdf[:n].copy(),
                "weight": weight[:n].copy()}

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.hf_tsdf_destroy(self._h)
                self._h = None
        except Exception:
            pass
