"""Builds, loads and counts the port's hand-written CUDA kernels.

Every source under ``hifi_fusion_tpu_torch/csrc/*.cu`` compiles with its
own ``nvcc -c`` call, all started together, and one link makes
``hifi_fusion_tpu_torch/_build/libhifi_kernels.so`` (``sm_90a``, a plain C
interface, no PyTorch headers), at first use and only from the sources in
the checkout.  The library is loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``.  A launcher
returns ``cudaGetLastError()`` and ``check`` raises when it is not 0.

``-fmad=false`` keeps every f32 multiply and add separately rounded, so
kernels whose results feed a ``floor`` or a strict comparison (K1's cell
ids, B6's line cells, K3's and B7's cylinder gate) agree bit for bit with
their plain versions (a fused multiply-add is written out as
``__fmaf_rn`` where the JAX package's jitted program has one);
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
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

LAUNCHES = {"depth_frontend": 0, "hash_insert": 0, "dep_stream": 0,
            "normal_fit": 0, "segscan": 0, "tsdf_lanes": 0,
            "tsdf_surface": 0, "planar_frontend": 0, "tsdf_lanes_planar": 0,
            "neighbor_count": 0, "route_pack": 0, "integrate_lanes": 0,
            "refine_lines": 0, "buffer_replay": 0, "tsdf_reduce": 0,
            "record_frontend": 0, "tsdf_sort": 0}

# the build's wall seconds and the ptxas register / shared-memory / spill
# report of the last build in this process (empty when loaded from disk)
BUILD_INFO = {"seconds": 0.0, "ptxas": ""}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_long
_SIGNATURES = {
    # depth, rgb565, counts, poses, rays, K, N, geo_f, geo_i, zmin, zmax,
    # world, ids, rgb, stream
    "launch_depth_frontend": [_P, _P, _P, _P, _P, _I, _I, _P, _P, _F, _F,
                              _P, _P, _P, _P],
    # keys, ids, n, n_live, capacity, max_probes, slots, n_failed, stream
    "launch_hash_insert": [_P, _P, _I, _P, _I, _I, _P, _P, _P],
    # pts, n, slots, key, normal, dep, dep_count, D, geo_f, geo_i, radius,
    # cyl_stats, stream
    "launch_dep_stream": [_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _F, _P,
                          _P],
    # cand, U, key, occ_bits, W, viewpoint, geo_f, geo_i, k, min_nb,
    # nvec, gated, normal, normal_found, stream
    "launch_normal_fit": [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P,
                          _P, _P, _P],
    # vals, starts, k, n, kind, out, summ, aux, stream
    "launch_segscan": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    # depth, rgb565, counts, poses, rays, K, N, S, step, half, geo_f,
    # geo_i, zmin, zmax, skey, vals, stream
    "launch_tsdf_lanes": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P,
                          _F, _F, _P, _P, _P],
    # points, point_wire, quant, rgb, rgb_wire, mask, mask_is_bool, poses,
    # K, N, geo_f, geo_i, zmin, zmax, world, ids, rgb_out, stream
    "launch_planar_frontend": [_P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _P,
                               _P, _F, _F, _P, _P, _P, _P],
    # rec, row_bytes, table, blue_shift, poses, K, N, geo_f, geo_i, zmin,
    # zmax, world, ids, rgb_out, stream
    "launch_record_frontend": [_P, _L, _P, _I, _P, _I, _I, _P, _P, _F, _F,
                               _P, _P, _P, _P],
    # points, rgb, mask, mask_is_bool, poses, K, N, S, step, half, geo_f,
    # geo_i, zmin, zmax, skey, vals, stream
    "launch_tsdf_lanes_planar": [_P, _P, _P, _I, _P, _I, _I, _I, _F, _F,
                                 _P, _P, _F, _F, _P, _P, _P],
    # slots, Q, key, capacity, occ_bits, W, geo_f, geo_i, k, out, stream
    "launch_neighbor_count": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P],
    # cell, order, E, key, vstats, capacity, max_probes, geo_f, geo_i,
    # centroid, normal, tsdf, weight, rgb, stream
    "launch_tsdf_surface": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P],
    # wire, pts, rgb, mask, mask_is_bool, poses, rays, K, N, geo_f, geo_i,
    # zmin, zmax, n, slab_w, halo, cnt, totals, tiers, ntiers, budget,
    # budget_host, stream
    "launch_route_count": [_I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _F,
                           _F, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P],
    # the count's arguments through totals, then budget, out, stream
    "launch_route_pack": [_I, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _F,
                          _F, _I, _I, _I, _P, _P, _P, _P, _P],
    # totals, budget, K, n, Bs_max, out, present, stream
    "launch_route_fill": [_P, _P, _I, _I, _I, _P, _P, _P],
    # sid, M, NA, extra_dropped, overflow_active, lane_run, uids, ustart,
    # scratch, words, stream
    "launch_integrate_lanes_cells": [_P, _L, _L, _I, _P, _P, _P, _P, _P,
                                     _L, _P],
    # NA, M, N, lane_run, uids, ustart, uslot, order, world, rgb, poses,
    # store_color, n_pts, normal_found, rgb_sum, viewpoint, occ_bits, pts,
    # slot_pt, buf_pts, buf_slot, buf_count, B, overflow_buf, scratch,
    # stream
    "launch_integrate_lanes_append": [_L, _L, _I, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _L, _P, _P, _P],
    # cand, U, L, line_k, res0, key, nvec, gated, geo_f, geo_i, lid, stream
    "launch_refine_lines_points": [_P, _I, _I, _I, _F, _P, _P, _P, _P, _P,
                                   _P, _P],
    # sid, P, lane_run, uids, ustart, scratch, words, stream
    "launch_refine_lines_cells": [_P, _L, _P, _P, _P, _P, _L, _P],
    # lane, lane_run, ustart, kslot, n_runs, P, U, L, cand, D, dep,
    # dep_count, overflow_dep, rebase, links, stream
    "launch_refine_lines_append": [_P, _P, _P, _P, _P, _L, _I, _I, _P, _I,
                                   _P, _P, _P, _P, _P, _P],
    # links, U, L, G, cand, nvec, key, bslot, bpts, bc, table, C, geo_f,
    # geo_i, radius, cyl_stats, stream
    "launch_buffer_replay": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                             _I, _P, _P, _F, _P, _P],
    # sid, order, vals6, M, U, uids, usums, overflow_unique, unique_cells,
    # scratch, words, aux, stream
    "launch_tsdf_reduce_runs": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _L,
                                _P, _P],
    # U, scratch (the live count), uslot, usums, vstats, stream
    "launch_tsdf_reduce_scatter": [_I, _P, _P, _P, _P, _P],
    # skey, M, n_cells, sid, order, alt_k, alt_i, scratch, words, tables,
    # table words, counts, stream
    "launch_tsdf_sort": [_P, _I, _I, _P, _P, _P, _P, _P, _L, _P, _L, _P,
                         _P],
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
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


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first that
    fails, else return their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libhifi_kernels.so`` unless a
    library built from the same sources and flags is already there: one
    ``nvcc -c`` per source, all started together, then one link."""
    stamp = BUILD_DIR / "libhifi_kernels.sha256"
    digest = _digest()
    if LIB_PATH.exists() and stamp.exists() \
            and stamp.read_text() == digest:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = os.getpid()
    nvcc = _nvcc()
    t0 = time.monotonic()
    objs, cmds = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{pid}.o"
        objs.append(obj)
        cmds.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    report = _run_all(cmds)
    tmp = BUILD_DIR / f"libhifi_kernels.{pid}.so"
    _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    BUILD_INFO.update(seconds=time.monotonic() - t0, ptxas=report)
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


def check_inputs(dev, *specs) -> None:
    """Raise ValueError unless every ``(name, tensor, dtype, shape)`` in
    ``specs`` has that dtype and shape and is contiguous on ``dev``: the
    check a wrapper makes before its kernel or its plain version."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")


def geometry_args(config, offset=None):
    """Host arrays for the launchers' ``geo_f`` (origin, resolution, bbox
    lower and upper corner, the f32 reciprocal resolution: 15 f32) and
    ``geo_i`` (dims and the shard's local -> global coordinate offset,
    zero for a single grid: 6 i32) pointers.  The arrays must stay
    referenced until the launch returns."""
    from ..ops.geometry import inv_resolution
    b = config.bbox
    f = np.asarray(list(config.origin) + list(config.resolution)
                   + [b[0], b[2], b[4], b[1], b[3], b[5]], np.float32)
    f = np.concatenate([f, inv_resolution(config)])
    i = np.asarray(list(config.dims) + list(offset or (0, 0, 0)), np.int32)
    return f, i


# lanes a tile of csrc/scan.cuh's run scan (RUN_SCAN_TILE) and of B3's
# pass B (csrc/integrate_lanes.cu B3_TILE); lanes a block of P2's segment
# ladder (csrc/segladder.cuh SEG_BS, ops/scatter.py BS)
RUN_SCAN_TILE = 4096
B3_TILE = 512
SEG_BS = 512


def lookback_words(n: int, tile: int) -> int:
    """The ints of scratch one look-back count scan over ``n`` lanes in
    tiles of ``tile`` lanes keeps (csrc/scan.cuh lookback_words): the tile
    counter, then each tile's aggregate and inclusive prefix, 64-bit
    words."""
    return 2 * (1 + 2 * max(-(-n // tile), 1))


# lanes a tile of T5's passes (csrc/tsdf_sort.cu T5_TILE), digits a pass,
# at most passes, and the most entries of the ranks' inverse (T5_INV_CAP)
SORT_TILE = 4096
SORT_RADIX = 256
SORT_MAX_PASSES = 4
SORT_INV_CAP = 1 << 22


def tsdf_sort_words(M: int, n_cells: int) -> int:
    """The ints of scratch T5 zeroes for a sort of M lanes of ids in [0,
    n_cells) (csrc/tsdf_sort.cu t5_layout): D, the pass count and the
    passes' tile counters; the passes' digit histograms; the rank scan's
    look-back; a status word (64-bit) a tile and digit."""
    W = -(-n_cells // 32)
    tiles = max(-(-M // SORT_TILE), 1)
    return (4 + 2 * SORT_MAX_PASSES + SORT_MAX_PASSES * SORT_RADIX
            + lookback_words(W, RUN_SCAN_TILE) + 2 * tiles * SORT_RADIX)


def tsdf_sort_tables(n_cells: int) -> tuple:
    """(ints, ints zero between sorts) of T5's tables over ``n_cells``
    cells (csrc/tsdf_sort.cu t5_tables): a bitmap word a 32 cells and a
    summary bit a bitmap word, which a sort leaves zero; a rank prefix a
    bitmap word and the ranks' inverse, at most ``SORT_INV_CAP``."""
    W = -(-n_cells // 32)
    W1 = -(-W // 32)
    return 2 * W + W1 + min(n_cells, SORT_INV_CAP), W + W1


def ptr(a) -> int:
    """Address of a host numpy array or a device tensor's data."""
    return a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()


def stream() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream
