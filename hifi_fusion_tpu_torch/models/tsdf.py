"""TSDF-weighted fusion (BASELINE config 5), the port's second model family.

The counterpart of ``hifi_fusion_tpu/models/tsdf.py`` for the depth wire
and the planar wire.  Each valid point places S samples along its camera
ray at the centered offsets ``(s - (S-1)/2) * step`` inside +-truncation;
a sample's cell accumulates ``[w, w*sdf, r, g, b, n_rgb]`` (w = 1, sdf =
-offset, the colour on the middle sample only).  One batch of K frames:

1. the sample lanes, kernel T2 (``tsdf_lanes``) on the depth wire or T2p
   (``tsdf_lanes_planar``) on the planar wire ((K,3,N) f32 camera points
   and colour with count prefixes or a lane mask): the lane test, the pose
   transform, ray, distance, direction, the S sample positions, their
   cell ids and the six values, lanes laid out ``k*S*N + s*N + n``;
2. one stable sort of the cell ids (``sort_lanes``);
3. kernel T4 (``tsdf_reduce``), from the sorted ids and the sort's order:
   the six channels gathered through the order, their per-cell sums by
   P2's segment ladder in the JAX package's association order (so the
   sums are bit-identical; kernel T1's ladder, ``csrc/segladder.cuh``),
   the first U runs (the U smallest ids; the rest are dropped and counted
   in ``overflow_unique``, as the JAX package's ``[:U]`` drops them)
   compacted on the card, their live count added into ``unique_cells``;
   find-or-insert of those ids, kernel K2 (``ops/hashing``), given their
   live count on the card; one scatter of the per-cell sums into
   ``vstats`` at the unique slots.  On the card a batch reads nothing back
   to the host, and no full-width plane of gathered values or running sums
   is written.

Each step runs the three as the spans ``tsdf.lanes``, ``tsdf.sort`` and
``tsdf.reduce`` (``utils/profiling.span``: host time in the calling
session's timers, a profiler range of the same name while one records).

Surface extraction (``extract_tsdf``) masks the cells with weight >=
min_weight and |tsdf| < surface_band * res, sorts them by id, and per
surface cell runs kernel T3 (``tsdf_surface``): the 6-neighbour hash
lookups, central or one-sided TSDF differences, the normal, the centroid
``center - tsdf * normal`` and the mean colour.

XLA on the CPU contracts two expressions of the JAX source into fused
multiply-adds inside jit: the sample position ``world + s*dirn`` is
``fma(s, dirn, world)`` and the squared ray length is ``fma(z, z, fma(y,
y, x*x))``; the port computes both that way (``__fmaf_rn`` in T2 and T2p,
``geometry.fma_f32`` in the plain version), so the lanes, and with the
scan's association order the grid's sums, are bit-identical to the JAX
package's.  XLA also turns the source's products with the 0/1 weight into
selects, so an invalid lane holds +0.0 in every channel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..config import FusionConfig
from ..io.pcd import _pack_rgb_float
from ..ops import geometry, hashing
from ..ops.integrate import _u16_to_i32
from ..ops.scatter import (segment_ends, segment_reduce_plain,
                           segment_starts)
from ..utils.profiling import span

BIG = torch.iinfo(torch.int32).max     # sort key of an invalid sample lane
# the grid's scalar counters and their dtypes; the JAX package's grid has
# all but ``unique_cells``
COUNTERS = {"overflow_probe": torch.int32, "overflow_unique": torch.int32,
            "unique_cells": torch.int64, "frames": torch.int32}


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """The JAX package's ``TsdfConfig`` fields and defaults.

    ``batch_unique``: distinct sample cells per K-frame batch (the batched
    step's U budget); 0 = K x 4 x ``max_unique_per_frame``.  Consecutive
    frames' truncation bands overlap heavily, so the union is well below K
    x the per-frame uniques: on the 0.8 mm config-5 sweep ~1.07 M cells a
    frame and 1.15-1.26 M distinct cells per K=8 batch, under the 2^21
    budget that tools/tsdf_bench.py runs with zero overflow."""
    base: FusionConfig
    truncation: float = 0.004      # truncation band tau (m)
    n_samples: int = 9             # samples along the ray inside +-tau
    min_weight: float = 3.0        # extraction weight gate
    surface_band: float = 1.0      # |tsdf| < surface_band * res -> surface
    batch_unique: int = 0


@dataclasses.dataclass
class TsdfGrid:
    """Hash table and per-cell sums, on one device, without scratch tails."""
    key: torch.Tensor              # (C,)  i32 dense cell id, -1 = empty
    vstats: torch.Tensor           # (6C,) f32 [Σw, Σw*sdf, Σr, Σg, Σb, n_rgb]
    overflow_probe: torch.Tensor   # () i32 inserts dropped (probe bound)
    overflow_unique: torch.Tensor  # () i32 sample cells dropped (U budget)
    unique_cells: torch.Tensor     # () i64 Σ over batches of the cells kept
    frames: torch.Tensor           # () i32

    @property
    def device(self) -> torch.device:
        return self.key.device


def tail(config: TsdfConfig) -> int:
    """The JAX grid's scratch-tail length (tsdf.py:65-71), which also caps
    the batched step's U budget."""
    return max(config.base.scatter_tail,
               min(config.n_samples * config.base.max_points,
                   4 * config.base.max_unique_per_frame),
               config.batch_unique)


def make_tsdf_grid(config: TsdfConfig, device) -> TsdfGrid:
    device = torch.device(device)
    C = config.base.capacity
    zero = {f: torch.zeros((), dtype=dt, device=device)
            for f, dt in COUNTERS.items()}
    return TsdfGrid(
        key=torch.full((C,), -1, dtype=torch.int32, device=device),
        vstats=torch.zeros((6 * C,), dtype=torch.float32, device=device),
        **zero)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _sample_step(config: TsdfConfig):
    """(step, half): offset s = (s_index - half) * step in f32, with step
    computed in f64 on the host and cast (tsdf.py:111-112)."""
    S = config.n_samples
    return np.float32(2.0 * config.truncation / (S - 1)), \
        np.float32((S - 1) / 2.0)


# -- sample lanes (kernels T2 and T2p) -------------------------------------

def _sample_lanes_plain(pc, ok, rgb, poses, config):
    """The sample map shared by both wires: (K,3,N) f32 camera points,
    (K,N) bool lane test (without the z clip), (3,K,N) f32 colour and
    (K,4,4) poses -> ``(skey, vals6)``, lane ``k*S*N + s*N + n``."""
    cfg = config.base
    K, _, N = pc.shape
    S = config.n_samples
    dev = pc.device
    f32 = torch.float32
    ok = (ok & (pc[:, 2] > _f32(cfg.z_clip[0], dev))
          & (pc[:, 2] < _f32(cfg.z_clip[1], dev)))            # (K,N)
    world = geometry.transform_points(pc, poses)              # (K,3,N)
    ray = world - poses[:, :3, 3, None]
    x, y, z = ray[:, 0], ray[:, 1], ray[:, 2]
    dist = torch.sqrt(geometry.fma_f32(z, z, geometry.fma_f32(y, y,
                                                              x * x)))
    dirn = ray / torch.maximum(dist, _f32(1e-6, dev))[:, None]
    step, half = _sample_step(config)
    s = (torch.arange(S, dtype=f32, device=dev) - _f32(half, dev)) \
        * _f32(step, dev)                                     # (S,)
    w3 = world.transpose(0, 1)[:, :, None, :]                 # (3,K,1,N)
    pos = geometry.fma_f32(s[None, None, :, None],
                           dirn.transpose(0, 1)[:, :, None, :], w3)
    coords = geometry.cell_coords(pos, cfg)                   # (3,K,S,N)
    valid = (ok[:, None, :] & geometry.valid_points(pos, cfg)
             & geometry.valid_coords(coords, cfg))            # (K,S,N)
    skey = torch.where(valid, geometry.cell_id(coords, cfg),
                       torch.full_like(valid, BIG, dtype=torch.int32))
    # XLA turns the JAX source's products with a 0/1 weight into selects,
    # so an invalid lane holds +0.0 in every channel
    zero = _f32(0.0, dev)
    cm = valid & (torch.arange(S, device=dev) == S // 2)[None, :, None]
    vals6 = torch.stack([valid.to(f32),
                         torch.where(valid, (-s)[None, :, None], zero),
                         torch.where(cm, rgb[0][:, None, :], zero),
                         torch.where(cm, rgb[1][:, None, :], zero),
                         torch.where(cm, rgb[2][:, None, :], zero),
                         cm.to(f32)], dim=0)
    M = K * S * N
    return skey.reshape(M), vals6.reshape(6, M)


def tsdf_lanes_plain(depth, rgb565, counts, poses, rays, config):
    K, N = depth.shape
    dev = depth.device
    f32 = torch.float32
    d = _u16_to_i32(depth)
    pc = d.to(f32)[:, None, :] * rays[None]                  # (K,3,N)
    lane = torch.arange(N, device=dev, dtype=torch.int32)
    ok = (lane[None, :] < counts[:, None]) & (d > 0)
    v = _u16_to_i32(rgb565)
    rgb = torch.stack([((v >> 11) & 0x1F).to(f32) * 8.0,
                       ((v >> 5) & 0x3F).to(f32) * 4.0,
                       (v & 0x1F).to(f32) * 8.0], dim=0)      # (3,K,N)
    return _sample_lanes_plain(pc, ok, rgb, poses, config)


def tsdf_lanes(depth: torch.Tensor, rgb565: torch.Tensor,
               counts: torch.Tensor, poses: torch.Tensor, rays: torch.Tensor,
               config: TsdfConfig):
    """(K,N) u16 depth and rgb565, (K,) i32 counts, (K,4,4) f32 poses,
    (3,N) f32 rays -> ``(skey (K*S*N,) i32 cell id or INT32_MAX, vals6
    (6, K*S*N) f32)``, lane ``k*S*N + s*N + n``.  Kernel T2 on CUDA tensors,
    its plain version on CPU tensors; bit-identical."""
    K, N = depth.shape
    dev = depth.device
    kernels.check_inputs(
        dev,
        ("depth", depth, torch.uint16, (K, N)),
        ("rgb565", rgb565, torch.uint16, (K, N)),
        ("counts", counts, torch.int32, (K,)),
        ("poses", poses, torch.float32, (K, 4, 4)),
        ("rays", rays, torch.float32, (3, N)))
    if dev.type == "cpu":
        return tsdf_lanes_plain(depth, rgb565, counts, poses, rays, config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S = config.n_samples
    M = K * S * N
    skey = torch.empty((M,), dtype=torch.int32, device=dev)
    vals6 = torch.empty((6, M), dtype=torch.float32, device=dev)
    if M == 0:
        return skey, vals6
    step, half = _sample_step(config)
    cfg = config.base
    gf, gi = kernels.geometry_args(cfg)
    lib = kernels.library()
    kernels.check(lib.launch_tsdf_lanes(
        depth.data_ptr(), rgb565.data_ptr(), counts.data_ptr(),
        poses.data_ptr(), rays.data_ptr(), K, N, S, float(step),
        float(half), kernels.ptr(gf), kernels.ptr(gi),
        float(cfg.z_clip[0]), float(cfg.z_clip[1]), skey.data_ptr(),
        vals6.data_ptr(), kernels.stream()), "tsdf_lanes")
    kernels.LAUNCHES["tsdf_lanes"] += 1
    return skey, vals6


def tsdf_lanes_planar_plain(points, rgb, mask, poses, config):
    K, _, N = points.shape
    if mask.dtype == torch.bool:
        ok = mask
    else:
        lane = torch.arange(N, device=points.device, dtype=torch.int32)
        ok = lane[None, :] < mask[:, None]
    return _sample_lanes_plain(points, ok, rgb.transpose(0, 1), poses,
                               config)


def tsdf_lanes_planar(points: torch.Tensor, rgb: torch.Tensor,
                      mask: torch.Tensor, poses: torch.Tensor,
                      config: TsdfConfig):
    """(K,3,N) f32 camera points and colour, a (K,) i32 count prefix or a
    (K,N) bool lane mask, (K,4,4) f32 poses -> ``(skey (K*S*N,) i32 cell
    id or INT32_MAX, vals6 (6, K*S*N) f32)``, lane ``k*S*N + s*N + n``:
    the JAX package's ``_tsdf_lanes`` vmapped over K frames
    (tsdf.py:86-132, 206-210).  Kernel T2p on CUDA tensors, its plain
    version on CPU tensors; bit-identical."""
    K, _, N = points.shape
    dev = points.device
    mshape = (K, N) if mask.dtype == torch.bool else (K,)
    mtype = torch.bool if mask.dtype == torch.bool else torch.int32
    kernels.check_inputs(
        dev,
        ("points", points, torch.float32, (K, 3, N)),
        ("rgb", rgb, torch.float32, (K, 3, N)),
        ("mask", mask, mtype, mshape),
        ("poses", poses, torch.float32, (K, 4, 4)))
    if dev.type == "cpu":
        return tsdf_lanes_planar_plain(points, rgb, mask, poses, config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S = config.n_samples
    M = K * S * N
    skey = torch.empty((M,), dtype=torch.int32, device=dev)
    vals6 = torch.empty((6, M), dtype=torch.float32, device=dev)
    if M == 0:
        return skey, vals6
    step, half = _sample_step(config)
    cfg = config.base
    gf, gi = kernels.geometry_args(cfg)
    lib = kernels.library()
    kernels.check(lib.launch_tsdf_lanes_planar(
        points.data_ptr(), rgb.data_ptr(), mask.data_ptr(),
        int(mask.dtype == torch.bool), poses.data_ptr(), K, N, S,
        float(step), float(half), kernels.ptr(gf), kernels.ptr(gi),
        float(cfg.z_clip[0]), float(cfg.z_clip[1]), skey.data_ptr(),
        vals6.data_ptr(), kernels.stream()), "tsdf_lanes_planar")
    kernels.LAUNCHES["tsdf_lanes_planar"] += 1
    return skey, vals6


# -- reduce (kernel T4) and integrate -------------------------------------

def sort_lanes(skey: torch.Tensor):
    """Sample lanes -> ``(sid (M,) i32 sorted stably, INT32_MAX last,
    order (M,) i64)``: the JAX package's one sort of the batch
    (tsdf.py:146-150), whose payload T4 gathers through ``order``."""
    return torch.sort(skey, stable=True)


def tsdf_reduce_plain(grid: TsdfGrid, sid, order, vals6, U: int,
                      config: TsdfConfig) -> TsdfGrid:
    """Plain version of T4: the six channels gathered in sorted order,
    their running sums by T1's plain ladder (``segment_reduce_plain``),
    the run starts and ends as masks, the first U of each by
    ``torch.nonzero`` (two reads back to the host) and the run count (a
    third), K2, one ``index_add_`` of the placed cells' sums."""
    C = config.base.capacity
    svalid = sid != BIG
    starts = segment_starts(sid, svalid)
    sums6 = segment_reduce_plain(vals6[:, order], starts, "add")
    spos = torch.nonzero(starts).squeeze(1)
    epos = torch.nonzero(segment_ends(sid, svalid)).squeeze(1)
    grid.overflow_unique += max(spos.numel() - U, 0)
    grid.unique_cells += min(spos.numel(), U)
    uids = sid[spos[:U]]
    usums = sums6[:, epos[:U]]
    uslot = hashing.lookup_or_insert(grid.key, uids, config.base.max_probes,
                                     C, grid.overflow_probe)
    placed = uslot >= 0
    grid.vstats.view(C, 6).index_add_(0, uslot[placed].long(),
                                      usums[:, placed].t())
    return grid


def tsdf_reduce(grid: TsdfGrid, sid: torch.Tensor, order: torch.Tensor,
                vals6: torch.Tensor, U: int, config: TsdfConfig) -> TsdfGrid:
    """The batch's sorted ids and the sort's order (``sort_lanes``) and
    its (6,M) sample values in lane order -> the grid update in place
    (tsdf.py:146-182): each cell's six sums in the JAX package's ladder
    order, the first U distinct cells (the smallest ids; the rest are
    dropped and counted in ``overflow_unique``), their find-or-insert (K2,
    failures into ``overflow_probe``) and one add of each placed cell's
    six sums into ``vstats``.  Does not count frames.

    Kernel T4 (``csrc/tsdf_reduce.cu``, counted as ``tsdf_reduce``) with
    K2 on CUDA tensors, reading nothing back to the host: a memset, the
    runs pass (the gather through ``order``, the segment ladder and a
    look-back run scan that compacts the first U runs' ids and sums and
    leaves their live count on the card) and the carries of the runs that
    cross a ladder block before K2, the scatter after it.  Its plain
    version on CPU tensors.  The slots may differ (K2's CAS race); the
    grid is the same by cell id, ``vstats`` bit for bit."""
    M = sid.numel()
    dev = sid.device
    kernels.check_inputs(dev, ("sid", sid, torch.int32, (M,)),
                         ("order", order, torch.int64, (M,)),
                         ("vals6", vals6, torch.float32, (6, M)))
    if not 0 <= U <= M or grid.device != dev:
        raise ValueError(f"U {U} of {M} lanes, grid on {grid.device}")
    if dev.type == "cpu":
        return tsdf_reduce_plain(grid, sid, order, vals6, U, config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if M >= 2 ** 31 - 2 * kernels.RUN_SCAN_TILE:
        raise ValueError(f"{M} lanes: T4 indexes lanes in 32 bits")
    words = 2 + kernels.lookback_words(M, kernels.RUN_SCAN_TILE)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    # per 512-lane ladder block: its six summaries, flag-OR and carry
    aux = torch.empty((8, max(-(-M // kernels.SEG_BS), 1)),
                      dtype=torch.int32, device=dev)
    uids = torch.empty((U,), dtype=torch.int32, device=dev)
    usums = torch.empty((6, U), dtype=torch.float32, device=dev)
    lib = kernels.library()
    st = kernels.stream()
    kernels.check(lib.launch_tsdf_reduce_runs(
        sid.data_ptr(), order.data_ptr(), vals6.data_ptr(), M, U,
        uids.data_ptr(), usums.data_ptr(), grid.overflow_unique.data_ptr(),
        grid.unique_cells.data_ptr(), scratch.data_ptr(), words,
        aux.data_ptr(), st), "tsdf_reduce")
    if U:
        uslot = hashing.lookup_or_insert(grid.key, uids,
                                         config.base.max_probes,
                                         config.base.capacity,
                                         grid.overflow_probe,
                                         n_live=scratch[0])
        kernels.check(lib.launch_tsdf_reduce_scatter(
            U, scratch.data_ptr(), uslot.data_ptr(), usums.data_ptr(),
            grid.vstats.data_ptr(), st), "tsdf_reduce")
    kernels.LAUNCHES["tsdf_reduce"] += 1
    return grid


def _reduce(grid: TsdfGrid, skey, vals6, K: int, U: int,
            config: TsdfConfig) -> TsdfGrid:
    """The lanes of K frames into the grid with budget U: the spans
    ``tsdf.sort`` and ``tsdf.reduce``."""
    with span("tsdf.sort"):
        sid, order = sort_lanes(skey)
    with span("tsdf.reduce"):
        tsdf_reduce(grid, sid, order, vals6, U, config)
    grid.frames += K
    return grid


def _reduce_batch(grid: TsdfGrid, skey, vals6, K: int,
                  config: TsdfConfig) -> TsdfGrid:
    """A K-frame batch's lanes into the grid; U follows tsdf.py:211-213."""
    U = min(config.batch_unique
            or K * 4 * config.base.max_unique_per_frame,
            skey.shape[0], tail(config))
    return _reduce(grid, skey, vals6, K, U, config)


def _reduce_frame(grid: TsdfGrid, skey, vals6,
                  config: TsdfConfig) -> TsdfGrid:
    """One frame's lanes into the grid; U follows tsdf.py:188."""
    U = min(4 * config.base.max_unique_per_frame, skey.shape[0])
    return _reduce(grid, skey, vals6, 1, U, config)


def integrate_tsdf_batch_depth(grid: TsdfGrid, depth, rgb565, counts,
                               poses, rays, config: TsdfConfig) -> TsdfGrid:
    """K depth frames ((K,N) u16 depth and rgb565, (K,) i32 counts,
    (K,4,4) poses) in one sort / scan / insert / scatter pass, in place."""
    with span("tsdf.lanes"):
        skey, vals6 = tsdf_lanes(depth, rgb565, counts, poses, rays, config)
    return _reduce_batch(grid, skey, vals6, depth.shape[0], config)


def integrate_tsdf_depth(grid: TsdfGrid, depth, rgb565, count, pose, rays,
                         config: TsdfConfig) -> TsdfGrid:
    """One depth frame ((N,) u16 depth and rgb565, 0-d i32 count, (4,4)
    pose), in place."""
    with span("tsdf.lanes"):
        skey, vals6 = tsdf_lanes(depth[None], rgb565[None],
                                 count.reshape(1), pose[None], rays, config)
    return _reduce_frame(grid, skey, vals6, config)


def integrate_tsdf_batch(grid: TsdfGrid, points, rgb, mask, poses,
                         config: TsdfConfig) -> TsdfGrid:
    """K planar frames ((K,3,N) f32 camera points and colour, (K,N) bool
    mask or (K,) i32 count prefixes, (K,4,4) poses) in one sort / scan /
    insert / scatter pass, in place (tsdf.py:192-215)."""
    with span("tsdf.lanes"):
        skey, vals6 = tsdf_lanes_planar(points, rgb, mask, poses, config)
    return _reduce_batch(grid, skey, vals6, poses.shape[0], config)


def integrate_tsdf(grid: TsdfGrid, points, rgb, mask, pose,
                   config: TsdfConfig) -> TsdfGrid:
    """One planar frame ((3,N) f32 camera points and colour, (N,) bool
    mask or 0-d i32 count, (4,4) pose), in place (tsdf.py:185-189)."""
    mask = mask.reshape(1) if mask.dim() == 0 else mask[None]
    with span("tsdf.lanes"):
        skey, vals6 = tsdf_lanes_planar(points[None], rgb[None], mask,
                                        pose[None], config)
    return _reduce_frame(grid, skey, vals6, config)


# -- surface extraction (kernel T3) ----------------------------------------

@dataclasses.dataclass
class TsdfExtract:
    n_valid: int
    cell: torch.Tensor       # (E,)  i32 ascending dense ids
    centroid: torch.Tensor   # (3,E) f32 surface-projected position
    normal: torch.Tensor     # (3,E) f32 TSDF-gradient normal
    tsdf: torch.Tensor       # (E,)  f32 weighted mean signed distance
    weight: torch.Tensor     # (E,)  f32
    rgb: torch.Tensor        # (3,E) f32


def _mean_sdf(vstats: torch.Tensor, C: int) -> torch.Tensor:
    v2 = vstats.view(C, 6)
    return v2[:, 1] / torch.maximum(v2[:, 0], _f32(1e-9, vstats.device))


def tsdf_surface_plain(cell, order, grid, config):
    cfg = config.base
    C = cfg.capacity
    dev = cell.device
    f32 = torch.float32
    v2 = grid.vstats.view(C, 6)
    tsdf_all = _mean_sdf(grid.vstats, C)
    coords = geometry.id_to_coords(cell, cfg)                 # (3,E)
    center = geometry.cell_center(coords, cfg)
    o = order.long()
    t_here = tsdf_all[o]
    res = cfg.resolution
    grads = []
    for axis in range(3):
        vals = []
        for sign in (1, -1):
            cc = coords.clone()
            cc[axis] += sign
            ok = geometry.valid_coords(cc, cfg)
            sl = torch.full_like(cell, -1)
            sl[ok] = hashing.lookup(grid.key, geometry.cell_id(cc[:, ok],
                                                               cfg),
                                    cfg.max_probes, C)
            safe = sl.clamp(min=0).long()
            has = (sl >= 0) & (v2[safe, 0] > 0)
            vals.append((torch.where(has, tsdf_all[safe], t_here), has))
        (fp, okp), (fm, okm) = vals
        across = (okp.to(f32) + okm.to(f32)) * _f32(res[axis], dev)
        grads.append((fp - fm) / torch.maximum(across, _f32(1e-9, dev)))
    gx, gy, gz = grads
    # XLA's rounding of this sum of squares varies with its fusion; the
    # contracted form nearest to it (checks.py states the tolerance)
    gnorm = torch.sqrt(geometry.fma_f32(gz, gz, geometry.fma_f32(gy, gy,
                                                                 gx * gx)))
    ok = gnorm > _f32(1e-9, dev)
    inv = _f32(1.0, dev) / torch.where(ok, gnorm, _f32(1.0, dev))
    normal = torch.stack([gx * inv, gy * inv,
                          torch.where(ok, gz * inv, _f32(1.0, dev))], dim=0)
    centroid = geometry.fma_f32(-t_here[None], normal, center)
    rgb = v2[o, 2:5].t() / torch.maximum(v2[o, 5], _f32(1.0, dev))[None]
    return centroid, normal, t_here, v2[o, 0], rgb


def tsdf_surface(cell: torch.Tensor, order: torch.Tensor, grid: TsdfGrid,
                 config: TsdfConfig):
    """Per surface cell ((E,) i32 ascending ids and their (E,) i32 slots):
    ``(centroid (3,E), normal (3,E), tsdf (E,), weight (E,), rgb (3,E))``
    as tsdf.py:262-298 computes them.  Kernel T3 on CUDA tensors, its plain
    version on CPU tensors; bit-identical."""
    dev = grid.device
    E = cell.shape[0]
    for name, t in (("cell", cell), ("order", order)):
        if t.dtype != torch.int32 or tuple(t.shape) != (E,) \
                or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({E},) int32 on "
                             f"{dev}")
    if dev.type == "cpu":
        return tsdf_surface_plain(cell, order, grid, config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f32 = torch.float32
    centroid = torch.empty((3, E), dtype=f32, device=dev)
    normal = torch.empty((3, E), dtype=f32, device=dev)
    tsdf = torch.empty((E,), dtype=f32, device=dev)
    weight = torch.empty((E,), dtype=f32, device=dev)
    rgb = torch.empty((3, E), dtype=f32, device=dev)
    if E:
        cfg = config.base
        gf, gi = kernels.geometry_args(cfg)
        lib = kernels.library()
        kernels.check(lib.launch_tsdf_surface(
            cell.data_ptr(), order.data_ptr(), E, grid.key.data_ptr(),
            grid.vstats.data_ptr(), cfg.capacity, cfg.max_probes,
            kernels.ptr(gf), kernels.ptr(gi), centroid.data_ptr(),
            normal.data_ptr(), tsdf.data_ptr(), weight.data_ptr(),
            rgb.data_ptr(), kernels.stream()), "tsdf_surface")
        kernels.LAUNCHES["tsdf_surface"] += 1
    return centroid, normal, tsdf, weight, rgb


def surface_cells(grid: TsdfGrid, config: TsdfConfig):
    """The surface mask over the live table (tsdf.py:244-250) and one id
    sort: ``(cell (E,) i32 ascending, order (E,) i32 slots)``."""
    cfg = config.base
    C = cfg.capacity
    dev = grid.device
    w_all = grid.vstats.view(C, 6)[:, 0]
    gate = np.float32(config.surface_band) * np.float32(cfg.resolution[0])
    surface = ((grid.key >= 0) & (w_all >= _f32(config.min_weight, dev))
               & (_mean_sdf(grid.vstats, C).abs() < _f32(gate, dev)))
    slots = torch.nonzero(surface).squeeze(1)
    cell, perm = torch.sort(grid.key[slots])
    return cell, slots[perm].to(torch.int32)


def extract_tsdf(grid: TsdfGrid, config: TsdfConfig) -> TsdfExtract:
    """The surface cells in ascending id order, sized from the live count
    (no cap and no re-extract)."""
    cell, order = surface_cells(grid, config)
    centroid, normal, tsdf, weight, rgb = tsdf_surface(cell, order, grid,
                                                       config)
    return TsdfExtract(n_valid=int(cell.numel()), cell=cell,
                       centroid=centroid, normal=normal, tsdf=tsdf,
                       weight=weight, rgb=rgb)


def tsdf_to_host(result: TsdfExtract) -> dict:
    """TsdfExtract -> numpy dict; planar fields become (n,3)."""
    out = {}
    for f in ("cell", "centroid", "normal", "tsdf", "weight", "rgb"):
        a = getattr(result, f).detach().cpu().numpy()
        out[f] = np.ascontiguousarray(a.T) if a.ndim == 2 else a
    return out


# -- the pipeline the session drives ---------------------------------------

class TsdfPipeline:
    """The config, the device, and the entry points over a ``TsdfGrid``,
    shaped like ``FusionPipeline``.  Every step updates the grid in place
    and returns it.  ``refine`` is a no-op: every sample lands at
    integrate time."""

    def __init__(self, config: TsdfConfig, device):
        config.base.validate()
        self.config = config
        self.device = torch.device(device)

    def init(self) -> TsdfGrid:
        return make_tsdf_grid(self.config, self.device)

    def put(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the pipeline's device."""
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def put_state(self, fields: dict) -> TsdfGrid:
        """Host checkpoint arrays in the JAX package's layout -> a grid on
        the pipeline's device."""
        from ..convert import tsdf_grid_from_jax
        return tsdf_grid_from_jax(fields, self.config, self.device)

    def host_state(self, grid: TsdfGrid) -> dict:
        """The grid as host arrays in the JAX package's shapes and dtypes,
        the layout ``put_state`` of either package takes."""
        from ..convert import tsdf_grid_to_numpy
        return tsdf_grid_to_numpy(grid, self.config)

    def step(self, grid, points, rgb, mask, pose) -> TsdfGrid:
        """One planar frame; ``mask`` is an (N,) bool lane mask or a 0-d
        i32 count prefix."""
        return integrate_tsdf(grid, points, rgb, mask, pose, self.config)

    def step_batch(self, grid, points, rgb, mask, poses) -> TsdfGrid:
        """K planar frames; ``mask`` is a (K,N) bool lane mask or (K,) i32
        count prefixes."""
        return integrate_tsdf_batch(grid, points, rgb, mask, poses,
                                    self.config)

    def step_depth(self, grid, depth, rgb565, count, pose, rays) -> TsdfGrid:
        return integrate_tsdf_depth(grid, depth, rgb565, count, pose, rays,
                                    self.config)

    def step_batch_depth(self, grid, depth, rgb565, counts, poses, rays
                         ) -> TsdfGrid:
        return integrate_tsdf_batch_depth(grid, depth, rgb565, counts,
                                          poses, rays, self.config)

    def refine(self, grid: TsdfGrid) -> TsdfGrid:
        return grid

    def extract(self, grid: TsdfGrid) -> TsdfExtract:
        return extract_tsdf(grid, self.config)

    def extract_host(self, grid: TsdfGrid, fields=None) -> dict:
        """The surface as the export dict ``process()`` writes
        (tsdf.py:380-410): ``count`` = the rounded weight (samples fused),
        ``mean_dist`` = the TSDF value, ``sd`` / ``sd_dist`` / ``var_t``
        zeros (TSDF keeps first moments only).  ``fields`` selects keys of
        the dict (None: all); the whole result is fetched either way (the
        JAX package returns every key whatever ``fields`` says)."""
        return self.extract_fetcher(grid)(fields)

    def extract_fetcher(self, grid: TsdfGrid):
        """``fetch(fields=None, prefetch=())`` over one extraction
        (tsdf.py:412-419): the eight-lane surface is fetched once, here,
        and each call takes the keys ``fields`` names (None: all);
        ``prefetch`` does nothing."""
        h = tsdf_to_host(self.extract(grid))
        n = h["cell"].shape[0]
        count = np.round(h["weight"]).astype(np.int32)
        out = {
            "cell": h["cell"], "centroid": h["centroid"],
            "normal": h["normal"], "rgb": h["rgb"], "count": count,
            "mean_dist": h["tsdf"], "sd": np.zeros((n, 3), np.float32),
            "sd_dist": np.zeros((n,), np.float32), "n_pts": count.copy(),
            "var_t": np.zeros((n,), np.float32),
            "rgb_packed": _pack_rgb_float(h["rgb"]).view(np.uint32),
        }

        def fetch(fields=None, prefetch=()):
            return out if fields is None else {k: out[k] for k in fields}

        return fetch

    def grid_metrics(self, grid: TsdfGrid) -> dict:
        """tsdf.py:421-431: occupied slots, frames, both overflow
        counters; and the port's ``unique_cells``; one fetch."""
        vals = torch.stack([(grid.key >= 0).sum().to(torch.int64),
                            grid.frames.to(torch.int64),
                            grid.overflow_probe.to(torch.int64),
                            grid.overflow_unique.to(torch.int64),
                            grid.unique_cells.to(torch.int64)]).tolist()
        return dict(zip(("occupied_voxels", "frames", "overflow_probe",
                         "overflow_unique", "unique_cells"), vals))
