"""K-frame batched integration of sensor-native depth frames.

The counterpart of ``integrate_frame_impl`` in
``hifi_fusion_tpu/ops/integrate.py`` for the depth wire (u16 z-depth,
rgb565, per-frame counts, poses, a resident ray table).  One batch:

1. the depth frontend, kernel K1 (``depth_frontend``): unproject, clip,
   transform, cell id, colour;
2. one stable sort by cell id, invalid lanes last; lanes stay frame-major
   within a cell, so a cell's first lane belongs to its earliest frame;
3. the unique cells, found or inserted with kernel K2
   (``hashing.lookup_or_insert``);
4. per cell: Σrgb and point count, the occupancy-bitmap OR, and the
   earliest frame's viewpoint on first occupancy;
5. the pre-normal buffer append, all or nothing: it happens only when the
   buffer has room for the batch's whole active-lane budget
   (``buf_count + NA <= B``), else the wanted points count in
   ``overflow_buf``;
6. the dependant stream, kernel K3 (``dep_stream``), at the full width D.

Every accumulator is a sum, so the batch equals K sequential frames up to
f32 addition order.  Stages 2-5 are plain PyTorch in this slice.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import FusionConfig
from ..grid import GridState
from . import geometry, hashing
from .scatter import run_sums, runs

INVALID_ID = torch.iinfo(torch.int32).max   # cell id of an invalid lane


def _u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 zero-extended (``torch.uint16`` supports few ops)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def depth_frontend_plain(depth, rgb565, counts, poses, rays, config):
    K, N = depth.shape
    f32 = torch.float32
    d = _u16_to_i32(depth)                                  # (K,N)
    pc = d.to(f32)[:, None, :] * rays[None]                 # (K,3,N)
    lane = torch.arange(N, device=depth.device, dtype=torch.int32)
    zmin, zmax = (torch.tensor(z, dtype=f32, device=depth.device)
                  for z in config.z_clip)
    valid_k = ((lane[None, :] < counts[:, None]) & (d > 0)
               & (pc[:, 2] > zmin) & (pc[:, 2] < zmax))
    world = geometry.transform_points(pc, poses).transpose(0, 1)  # (3,K,N)
    coords = geometry.cell_coords(world, config)
    valid = (valid_k & geometry.valid_points(world, config)
             & geometry.valid_coords(coords, config))
    ids = torch.where(valid, geometry.cell_id(coords, config),
                      torch.full_like(valid, INVALID_ID, dtype=torch.int32))
    v = _u16_to_i32(rgb565)
    rgb = torch.stack([((v >> 11) & 0x1F).to(f32) * 8.0,
                       ((v >> 5) & 0x3F).to(f32) * 4.0,
                       (v & 0x1F).to(f32) * 8.0], dim=0)     # (3,K,N)
    M = K * N
    return world.reshape(3, M), ids.reshape(M), rgb.reshape(3, M)


def depth_frontend(depth: torch.Tensor, rgb565: torch.Tensor,
                   counts: torch.Tensor, poses: torch.Tensor,
                   rays: torch.Tensor, config: FusionConfig):
    """(K,N) u16 depth, (K,N) u16 rgb565, (K,) i32 counts, (K,4,4) f32
    poses, (3,N) f32 rays -> ``(world (3,K*N) f32, ids (K*N,) i32 with
    INT32_MAX where invalid, rgb (3,K*N) f32)``, lanes frame-major.
    Kernel K1 on CUDA tensors, its plain version on CPU tensors;
    bit-identical."""
    K, N = depth.shape
    dev = depth.device
    for name, t, dtype, shape in (
            ("depth", depth, torch.uint16, (K, N)),
            ("rgb565", rgb565, torch.uint16, (K, N)),
            ("counts", counts, torch.int32, (K,)),
            ("poses", poses, torch.float32, (K, 4, 4)),
            ("rays", rays, torch.float32, (3, N))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    if dev.type == "cpu":
        return depth_frontend_plain(depth, rgb565, counts, poses, rays,
                                     config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = K * N
    world = torch.empty((3, M), dtype=torch.float32, device=dev)
    ids = torch.empty((M,), dtype=torch.int32, device=dev)
    rgb = torch.empty((3, M), dtype=torch.float32, device=dev)
    if M == 0:
        return world, ids, rgb
    gf, gi = kernels.geometry_args(config)
    lib = kernels.library()
    kernels.check(lib.launch_depth_frontend(
        depth.data_ptr(), rgb565.data_ptr(), counts.data_ptr(),
        poses.data_ptr(), rays.data_ptr(), K, N, kernels.ptr(gf),
        kernels.ptr(gi), float(config.z_clip[0]), float(config.z_clip[1]),
        world.data_ptr(), ids.data_ptr(), rgb.data_ptr(), kernels.stream()),
        "depth_frontend")
    kernels.LAUNCHES["depth_frontend"] += 1
    return world, ids, rgb


def cylinder_add(cyl_stats: torch.Tensor, owner: torch.Tensor,
                 p: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                 radius: float) -> None:
    """Cylinder test of (3,Q) points ``p`` against owners with centers
    ``c`` and unit normals ``n`` (3,Q): ``q = p - c``, ``t = q.n``,
    ``r = q - t n``, ``d = |r|`` in the JAX package's operation order;
    where ``d < radius`` add [t, t², d, d², 1] to ``cyl_stats`` rows
    ``owner`` (Q,) in place.  Shared by the stream's plain version and the
    refine replay."""
    q = p - c
    t = (q[0] * n[0] + q[1] * n[1]) + q[2] * n[2]
    r = q - t[None] * n
    d = torch.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
    hit = d < radius
    t, d = t[hit], d[hit]
    vals = torch.stack([t, t * t, d, d * d, torch.ones_like(t)], dim=1)
    cyl_stats.view(-1, 5).index_add_(0, owner[hit], vals)


def dep_stream_plain(pts, slots, grid, config):
    D = config.max_dependants
    lane = torch.nonzero(slots >= 0).squeeze(1)
    s = slots[lane].long()
    cnt = grid.dep_count[s].clamp(max=D)
    owners = grid.dep.view(-1, D)[s]                        # (P,D)
    j = torch.arange(D, device=pts.device)
    pl, pj = torch.nonzero((j[None, :] < cnt[:, None]) & (owners >= 0),
                           as_tuple=True)
    o = owners[pl, pj].long()
    cylinder_add(grid.cyl_stats, o, pts[:, lane[pl]],
                 geometry.center_of_ids(grid.key[o], config),
                 grid.normal.view(-1, 3)[o].t(), config.cylinder_radius)


def dep_stream(pts: torch.Tensor, slots: torch.Tensor, grid: GridState,
               config: FusionConfig) -> None:
    """Stream (3,n) points, each with its cell's slot (-1 = skip), through
    the cylinders of the owners listed in the cell's dependants; hits add
    [t, t², d, d², 1] to the owner's ``cyl_stats`` in place.  Kernel K3 on
    CUDA tensors, its plain version on CPU tensors."""
    n = slots.shape[0]
    dev = grid.device
    if pts.dtype != torch.float32 or tuple(pts.shape) != (3, n) \
            or slots.dtype != torch.int32 or slots.dim() != 1:
        raise ValueError("dep_stream takes (3,n) f32 points and (n,) i32 "
                         "slots")
    if pts.device != dev or slots.device != dev \
            or not (pts.is_contiguous() and slots.is_contiguous()):
        raise ValueError(f"dep_stream inputs must be contiguous on {dev}")
    if dev.type == "cpu":
        dep_stream_plain(pts, slots, grid, config)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n == 0:
        return
    gf, gi = kernels.geometry_args(config)
    lib = kernels.library()
    kernels.check(lib.launch_dep_stream(
        pts.data_ptr(), n, slots.data_ptr(), grid.key.data_ptr(),
        grid.normal.data_ptr(), grid.dep.data_ptr(),
        grid.dep_count.data_ptr(), config.max_dependants, kernels.ptr(gf),
        kernels.ptr(gi), float(config.cylinder_radius),
        grid.cyl_stats.data_ptr(), kernels.stream()), "dep_stream")
    kernels.LAUNCHES["dep_stream"] += 1


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def integrate_batch_depth(grid: GridState, depth: torch.Tensor,
                          rgb565: torch.Tensor, counts: torch.Tensor,
                          poses: torch.Tensor, rays: torch.Tensor,
                          config: FusionConfig) -> GridState:
    """Integrate K depth frames ((K,N) u16 depth and rgb565, (K,) i32
    counts, (K,4,4) f32 poses) into ``grid`` in place; returns ``grid``.
    No refine: the caller fires ``refine_pass`` when ``refine_due`` says a
    mark fell inside the batch."""
    K, N = depth.shape
    M = K * N
    C = config.capacity
    B = config.buffer_capacity
    f32 = torch.float32

    world, ids, rgb = depth_frontend(depth, rgb565, counts, poses, rays,
                                     config)
    sid, order = torch.sort(ids, stable=True)
    n_act = int((sid != INVALID_ID).sum())
    NA = min(K * config.max_active_points, M)    # active-lane budget
    n_sv = min(n_act, NA)
    grid.overflow_active += max(n_act - NA, 0)
    sid, order = sid[:n_sv], order[:n_sv]
    pts = world[:, order]
    fid = order // N

    uids, ustart, ulen, run = runs(sid)
    uslot, n_failed = hashing.lookup_or_insert(grid.key, uids,
                                               config.max_probes, C)
    grid.overflow_probe += n_failed
    placed = uslot >= 0
    us = uslot.clamp(min=0).long()
    occ0 = placed & (grid.n_pts[us] > 0)
    nf0 = placed & grid.normal_found[us]
    slot_pt = uslot[run]                        # -1 where not placed

    ps = us[placed]
    if config.store_color:
        rgb_u = run_sums(rgb[:, order], run, uids.numel())       # (3,U)
        grid.rgb_sum.view(C, 3).index_add_(0, ps, rgb_u[:, placed].t())
    grid.n_pts.index_add_(0, ps, ulen[placed].to(f32))

    # viewpoint of the earliest frame, stamped on first occupancy (ghost
    # line cells are re-stamped, as in the reference)
    first = placed & ~occ0
    grid.viewpoint.view(C, 3)[us[first]] = poses[fid[ustart[first]], :3, 3]

    # occupancy bitmap: uids are distinct, so within a word OR == sum
    pu = uids[placed].long()
    wkey, _, _, wrun = runs(pu >> 5)
    wbits = run_sums(torch.ones_like(pu) << (pu & 31), wrun, wkey.numel())
    old = grid.occ_bits[wkey].long() & 0xFFFFFFFF
    grid.occ_bits[wkey] = _to_i32_bits(old | wbits)

    want = (slot_pt >= 0) & ~nf0[run]
    n_want = int(want.sum())
    bc = int(grid.buf_count)
    if bc + NA <= B:
        grid.buf_pts[:, bc:bc + n_want] = pts[:, want]
        grid.buf_slot[bc:bc + n_want] = slot_pt[want]
        grid.buf_count += n_want
    else:
        grid.overflow_buf += n_want

    dep_stream(pts, slot_pt, grid, config)
    grid.frames += K
    return grid


def integrate_depth(grid: GridState, depth: torch.Tensor,
                    rgb565: torch.Tensor, count: torch.Tensor,
                    pose: torch.Tensor, rays: torch.Tensor,
                    config: FusionConfig) -> GridState:
    """One depth frame ((N,) u16 depth and rgb565, 0-d i32 count, (4,4)
    pose): the K=1 batch."""
    return integrate_batch_depth(grid, depth[None], rgb565[None],
                                 count.reshape(1), pose[None], rays, config)
