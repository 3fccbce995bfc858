"""Owner-slab point routing: the routed ingest of slab-sharded fusion.

The counterpart of ``hifi_fusion_tpu/parallel/routing.py``.  Each source
shard ``s`` of an ``n``-shard grid takes the strided lanes ``s::n`` of a
frame and, per lane:

1. runs the frontend with the GLOBAL geometry: transform, camera-z clip,
   bbox and coord validity, in the single-grid frontend's arithmetic, so
   routed and replicated ingests agree bit for bit on which points
   survive;
2. finds its owner slab with ``n - 1`` boundary compares and at most one
   halo secondary target (``slab_w >= 2 * halo`` keeps it to one);
3. ranks it within its (source, target) bucket: primaries in lane order,
   then secondaries in lane order, the order of the JAX package's stable
   sort of ``concatenate([primary, secondary])`` by target;
4. packs it, when its rank is under the send budget ``Bs``, into the
   dense (7, n * Bs) send buffer ``[wx wy wz r g b present]`` at column
   ``target * Bs + rank``; the rest is zero and ranks past ``Bs`` are
   dropped and counted.

The budget is chosen per dispatch from an ascending tier ladder: the first
tier that covers the largest bucket over every source and frame, else the
top tier (JAX sharding.py:302-308).  Destination ``j`` receives bucket
``j`` of every source, source-major: ``n * Bs`` lanes of world points
that its integrate takes as pre-transformed, keeping only its local
coord window.

Kernel B12 (``csrc/route_pack.cu``) does stages 1-4 for a whole K-frame
batch of the depth wire or the planar f32 wire (``route_pack``) and writes
the result in the layout the destinations read: ``Routed``'s world and
rgb (n, K, 3, R) and present (n, K, R), R = n * Bs, destination-major,
column ``s * Bs + rank`` of destination ``j`` holding source ``s``'s lane
of rank ``rank`` in bucket ``j``, which is every source's send buffer with
its destination axis moved to the front.  ``route_sort_plain`` and
``pack_send_plain`` are the JAX package's two stages in plain PyTorch
(the send buffer of one source block); ``route_pack_plain`` applies them
frame by frame and source by source and rearranges their send buffers
into that layout.  A CPU tensor runs the plain pair, a CUDA tensor the
kernel; the two return the same structure.

The exchange (``exchange_batch``) is one code path for every placement:
destination ``j`` takes the ``[j]`` views with ``.to(device_j,
non_blocking=True)``: the views themselves when the shards share a device,
one contiguous peer copy per tensor between cards.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Sequence

import torch

from .. import kernels
from ..config import FusionConfig
from ..ops import geometry
from ..ops.integrate import _rgb565, _u16_to_i32

BIG = torch.iinfo(torch.int32).max   # target of an invalid lane
MAX_SHARDS = 16                      # B12's (source, target) key space
MAX_TIERS = 16                       # B12's budget ladder
# B12's 32-bit indices: frames on the grid's y axis, output rows, and the
# columns of a row (4 a thread, a block's 1,024 past the last)
INT32_MAX = 2**31 - 1
MAX_FRAMES = 65535
MAX_ROW = INT32_MAX - 4 * 256


def check_slabs(slab_w: int, halo: int) -> None:
    """A point has at most one halo secondary only if ``slab_w >= 2 *
    halo`` (JAX routing.py:102-105)."""
    if slab_w < 2 * halo:
        raise ValueError(
            f"routed sharding needs slab_w ({slab_w}) >= 2*halo "
            f"({2 * halo}); use fewer devices or the replicate path")


def owner_of_x(x: torch.Tensor, n_dev: int, slab_w: int) -> torch.Tensor:
    """(...,) global x cell coord -> owning shard, by ``n_dev - 1``
    boundary compares (exact; no integer division)."""
    owner = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for j in range(1, n_dev):
        owner += (x >= j * slab_w).to(torch.int32)
    return owner


def tier_index(tiers: Sequence[int], max_bucket: int) -> int:
    """The first tier whose budget covers ``max_bucket``; the top tier
    takes (and counts) anything beyond."""
    return sum(int(max_bucket > bs) for bs in tiers[:-1])


class RoutedSort(NamedTuple):
    """One source block's routing state after the target sort (lane space
    L = 2 * block size: primary and halo-secondary lanes)."""
    tgt: torch.Tensor         # (L,) i32 sorted target shard, BIG = invalid
    payload: torch.Tensor     # (6,L) f32 [wx wy wz r g b], target-sorted
    rank: torch.Tensor        # (L,) i32 rank within the target run
    lvalid: torch.Tensor      # (L,) bool
    max_bucket: int           # largest per-destination load of the block


class Routed(NamedTuple):
    """A routed K-frame batch in its destinations' layout, R = n * Bs
    lanes a destination, source-major (column ``s * Bs + rank``)."""
    world: torch.Tensor       # (n,K,3,R) f32, 0 past each bucket's load
    rgb: torch.Tensor         # (n,K,3,R) f32, 0 past each bucket's load
    present: torch.Tensor     # (n,K,R) bool
    send_lanes: int           # Bs, the tier chosen
    n_dropped: int            # lanes ranked past Bs
    max_bucket: int           # largest (frame, source, target) load


def route_sort_plain(points_cam: torch.Tensor, rgb: torch.Tensor,
                     mask: torch.Tensor, pose: torch.Tensor,
                     config: FusionConfig, n_dev: int, slab_w: int,
                     halo: int) -> RoutedSort:
    """Stage 1 on one source block ((3,Nb) camera points and f32 rgb,
    (Nb,) bool mask, (4,4) pose) under the GLOBAL config: frontend,
    targets, one stable payload sort by target (JAX routing.py:93-140)."""
    check_slabs(slab_w, halo)
    dev = points_cam.device
    zmin, zmax = (torch.tensor(z, dtype=torch.float32, device=dev)
                  for z in config.z_clip)
    world = geometry.transform_points(points_cam, pose)
    coords = geometry.cell_coords(world, config)
    valid = (mask & (points_cam[2] > zmin) & (points_cam[2] < zmax)
             & geometry.valid_points(world, config)
             & geometry.valid_coords(coords, config))
    x = coords[0]
    owner = owner_of_x(x, n_dev, slab_w)
    local = x - owner * slab_w                           # [0, slab_w)
    sec = torch.where(local < halo, owner - 1,
                      torch.where(local >= slab_w - halo, owner + 1,
                                  torch.full_like(owner, -1)))
    sec_ok = valid & (sec >= 0) & (sec < n_dev)
    big = torch.full_like(owner, BIG)
    tgt = torch.cat([torch.where(valid, owner, big),
                     torch.where(sec_ok, sec, big)])
    tgt_s, order = torch.sort(tgt, stable=True)
    payload = torch.cat([world, rgb], dim=0).repeat(1, 2)[:, order]
    lvalid = tgt_s != BIG
    lane = torch.arange(tgt_s.numel(), dtype=torch.int32, device=dev)
    start = torch.searchsorted(tgt_s, tgt_s).to(torch.int32)
    # invalid lanes continue the last valid run, as JAX's segment fill
    n_valid = int(lvalid.sum())
    last = start[n_valid - 1] if n_valid else torch.zeros_like(start[0])
    rank = lane - torch.where(lvalid, start, last)
    max_bucket = int(torch.where(lvalid, rank, -1).max()) + 1 \
        if rank.numel() else 0
    return RoutedSort(tgt=tgt_s, payload=payload, rank=rank, lvalid=lvalid,
                      max_bucket=max_bucket)


def pack_send_plain(rs: RoutedSort, n_dev: int, send_lanes: int):
    """Stage 2: the in-budget lanes into the dense (7, n_dev * Bs) send
    buffer -> ``(send, n_dropped)`` (JAX routing.py:143-160)."""
    Bs = send_lanes
    keep = rs.lvalid & (rs.rank < Bs)
    n_dropped = int((rs.lvalid & ~keep).sum())
    send = torch.zeros((7, n_dev * Bs), dtype=torch.float32,
                       device=rs.payload.device)
    dest = (rs.tgt[keep] * Bs + rs.rank[keep]).long()
    send[:6, dest] = rs.payload[:, keep]
    send[6, dest] = 1.0
    return send, n_dropped


def depth_lanes(depth, rgb565, counts, rays):
    """The depth wire's (K,3,N) camera points, f32 rgb and (K,N) mask, in
    kernel K1's arithmetic (``integrate.depth_frontend_plain``)."""
    K, N = depth.shape
    d = _u16_to_i32(depth)
    pc = d.to(torch.float32)[:, None, :] * rays[None]
    lane = torch.arange(N, device=depth.device, dtype=torch.int32)
    mask = (lane[None, :] < counts[:, None]) & (d > 0)
    rgb = _rgb565(_u16_to_i32(rgb565)).transpose(0, 1)     # (K,3,N)
    return pc, rgb, mask


def route_pack_plain(points, rgb, mask, poses, config, n_dev, slab_w,
                     halo, tiers) -> Routed:
    """The plain pair over a K-frame batch of (K,3,N) f32 camera points
    and rgb, a (K,N) bool mask and (K,4,4) poses: each frame's source
    blocks ``s::n_dev`` through ``route_sort_plain``, the tier, then
    ``pack_send_plain``; the (K, n, 7, n * Bs) send buffers rearranged
    destination-major (a permutation, nothing computed) -> ``Routed``."""
    K = points.shape[0]
    n = n_dev
    rs = [[route_sort_plain(points[k][:, s::n], rgb[k][:, s::n],
                            mask[k][s::n], poses[k], config, n, slab_w,
                            halo) for s in range(n)]
          for k in range(K)]
    mx = max((r.max_bucket for row in rs for r in row), default=0)
    Bs = tiers[tier_index(tiers, mx)]
    sends, dropped = [], 0
    for row in rs:
        for r in row:
            send, nd = pack_send_plain(r, n, Bs)
            sends.append(send)
            dropped += nd
    # [k, s, channel, j, rank] -> [j, k, channel, s * Bs + rank]
    recv = torch.stack(sends).reshape(K, n, 7, n, Bs).permute(
        3, 0, 2, 1, 4).reshape(n, K, 7, n * Bs)
    return Routed(recv[:, :, 0:3].contiguous(), recv[:, :, 3:6].contiguous(),
                  recv[:, :, 6] > 0.5, Bs, dropped, mx)


_host = threading.local()


def _host_budget(dev: torch.device):
    """A pinned host buffer of B12's 3 budget words and an event, kept per
    device and per calling thread."""
    bufs = _host.__dict__.setdefault("bufs", {})
    if dev.index not in bufs:
        bufs[dev.index] = (torch.empty(3, dtype=torch.int64,
                                       pin_memory=True), torch.cuda.Event())
    return bufs[dev.index]


def _mark(marks, i):
    if marks is not None:
        marks[i].record()


def _route_pack(wire, pts, rgb, mask, poses, rays, config, n_dev, slab_w,
                halo, tiers, marks):
    """Kernel B12 on CUDA tensors: count, scan and the budget on the card,
    the budget copied to a pinned buffer, pack and fill into an output
    sized for the top tier, all enqueued before the one host read; then
    views of the chosen tier's columns.  ``marks``, None or four CUDA
    events made by the caller (so that timing adds no event creation
    between the launches), records them before the count, after the
    budget's copy, after the pack and after the fill."""
    dev = pts.device
    K = poses.shape[0]
    N = pts.shape[-1]
    n = n_dev
    if n > MAX_SHARDS:
        raise ValueError(f"route_pack takes at most {MAX_SHARDS} shards")
    if not 1 <= len(tiers) <= MAX_TIERS:
        raise ValueError(f"route_pack takes 1 to {MAX_TIERS} budget tiers")
    top = max(tiers)
    rows = 2 * n * K * 3 * n + n * K * n
    if K > MAX_FRAMES or rows > INT32_MAX or top > MAX_ROW:
        raise ValueError(
            f"route_pack: {K} frames (at most {MAX_FRAMES}), {rows} output "
            f"rows (at most {INT32_MAX}) or a budget of {top} lanes (at "
            f"most {MAX_ROW}) past the kernel's 32-bit indices")
    nchs = -(-(N // n) // 256)           # 256-lane chunks of a source
    nkey = n * n
    cnt = torch.empty((K, 2, nkey, nchs), dtype=torch.int32, device=dev)
    totals = torch.empty((K, 2, nkey), dtype=torch.int32, device=dev)
    budget = torch.empty(3, dtype=torch.int64, device=dev)
    out = torch.empty(2 * n * K * 3 * n * top, dtype=torch.float32,
                      device=dev)
    present = torch.empty(n * K * n * top, dtype=torch.bool, device=dev)
    host, done = _host_budget(dev)
    gf, gi = kernels.geometry_args(config)
    lib = kernels.library()
    args = (wire, pts.data_ptr(), rgb.data_ptr(), mask.data_ptr(),
            int(mask.dtype == torch.bool), poses.data_ptr(),
            rays.data_ptr() if rays is not None else None, K, N,
            kernels.ptr(gf), kernels.ptr(gi), float(config.z_clip[0]),
            float(config.z_clip[1]), n, slab_w, halo, cnt.data_ptr(),
            totals.data_ptr())
    stream = kernels.stream()
    _mark(marks, 0)
    kernels.check(lib.launch_route_count(
        *args, (ctypes.c_int * len(tiers))(*tiers), len(tiers),
        budget.data_ptr(), host.data_ptr(), stream), "route_pack")
    done.record()
    _mark(marks, 1)
    kernels.check(lib.launch_route_pack(*args, budget.data_ptr(),
                                        out.data_ptr(), stream),
                  "route_pack")
    _mark(marks, 2)
    kernels.check(lib.launch_route_fill(
        totals.data_ptr(), budget.data_ptr(), K, n, top, out.data_ptr(),
        present.data_ptr(), stream), "route_pack")
    _mark(marks, 3)
    kernels.LAUNCHES["route_pack"] += 1
    done.synchronize()
    mx, Bs, dropped = host.tolist()
    R = n * Bs
    out = out[:2 * n * K * 3 * R].view(2, n, K, 3, R)
    return Routed(out[0], out[1], present[:n * K * R].view(n, K, R), Bs,
                  dropped, mx)


def route_pack(points: torch.Tensor, rgb: torch.Tensor, mask: torch.Tensor,
               poses: torch.Tensor, config: FusionConfig, n_dev: int,
               slab_w: int, halo: int, tiers: Sequence[int],
               marks=None) -> Routed:
    """Route and pack K planar frames ((K,3,N) f32 camera points and rgb,
    a (K,N) bool mask or (K,) i32 count prefixes, (K,4,4) poses) for
    ``n_dev`` shards of ``slab_w`` cells with ``halo`` under the GLOBAL
    ``config`` -> ``Routed`` (destination-major world, rgb and present,
    ``Bs`` the first of ``tiers`` covering ``max_bucket``, the drops).
    Kernel B12 on CUDA tensors, the plain pair on CPU tensors;
    bit-identical.  ``marks`` (four CUDA events, CUDA only) time the
    kernel's passes (``_route_pack``)."""
    check_slabs(slab_w, halo)
    K, _, N = points.shape
    dev = points.device
    if N % n_dev:
        raise ValueError(f"max_points {N} must divide the mesh ({n_dev})")
    kernels.check_inputs(
        dev, ("points", points, torch.float32, (K, 3, N)),
        ("rgb", rgb, torch.float32, (K, 3, N)),
        ("mask", mask, mask.dtype,
         (K, N) if mask.dtype == torch.bool else (K,)),
        ("poses", poses, torch.float32, (K, 4, 4)))
    if mask.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"mask: bool lanes or i32 counts, got "
                         f"{mask.dtype}")
    if dev.type == "cpu":
        if mask.dtype != torch.bool:
            lane = torch.arange(N, dtype=torch.int32)
            mask = lane[None, :] < mask[:, None]
        return route_pack_plain(points, rgb, mask, poses, config, n_dev,
                                slab_w, halo, tiers)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _route_pack(1, points, rgb, mask, poses, None, config, n_dev,
                       slab_w, halo, tiers, marks)


def route_pack_depth(depth: torch.Tensor, rgb565: torch.Tensor,
                     counts: torch.Tensor, poses: torch.Tensor,
                     rays: torch.Tensor, config: FusionConfig, n_dev: int,
                     slab_w: int, halo: int, tiers: Sequence[int],
                     marks=None) -> Routed:
    """``route_pack`` of K depth frames ((K,N) u16 depth and rgb565, (K,)
    i32 counts, (K,4,4) poses, (3,N) f32 rays), unprojected in kernel
    K1's arithmetic (JAX sharding.py:422-446)."""
    check_slabs(slab_w, halo)
    K, N = depth.shape
    dev = depth.device
    if N % n_dev:
        raise ValueError(f"max_points {N} must divide the mesh ({n_dev})")
    kernels.check_inputs(
        dev, ("depth", depth, torch.uint16, (K, N)),
        ("rgb565", rgb565, torch.uint16, (K, N)),
        ("counts", counts, torch.int32, (K,)),
        ("poses", poses, torch.float32, (K, 4, 4)),
        ("rays", rays, torch.float32, (3, N)))
    if dev.type == "cpu":
        pc, rgb, mask = depth_lanes(depth, rgb565, counts, rays)
        return route_pack_plain(pc, rgb, mask, poses, config, n_dev,
                                slab_w, halo, tiers)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _route_pack(0, depth, rgb565, counts, poses, rays, config, n_dev,
                       slab_w, halo, tiers, marks)


def exchange_batch(world: torch.Tensor, rgb: torch.Tensor,
                   present: torch.Tensor, devices: Sequence[torch.device]):
    """``route_pack``'s destination-major (n,K,3,R) world and rgb and
    (n,K,R) present -> per destination ``j`` on ``devices[j]``: ``(world
    (K,3,R), rgb (K,3,R), present (K,R))``, R = n * Bs, source-major (JAX
    routing.py:175-185).  Each is the ``[j]`` view moved with
    ``.to(devices[j], non_blocking=True)``: the view itself, no copy,
    where the destination shares the buffers' device, else one contiguous
    peer copy."""
    return [tuple(t[j].to(dev, non_blocking=True)
                  for t in (world, rgb, present))
            for j, dev in enumerate(devices)]
