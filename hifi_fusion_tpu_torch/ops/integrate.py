"""K-frame batched integration of depth frames and planar point clouds.

The counterpart of ``integrate_frame_impl`` in
``hifi_fusion_tpu/ops/integrate.py`` for two families of wires: the depth
wire (u16 z-depth, rgb565, per-frame counts, poses, a resident ray table)
and the planar wires of ``_unpack_inputs`` (integrate.py:110-175): f32 or
u16-quantized (K,3,N) camera points, f32, packed u32 or rgb565 colour, and
a (K,N) lane mask or a (K,) count prefix.  One batch:

1. a frontend: kernel K1 (``depth_frontend``) for the depth wire, kernel
   K5 (``planar_frontend``) for the planar wires and its record wire
   (``record_frontend``) for PointCloud2 records as they arrived; each
   unprojects, dequantizes or decodes, clips, transforms, takes the cell
   id and expands colour;
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

Stages 2-6 (``integrate_lanes``) do not know the wire.  Every accumulator
is a sum, so the batch equals K sequential frames up to f32 addition
order.  Stage 2 is the library sort; stages 3-5 are kernel B3
(``aggregate_lanes``, ``csrc/integrate_lanes.cu``) around K2, and every
array is sized by the active-lane budget, so on the card a batch is
enqueued without a read back to the host.  As on the depth wire, the
only lane budget is the active one (NA = K * max_active_points); the JAX
package's unique and hit budgets (``batch_lane_budgets``) never bind
here (``overflow_unique`` and ``overflow_hits`` stay 0, grid.py).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..config import FusionConfig
from ..grid import GridState
from . import geometry, hashing
from .hashing import INVALID_ID     # the cell id of an invalid lane
from .scatter import run_sums, runs


def _u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint16 -> int32 zero-extended (``torch.uint16`` supports few ops)."""
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def _rgb565(v: torch.Tensor) -> torch.Tensor:
    """(...) int32 rgb565 words -> (3, ...) f32 (x8, x4, x8)."""
    f32 = torch.float32
    return torch.stack([((v >> 11) & 0x1F).to(f32) * 8.0,
                        ((v >> 5) & 0x3F).to(f32) * 4.0,
                        (v & 0x1F).to(f32) * 8.0], dim=0)


def _clip_transform_id(pc, valid_k, poses, config, offset=None,
                       pre_transformed=False):
    """The frontend's common tail on (K,3,N) camera points and a (K,N)
    lane mask: camera-z clip, pose transform, strict bbox, cell coords
    shifted into the shard's local space by ``offset`` and their validity
    -> ``(world (3,K,N) f32, ids (K,N) i32)``, INT32_MAX where invalid.
    ``pre_transformed``: ``pc`` holds routed world points, which keep only
    the local coord-window test (JAX integrate.py:59-95)."""
    f32 = torch.float32
    if pre_transformed:
        world = pc.transpose(0, 1)                                # (3,K,N)
    else:
        zmin, zmax = (torch.tensor(z, dtype=f32, device=pc.device)
                      for z in config.z_clip)
        valid_k = valid_k & (pc[:, 2] > zmin) & (pc[:, 2] < zmax)
        world = geometry.transform_points(pc, poses).transpose(0, 1)
        valid_k = valid_k & geometry.valid_points(world, config)
    coords = geometry.shift(geometry.cell_coords(world, config), offset, -1)
    valid = valid_k & geometry.valid_coords(coords, config)
    ids = torch.where(valid, geometry.cell_id(coords, config),
                      torch.full_like(valid, INVALID_ID, dtype=torch.int32))
    return world, ids


def depth_frontend_plain(depth, rgb565, counts, poses, rays, config,
                         offset=None):
    K, N = depth.shape
    d = _u16_to_i32(depth)                                  # (K,N)
    pc = d.to(torch.float32)[:, None, :] * rays[None]       # (K,3,N)
    lane = torch.arange(N, device=depth.device, dtype=torch.int32)
    world, ids = _clip_transform_id(
        pc, (lane[None, :] < counts[:, None]) & (d > 0), poses, config,
        offset)
    rgb = _rgb565(_u16_to_i32(rgb565))                      # (3,K,N)
    M = K * N
    return world.reshape(3, M), ids.reshape(M), rgb.reshape(3, M)


def depth_frontend(depth: torch.Tensor, rgb565: torch.Tensor,
                   counts: torch.Tensor, poses: torch.Tensor,
                   rays: torch.Tensor, config: FusionConfig,
                   offset=None):
    """(K,N) u16 depth, (K,N) u16 rgb565, (K,) i32 counts, (K,4,4) f32
    poses, (3,N) f32 rays -> ``(world (3,K*N) f32, ids (K*N,) i32 with
    INT32_MAX where invalid, rgb (3,K*N) f32)``, lanes frame-major; ids
    local to a shard whose coordinate ``offset`` (a (3,) int tuple) is
    given.  Kernel K1 on CUDA tensors, its plain version on CPU tensors;
    bit-identical."""
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
        return depth_frontend_plain(depth, rgb565, counts, poses, rays,
                                     config, offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = K * N
    world = torch.empty((3, M), dtype=torch.float32, device=dev)
    ids = torch.empty((M,), dtype=torch.int32, device=dev)
    rgb = torch.empty((3, M), dtype=torch.float32, device=dev)
    if M == 0:
        return world, ids, rgb
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    kernels.check(lib.launch_depth_frontend(
        depth.data_ptr(), rgb565.data_ptr(), counts.data_ptr(),
        poses.data_ptr(), rays.data_ptr(), K, N, kernels.ptr(gf),
        kernels.ptr(gi), float(config.z_clip[0]), float(config.z_clip[1]),
        world.data_ptr(), ids.data_ptr(), rgb.data_ptr(), kernels.stream()),
        "depth_frontend")
    kernels.LAUNCHES["depth_frontend"] += 1
    return world, ids, rgb


# point wires and colour wires of the planar frontend, as the kernel's
# template arguments number them (csrc/planar_frontend.cu); routed world
# points are wire 2
POINT_WIRES = {torch.float32: 0, torch.uint16: 1}
WORLD_WIRE = 2
RGB_WIRES = {torch.float32: 0, torch.uint32: 1, torch.uint16: 2}


def planar_frontend_plain(points, rgb, mask, poses, quant, config,
                          offset=None, pre_transformed=False):
    K, _, N = points.shape
    f32 = torch.float32
    if points.dtype == torch.uint16:
        pc = (_u16_to_i32(points).to(f32) * quant[:, 0, :, None]
              + quant[:, 1, :, None])
    else:
        pc = points
    if mask.dim() == 1:
        lane = torch.arange(N, device=points.device, dtype=torch.int32)
        mask = lane[None, :] < mask[:, None]
    world, ids = _clip_transform_id(pc, mask, poses, config, offset,
                                    pre_transformed)
    if rgb.dtype == torch.float32:
        rgb3 = rgb.transpose(0, 1)                          # (3,K,N)
    elif rgb.dtype == torch.uint16:
        rgb3 = _rgb565(_u16_to_i32(rgb))
    else:
        v = rgb.view(torch.int32)
        rgb3 = torch.stack([((v >> 16) & 0xFF).to(f32),
                            ((v >> 8) & 0xFF).to(f32),
                            (v & 0xFF).to(f32)], dim=0)
    M = K * N
    return (world.reshape(3, M), ids.reshape(M),
            rgb3.reshape(3, M).contiguous())


def planar_frontend(points: torch.Tensor, rgb: torch.Tensor,
                    mask: torch.Tensor, poses: torch.Tensor,
                    config: FusionConfig, quant: torch.Tensor = None,
                    offset=None, pre_transformed: bool = False):
    """The planar wires of K frames -> ``(world (3,K*N) f32, ids (K*N,)
    i32 with INT32_MAX where invalid, rgb (3,K*N) f32)``, lanes
    frame-major, as ``depth_frontend`` returns them.

    * ``points``: (K,3,N) f32 camera points, or (K,3,N) u16 with
      ``quant`` (2,3) or (K,2,3) f32 [scale, offset], dequantized as
      ``q * scale + offset`` (exact under ``pack_frame_q16``'s power-of-two
      scales);
    * ``rgb``: (K,3,N) f32, (K,N) u32 packed 0xRRGGBB, or (K,N) u16 5:6:5;
    * ``mask``: (K,N) bool lane validity, or (K,) i32 count prefixes;
    * ``poses``: (K,4,4) f32.

    ``offset`` (a (3,) int tuple) makes the ids local to a shard;
    ``pre_transformed`` takes (K,3,N) f32 routed WORLD points with f32
    colour: no transform, camera-z clip or bbox test, only the local
    coord window (``parallel/routing.py``).  Kernel K5 on CUDA tensors,
    its plain version on CPU tensors; bit-identical."""
    if points.dim() != 3 or points.shape[1] != 3:
        raise ValueError(f"points: expected (K,3,N), got "
                         f"{tuple(points.shape)}")
    K, _, N = points.shape
    dev = points.device
    if points.dtype not in POINT_WIRES:
        raise ValueError(f"points: f32 or u16, got {points.dtype}")
    if rgb.dtype not in RGB_WIRES:
        raise ValueError(f"rgb: f32, u32 or u16, got {rgb.dtype}")
    q16 = points.dtype == torch.uint16
    if pre_transformed and (q16 or rgb.dtype != torch.float32):
        raise ValueError("pre-transformed points take f32 points and rgb")
    if q16 != (quant is not None):
        raise ValueError("u16 points need quant (2,3) or (K,2,3); f32 "
                         "points take none")
    if q16 and tuple(quant.shape) == (2, 3):
        quant = quant[None].expand(K, 2, 3).contiguous()
    checks = [("points", points, points.dtype, (K, 3, N)),
              ("rgb", rgb, rgb.dtype,
               (K, 3, N) if rgb.dtype == torch.float32 else (K, N)),
              ("mask", mask, mask.dtype,
               (K, N) if mask.dtype == torch.bool else (K,)),
              ("poses", poses, torch.float32, (K, 4, 4))]
    if mask.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"mask: bool lanes or i32 counts, got "
                         f"{mask.dtype}")
    if q16:
        checks.append(("quant", quant, torch.float32, (K, 2, 3)))
    kernels.check_inputs(dev, *checks)
    if dev.type == "cpu":
        return planar_frontend_plain(points, rgb, mask, poses, quant,
                                     config, offset, pre_transformed)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = K * N
    world = torch.empty((3, M), dtype=torch.float32, device=dev)
    ids = torch.empty((M,), dtype=torch.int32, device=dev)
    rgb_out = torch.empty((3, M), dtype=torch.float32, device=dev)
    if M == 0:
        return world, ids, rgb_out
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    kernels.check(lib.launch_planar_frontend(
        points.data_ptr(),
        WORLD_WIRE if pre_transformed else POINT_WIRES[points.dtype],
        quant.data_ptr() if q16 else None, rgb.data_ptr(),
        RGB_WIRES[rgb.dtype], mask.data_ptr(),
        int(mask.dtype == torch.bool), poses.data_ptr(), K, N,
        kernels.ptr(gf), kernels.ptr(gi), float(config.z_clip[0]),
        float(config.z_clip[1]), world.data_ptr(), ids.data_ptr(),
        rgb_out.data_ptr(), kernels.stream()), "planar_frontend")
    kernels.LAUNCHES["planar_frontend"] += 1
    return world, ids, rgb_out


def record_frontend_plain(rec, table, poses, config, offset=None):
    """The record wire's decode in PyTorch (each field's four bytes
    gathered and viewed as a word, the colour unpacked with the config's
    blue shift; lanes past the count, or whose fields would lie outside
    the row, zero), then the f32 planar wire with the count prefix."""
    K, R = rec.shape
    N = config.max_points
    dev = rec.device
    t = table.to(torch.int64)
    count, step, offs = t[:, 0], t[:, 1], t[:, 2:]
    # a colourless frame's fourth word is read at x
    offs = torch.where(offs >= 0, offs, offs[:, :1])
    lo, hi = offs.amin(dim=1), offs.amax(dim=1)
    n = torch.arange(N, device=dev)
    live = ((n[None] < count[:, None]) & (step > 0)[:, None]
            & (lo >= 0)[:, None]
            & (n[None] * step[:, None] + (hi + 4)[:, None] <= R))
    start = torch.arange(K, device=dev)[:, None] * R + n[None] * step[:, None]
    at = torch.where(live[..., None], start[:, :, None] + offs[:, None, :],
                     0)                                          # (K,N,4)
    byte = rec.reshape(-1)[at[..., None] + torch.arange(4, device=dev)]
    words = torch.where(live[..., None], byte.view(torch.int32)[..., 0], 0)
    pts = words[..., :3].view(torch.float32).permute(0, 2, 1).contiguous()
    v = torch.where((t[:, 5] >= 0)[:, None], words[..., 3], 0)
    blue = 1 if config.bug_compat_blue_shift else 0
    rgb = torch.stack([(v >> 16) & 0xFF, (v >> 8) & 0xFF,
                       (v >> blue) & 0xFF], dim=1).to(torch.float32)
    return planar_frontend_plain(pts, rgb, table[:, 0].contiguous(), poses,
                                 None, config, offset)


def record_frontend(rec: torch.Tensor, table: torch.Tensor,
                    poses: torch.Tensor, config: FusionConfig, offset=None):
    """K frames of PointCloud2 records as they arrived -> the outputs of
    ``planar_frontend`` on N = ``max_points`` lanes a frame.

    * ``rec``: (K,R) u8, row k holding frame k's records from byte 0
      (bytes past its count's records are never read);
    * ``table``: (K,6) i32, a row a frame: count, point_step and the
      byte offsets of x, y, z and the packed 0x00RRGGBB colour (-1:
      none), as ``runtime/decode.record_fields`` checks them; a lane
      whose fields would lie outside its row reads nothing, whatever the
      table holds;
    * ``poses``: (K,4,4) f32.

    Bit-equal to the host decode (``runtime/decode.decode_frame``) into
    the f32 planar wire with a count prefix.  Kernel K5's record wire on
    CUDA tensors, ``record_frontend_plain`` on CPU tensors."""
    if rec.dim() != 2:
        raise ValueError(f"rec: expected (K,R), got {tuple(rec.shape)}")
    K, R = rec.shape
    N = config.max_points
    dev = rec.device
    kernels.check_inputs(
        dev,
        ("rec", rec, torch.uint8, (K, R)),
        ("table", table, torch.int32, (K, 6)),
        ("poses", poses, torch.float32, (K, 4, 4)))
    if dev.type == "cpu":
        return record_frontend_plain(rec, table, poses, config, offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    M = K * N
    world = torch.empty((3, M), dtype=torch.float32, device=dev)
    ids = torch.empty((M,), dtype=torch.int32, device=dev)
    rgb_out = torch.empty((3, M), dtype=torch.float32, device=dev)
    if M == 0:
        return world, ids, rgb_out
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    kernels.check(lib.launch_record_frontend(
        rec.data_ptr(), R, table.data_ptr(),
        int(config.bug_compat_blue_shift), poses.data_ptr(), K, N,
        kernels.ptr(gf), kernels.ptr(gi), float(config.z_clip[0]),
        float(config.z_clip[1]), world.data_ptr(), ids.data_ptr(),
        rgb_out.data_ptr(), kernels.stream()), "record_frontend")
    kernels.LAUNCHES["record_frontend"] += 1
    return world, ids, rgb_out


def cylinder_td(p: torch.Tensor, c: torch.Tensor, n: torch.Tensor):
    """The (Q,) projection ``t`` and distance ``d`` of (3,Q) points ``p``
    on the axes through centers ``c`` along unit normals ``n`` (3,Q):
    ``q = p - c``, ``t = q.n``, ``r = q - t n``, ``d = |r|`` in the JAX
    package's operation order (common.cuh cylinder_hit).  Shared by the
    stream's plain version and the refine replay's."""
    q = p - c
    t = (q[0] * n[0] + q[1] * n[1]) + q[2] * n[2]
    r = q - t[None] * n
    return t, torch.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])


def cylinder_add(cyl_stats: torch.Tensor, owner: torch.Tensor,
                 p: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                 radius: float) -> None:
    """Where ``d < radius`` (``cylinder_td``) add [t, t², d, d², 1] to
    ``cyl_stats`` rows ``owner`` (Q,) in place."""
    t, d = cylinder_td(p, c, n)
    hit = d < radius
    t, d = t[hit], d[hit]
    vals = torch.stack([t, t * t, d, d * d, torch.ones_like(t)], dim=1)
    cyl_stats.view(-1, 5).index_add_(0, owner[hit], vals)


def dep_stream_plain(pts, slots, grid, config, offset=None):
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
                 geometry.center_of_ids(grid.key[o], config, offset),
                 grid.normal.view(-1, 3)[o].t(), config.cylinder_radius)


def dep_stream(pts: torch.Tensor, slots: torch.Tensor, grid: GridState,
               config: FusionConfig, offset=None) -> None:
    """Stream (3,n) points, each with its cell's slot (-1 = skip), through
    the cylinders of the owners listed in the cell's dependants; hits add
    [t, t², d, d², 1] to the owner's ``cyl_stats`` in place.  Owner
    centers are global (``offset``: the shard's coordinate offset).
    Kernel K3 on CUDA tensors, its plain version on CPU tensors."""
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
        dep_stream_plain(pts, slots, grid, config, offset)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n == 0:
        return
    gf, gi = kernels.geometry_args(config, offset)
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


def aggregate_lanes_plain(grid, sid, order, world, rgb, poses, N, NA,
                          config, extra_dropped=0):
    M = sid.numel()
    C = config.capacity
    B = config.buffer_capacity
    f32 = torch.float32
    dev = sid.device

    n_act = int((sid != INVALID_ID).sum())
    n_sv = min(n_act, NA)
    grid.overflow_active += max(n_act - NA, 0) + extra_dropped
    s_sid, s_order = sid[:n_sv], order[:n_sv]
    pts = world[:, s_order]
    fid = s_order // N

    uids, ustart, ulen, run = runs(s_sid)
    uslot = hashing.lookup_or_insert(grid.key, uids, config.max_probes, C,
                                     grid.overflow_probe)
    placed = uslot >= 0
    us = uslot.clamp(min=0).long()
    occ0 = placed & (grid.n_pts[us] > 0)
    nf0 = placed & grid.normal_found[us]
    slot_pt = uslot[run]                        # -1 where not placed

    ps = us[placed]
    if config.store_color:
        rgb_u = run_sums(rgb[:, s_order], run, uids.numel())     # (3,U)
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

    out_pts = torch.zeros((3, NA), dtype=f32, device=dev)
    out_slot = torch.full((NA,), -1, dtype=torch.int32, device=dev)
    out_pts[:, :n_sv] = pts
    out_slot[:n_sv] = slot_pt
    return out_pts, out_slot


def aggregate_lanes(grid: GridState, sid: torch.Tensor, order: torch.Tensor,
                    world: torch.Tensor, rgb: torch.Tensor,
                    poses: torch.Tensor, N: int, NA: int,
                    config: FusionConfig, extra_dropped: int = 0):
    """Stages 3-5 of a batch on its M lanes sorted by cell id (``sid``
    (M,) i32, INT32_MAX last, and the stable sort's ``order`` (M,) i64 into
    the frontend's frame-major lanes of ``world`` and ``rgb``, (3,M) f32),
    with the batch's (K,4,4) ``poses``, N lanes a frame and the active-lane
    budget NA: the first NA sorted lanes are the batch's, the valid lanes
    past them count in ``overflow_active`` with ``extra_dropped``; the
    unique cells are found or inserted (K2), and per cell Σrgb and the
    point count are added, the first viewpoint stamped and the bitmap bit
    set; the wanted lanes (placed, no normal yet) are appended to the
    buffer when ``buf_count + NA <= B``, else counted in ``overflow_buf``.
    Updates ``grid`` in place; returns ``(pts (3,NA) f32, slot_pt (NA,)
    i32)``: the sorted lanes' points and cell slots for the dependant
    stream, slot -1 past the valid lanes and for an unplaced cell.

    Kernel B3 (``csrc/integrate_lanes.cu``, counted as
    ``integrate_lanes``) with K2 on CUDA tensors, reading nothing back to
    the host: a memset of its scratch and pass A (the runs of the sorted
    lanes, a look-back scan) before K2; after it pass B, a thread a lane
    (the sorted points and slots, the buffer ranks from a look-back count
    of the wanted lanes, each run's count and viewpoint by its first
    lane, its colour summed inside each tile it spans) and a one-thread
    finish.  Its plain version on CPU tensors.  The slots may differ
    (K2's CAS race); the grid is the same by cell id."""
    M = sid.numel()
    dev = sid.device
    kernels.check_inputs(
        dev,
        ("sid", sid, torch.int32, (M,)),
        ("order", order, torch.int64, (M,)),
        ("world", world, torch.float32, (3, M)),
        ("rgb", rgb, torch.float32, (3, M)),
        ("poses", poses, torch.float32, (poses.shape[0], 4, 4)))
    if not 0 <= NA <= M or grid.device != dev:
        raise ValueError(f"NA {NA} of {M} lanes, grid on {grid.device}")
    if dev.type == "cpu":
        return aggregate_lanes_plain(grid, sid, order, world, rgb, poses, N,
                                     NA, config, extra_dropped)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    i32 = torch.int32

    def ints(n):
        return torch.empty((n,), dtype=i32, device=dev)

    lane_run, uids, ustart = ints(NA), ints(NA), ints(NA + 1)
    words = (2 + kernels.lookback_words(NA, kernels.RUN_SCAN_TILE)
             + kernels.lookback_words(NA, kernels.B3_TILE))
    scratch = ints(words)            # [U, n_want, the two look-backs]
    pts = torch.empty((3, NA), dtype=torch.float32, device=dev)
    slot_pt = ints(NA)
    lib = kernels.library()
    st = kernels.stream()
    kernels.check(lib.launch_integrate_lanes_cells(
        sid.data_ptr(), M, NA, int(extra_dropped),
        grid.overflow_active.data_ptr(), lane_run.data_ptr(),
        uids.data_ptr(), ustart.data_ptr(), scratch.data_ptr(), words, st),
        "integrate_lanes")
    if NA:
        uslot = hashing.lookup_or_insert(grid.key, uids, config.max_probes,
                                         config.capacity,
                                         grid.overflow_probe,
                                         n_live=scratch[0])
        kernels.check(lib.launch_integrate_lanes_append(
            NA, M, N, lane_run.data_ptr(), uids.data_ptr(),
            ustart.data_ptr(), uslot.data_ptr(), order.data_ptr(),
            world.data_ptr(), rgb.data_ptr(), poses.data_ptr(),
            int(config.store_color), grid.n_pts.data_ptr(),
            grid.normal_found.data_ptr(), grid.rgb_sum.data_ptr(),
            grid.viewpoint.data_ptr(), grid.occ_bits.data_ptr(),
            pts.data_ptr(), slot_pt.data_ptr(), grid.buf_pts.data_ptr(),
            grid.buf_slot.data_ptr(), grid.buf_count.data_ptr(),
            config.buffer_capacity, grid.overflow_buf.data_ptr(),
            scratch.data_ptr(), st), "integrate_lanes")
    kernels.LAUNCHES["integrate_lanes"] += 1
    return pts, slot_pt


def integrate_lanes(grid: GridState, world: torch.Tensor,
                    ids: torch.Tensor, rgb: torch.Tensor,
                    poses: torch.Tensor, K: int, N: int,
                    config: FusionConfig, offset=None,
                    extra_dropped: int = 0) -> GridState:
    """Stages 2-6 of a K-frame batch on a frontend's frame-major lanes
    ((3,K*N) f32 world points, (K*N,) i32 ids with INT32_MAX where
    invalid, (3,K*N) f32 rgb) and the batch's (K,4,4) poses, into ``grid``
    in place; returns ``grid``.  No refine: the caller fires
    ``refine_pass`` when ``refine_due`` says a mark fell inside the
    batch.  ``offset``: the shard's coordinate offset; ``extra_dropped``:
    points a router dropped for this batch, added to ``overflow_active``
    (JAX integrate.py:322-325).  On the card every stage is enqueued with
    no read back to the host: the library sort, B3 with K2, and K3 over
    the whole active-lane budget."""
    M = K * N
    NA = min(K * config.max_active_points, M)    # active-lane budget
    sid, order = torch.sort(ids, stable=True)
    pts, slot_pt = aggregate_lanes(grid, sid, order, world, rgb, poses, N,
                                   NA, config, extra_dropped)
    dep_stream(pts, slot_pt, grid, config, offset)
    grid.frames += K
    return grid


def integrate_batch_depth(grid: GridState, depth: torch.Tensor,
                          rgb565: torch.Tensor, counts: torch.Tensor,
                          poses: torch.Tensor, rays: torch.Tensor,
                          config: FusionConfig, offset=None) -> GridState:
    """Integrate K depth frames ((K,N) u16 depth and rgb565, (K,) i32
    counts, (K,4,4) f32 poses) into ``grid`` in place; returns ``grid``.
    ``offset``: the shard's coordinate offset.  A routed depth frame is
    unprojected before routing and arrives as pre-transformed planar
    world points (``integrate_batch``)."""
    K, N = depth.shape
    world, ids, rgb = depth_frontend(depth, rgb565, counts, poses, rays,
                                     config, offset)
    return integrate_lanes(grid, world, ids, rgb, poses, K, N, config,
                           offset)


def integrate_batch(grid: GridState, points: torch.Tensor,
                    rgb: torch.Tensor, mask: torch.Tensor,
                    poses: torch.Tensor, config: FusionConfig,
                    quant: torch.Tensor = None, offset=None,
                    pre_transformed: bool = False,
                    extra_dropped: int = 0) -> GridState:
    """Integrate K planar frames (the wires of ``planar_frontend``) into
    ``grid`` in place; returns ``grid``.  The counterpart of the JAX
    package's ``models/pipeline.integrate_batch``; ``offset``,
    ``pre_transformed`` and ``extra_dropped`` as in its
    ``integrate_frame_impl`` (integrate.py:59-95, :259-281, :322-325)."""
    K, _, N = points.shape
    world, ids, rgb3 = planar_frontend(points, rgb, mask, poses, config,
                                       quant, offset, pre_transformed)
    return integrate_lanes(grid, world, ids, rgb3, poses, K, N, config,
                           offset, extra_dropped)


def integrate_batch_records(grid: GridState, rec: torch.Tensor,
                            table: torch.Tensor, poses: torch.Tensor,
                            config: FusionConfig, offset=None) -> GridState:
    """Integrate K frames of PointCloud2 records (the wire of
    ``record_frontend``) into ``grid`` in place; returns ``grid``."""
    world, ids, rgb3 = record_frontend(rec, table, poses, config, offset)
    return integrate_lanes(grid, world, ids, rgb3, poses, rec.shape[0],
                           config.max_points, config, offset)


def integrate(grid: GridState, points: torch.Tensor, rgb: torch.Tensor,
              mask: torch.Tensor, pose: torch.Tensor, config: FusionConfig,
              quant: torch.Tensor = None, offset=None,
              pre_transformed: bool = False,
              extra_dropped: int = 0) -> GridState:
    """One planar frame ((3,N) f32 or u16 points, (3,N) f32 or (N,) u32 /
    u16 rgb, (N,) bool mask or 0-d i32 count, (4,4) pose, (2,3) quant for
    u16 points): the K=1 batch."""
    mask = mask.reshape(1) if mask.dim() == 0 else mask[None]
    return integrate_batch(grid, points[None], rgb[None], mask, pose[None],
                           config, quant, offset, pre_transformed,
                           extra_dropped)


def integrate_depth(grid: GridState, depth: torch.Tensor,
                    rgb565: torch.Tensor, count: torch.Tensor,
                    pose: torch.Tensor, rays: torch.Tensor,
                    config: FusionConfig, offset=None) -> GridState:
    """One depth frame ((N,) u16 depth and rgb565, 0-d i32 count, (4,4)
    pose): the K=1 batch."""
    return integrate_batch_depth(grid, depth[None], rgb565[None],
                                 count.reshape(1), pose[None], rays, config,
                                 offset)
