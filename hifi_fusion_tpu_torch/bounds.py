"""The least time one H100 could take for each hand kernel's work.

A kernel's bound is the larger of two times: the bytes its function must
move over the card's memory rate, and the operations it must do over the
card's peak rate for their type.  Bytes count each input word the
function needs read once and each output word written once, at the
shapes and counts of the inputs it was given, whatever the kernel reads
again; where the work depends on the data (owners with hits, ids that
are new), the counts are this call's.  Operations are f32 operations
(the card's 67 TFLOP/s outside the tensor cores); integer hashing and
index arithmetic are not counted.  ``chip_smoke.py`` computes every bound
from the inputs its phase 3 times and prints it beside the kernel's time
(``share`` = bound / time).

Peak rates: NVIDIA's data sheet for the H100 SXM at its 700 W limit (a
card set below it runs slower under load; the smoke prints the limit).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3
F32_OPS_PER_S = 67e12           # H100 SXM, f32 outside the tensor cores


def bound(nbytes: int, ops: int = 0) -> dict:
    """``{"bytes", "ops", "bound_ms", "bound_by"}`` of a kernel call that
    must move ``nbytes`` and do ``ops`` f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def depth_frontend(K: int, N: int) -> dict:
    """K1 on K frames of N pixels: u16 depth and rgb565 (4 B a pixel), the
    (3,N) f32 rays, K counts and 4x4 poses in; world xyz, id and rgb (28 B
    a pixel) out.  ~30 f32 operations a pixel (unproject, transform, cell
    coordinates)."""
    px = K * N
    return bound(px * 4 + 12 * N + K * (4 + 64) + px * 28, 30 * px)


def planar_frontend(K: int, N: int, point_bytes: int = 12,
                    rgb_bytes: int = 12, mask_bytes: int = 1) -> dict:
    """K5 on K frames of N lanes: the points (12 B a lane as f32, 6 as
    u16 with a 24 B quantization a frame), the colour (12 B as f32
    channels, 4 packed, 2 as rgb565), the mask (1 B a lane, or a 4 B count
    a frame with ``mask_bytes=0``) and the 4x4 poses in; world xyz, id and
    rgb (28 B a lane) out.  ~30 f32 operations a lane (dequantize,
    transform, cell coordinates)."""
    px = K * N
    per_frame = 64 + (24 if point_bytes == 6 else 0) \
        + (4 if mask_bytes == 0 else 0)
    return bound(px * (point_bytes + rgb_bytes + mask_bytes + 28)
                 + K * per_frame, 30 * px)


def hash_insert(U: int, n_new: int) -> dict:
    """K2 on U distinct ids of which ``n_new`` were not in the table: each
    id read, one table word read, the new ids' words written, U slots and
    the failure count written.  Lanes of a budget-sized array past the ids
    (a live count on the card, or INVALID_ID lanes) are not the function's
    work and are not counted; callers report them beside the bound."""
    return bound(U * 4 + U * 4 + n_new * 4 + U * 4 + 4)


def hash_insert_counts(before: torch.Tensor, after: torch.Tensor) -> dict:
    """The counts of one K2 call from its key table before and after:
    ``n_new`` slots it filled, and the share of slots filled before and
    after (the load factor the probes met, and the one left)."""
    C = before.numel()
    filled = before >= 0
    return {"n_new": int((~filled & (after >= 0)).sum()),
            "load_before": int(filled.sum()) / C,
            "load_after": int((after >= 0).sum()) / C}


def dep_stream(n: int, n_cells: int, n_dep_words: int, n_owners: int,
               n_hit_owners: int, n_pairs: int) -> dict:
    """K3 on n point lanes: each lane's xyz and slot (16 B); per cell its
    dep_count and its ``min(dep_count, D)`` owner words; per distinct
    owner its key and normal (16 B); per owner with a hit its 5 cyl_stats
    sums read and written (40 B).  ~20 f32 operations per (point, owner)
    pair (``n_pairs``) for the cylinder gate."""
    return bound(n * 16 + n_cells * 4 + n_dep_words * 4 + n_owners * 16
                 + n_hit_owners * 40, 20 * n_pairs)


def dep_stream_counts(slots: torch.Tensor, dep: torch.Tensor,
                      dep_count: torch.Tensor, D: int,
                      hits_added: torch.Tensor) -> dict:
    """The counts of ``dep_stream`` for (n,) i32 ``slots`` sorted by cell
    (-1 = skip), the grid's flat ``dep`` and ``dep_count``, and the (C,)
    hits the call added to each owner."""
    n = int(slots.numel())
    cells, run = torch.unique_consecutive(slots, return_counts=True)
    placed = cells >= 0
    cells, run = cells[placed].long(), run[placed]
    cnt = dep_count[cells].clamp(max=D).long()
    owners = dep.view(-1, D)[cells]
    listed = torch.arange(D, device=slots.device)[None, :] < cnt[:, None]
    valid = listed & (owners >= 0)
    return {"n": n, "n_cells": int(cells.numel()),
            "n_dep_words": int(cnt.sum()),
            "n_owners": int(torch.unique(owners[valid]).numel()),
            "n_hit_owners": int((hits_added > 0).sum()),
            "n_pairs": int((valid.sum(1) * run).sum())}


def normal_fit(U: int, n_gated: int, n_words: int) -> dict:
    """K4 on U candidates: each candidate's slot, key and viewpoint in and
    its oriented normal and gate out (33 B); the gated ones' normal and
    flag written (13 B); ``n_words`` distinct 4 B bitmap words under the
    candidates' windows.  ~150 f32 operations a candidate for the
    eigenpair and the orientation (the window's moment sums, which depend
    on its occupancy, are not counted)."""
    return bound(U * 33 + n_gated * 13 + n_words * 4, 150 * U)


def normal_fit_words(ids: torch.Tensor, dims, k: int, W: int) -> int:
    """The distinct bitmap words K4 reads for candidates with cell ids
    ``ids`` (and B11 for queries of those cells at radius k): two words
    per in-bounds (dx, dy) column of the (2k+1)^2 window, as the kernels
    address them."""
    ids = ids.long()
    dz = dims[2]
    cz, cy, cx = ids % dz, (ids // dz) % dims[1], (ids // dz) // dims[1]
    r = torch.arange(-k, k + 1, device=ids.device)
    nx = cx[:, None, None] + r[None, :, None]
    ny = cy[:, None, None] + r[None, None, :]
    ok = (nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
    col = (nx * dims[1] + ny) * dz + cz[:, None, None]
    w0 = ((col - k).clamp(min=0) >> 5).clamp(max=W - 1)[ok]
    words = torch.cat([w0, (w0 + 1)[w0 + 1 < W]])
    return int(torch.unique(words).numel())


def segscan(k: int, n: int) -> dict:
    """T1 on (k, n) words: k words and a 1 B flag in, k words out, a lane
    (49 B at k = 6); one operation a lane and channel, the least any scan
    needs (the ladder does up to 9)."""
    return bound(n * (8 * k + 1), k * n)


def tsdf_lanes(K: int, N: int, S: int) -> dict:
    """T2 on K frames of N pixels and S samples a pixel: 4 B of wire a
    pixel, the rays, counts and poses in; an i32 key and six f32 values
    (28 B) a sample lane out.  ~40 f32 operations a pixel and ~12 a
    sample."""
    return bound(K * N * 4 + 12 * N + K * (4 + 64) + K * N * S * 28,
                 K * N * (40 + 12 * S))


def tsdf_lanes_planar(K: int, N: int, S: int, mask_bytes: int = 0) -> dict:
    """T2p on K frames of N points and S samples a point: 12 B of f32
    camera points and 12 B of f32 colour a point, the mask (1 B a point,
    or a 4 B count a frame with ``mask_bytes=0``) and the poses in; an i32
    key and six f32 values (28 B) a sample lane out.  ~40 f32 operations
    a point and ~12 a sample."""
    per_frame = 64 + (4 if mask_bytes == 0 else 0)
    return bound(K * N * (24 + mask_bytes) + K * per_frame
                 + K * N * S * 28, K * N * (40 + 12 * S))


def neighbor_count(Q: int, n_live: int, n_words: int) -> dict:
    """B11 on Q query slots of which ``n_live`` are not -1: each slot read
    and each count written (8 B a query), a live query's key read (4 B),
    and the ``n_words`` distinct 4 B bitmap words under the live queries'
    windows read once (``normal_fit_words``).  No f32 operations."""
    return bound(8 * Q + 4 * n_live + 4 * n_words)


def tsdf_surface(E: int) -> dict:
    """T3 on E surface cells: the cell id and slot, its six vstats words,
    and per face neighbour one key word and two vstats words (104 B) in;
    centroid, normal, tsdf, weight and rgb (44 B) out.  ~60 f32
    operations a cell."""
    return bound(E * (104 + 44), 60 * E)


def route_pack(K: int, N: int, n: int, Bs: int, wire: str = "depth",
               mask_bytes: int = 1) -> dict:
    """B12 on K frames of N lanes for n shards at the send budget Bs: the
    wire in (``depth``: u16 depth and rgb565, 4 B a lane, the (3,N) f32
    rays and an i32 count a frame; ``planar``: f32 points and rgb, 24 B a
    lane, and the mask, 1 B a lane or with ``mask_bytes=0`` a 4 B count a
    frame) with a 4x4 pose a frame; K * n * n * Bs columns out, 25 B
    each (world and rgb f32, present 1 B), the zeroed padding included.
    ~30 f32 operations a lane (unproject, transform, cell coordinates)."""
    px = K * N
    if wire == "depth":
        wire_bytes = px * 4 + 12 * N + K * (4 + 64)
    else:
        wire_bytes = px * (24 + mask_bytes) + K * (
            64 + (4 if mask_bytes == 0 else 0))
    return bound(wire_bytes + K * n * n * Bs * 25, 30 * px)


def tsdf_sort_passes(D: int) -> int:
    """The 8-bit passes T5 runs over the dense ranks of a batch with D
    distinct ids (ranks 0 to D, D for an invalid lane)."""
    return 1 if D < 1 << 8 else 2 if D < 1 << 16 else 3 if D < 1 << 24 \
        else 4


def tsdf_sort(M: int) -> dict:
    """T5 on M sample lanes: the least the function moves, each id read
    (4 B) and its sorted id and i32 order written (8 B), 12 B a lane.
    T5's design moves more (the ids read again by the histogram sweep,
    the ranks written, and each pass's pairs read and written: PERF.md
    §6).  No f32 operation."""
    return bound(M * (4 + 8))


def tsdf_reduce(M: int, n_live: int, n_new: int, n_placed: int) -> dict:
    """T4 on M sorted sample lanes whose first ``n_live`` runs are kept:
    per lane its sorted id (4 B), its order word (8 B) and its six values
    through the order (24 B) read; per kept run its key probe (4 B), a new
    cell's key written (4 B); per placed cell its six ``vstats`` words
    read and written (48 B); the two counters.  The compacted ids and sums
    are the kernel's own and not counted.  One f32 add a lane and channel
    (the segment sums) and a placed cell and channel."""
    return bound(M * 36 + n_live * 4 + n_new * 4 + n_placed * 48 + 8,
                 6 * (M + n_placed))


def integrate_lanes(NA: int, n_sv: int, U: int, n_new: int, n_first: int,
                    n_words: int, n_want: int,
                    store_color: bool = True) -> dict:
    """B3 on the first NA sorted lanes of a batch, ``n_sv`` of them valid,
    in U distinct cells: each lane's sorted id and i64 order read (12 B);
    each valid lane's world point (and colour) gathered (12 B, 24 B with
    colour); the sorted points and slots K3 takes written (16 B a lane);
    per cell its key probe, n_pts read and written, normal_found, and
    with colour rgb_sum read and written (13 B, 37 B); a new cell's key
    (4 B), a first occupancy's viewpoint (12 B), each distinct bitmap
    word read and written (8 B), each appended lane's point and slot
    (16 B).  One f32 add a valid lane and channel (the count, and Σrgb
    with colour)."""
    ch = 4 if store_color else 1
    per_valid = 24 if store_color else 12
    per_cell = 37 if store_color else 13
    return bound(NA * 28 + n_sv * per_valid + U * per_cell + n_new * 4
                 + n_first * 12 + n_words * 8 + n_want * 16, ch * n_sv)


def refine_lines(U: int, n_gated: int, L: int, n_cells: int, n_new: int,
                 n_written: int) -> dict:
    """B6 on U candidates with L line steps: each candidate's slot, key,
    normal and gate read (21 B); each of the L*U lanes' link written
    (its line slot or -1, 4 B); per distinct line cell its key probe
    and dep_count read and written (12 B), a new cell's key (4 B); each
    written link's owner word (4 B).  ~10 f32 operations a line point of
    a gated candidate (the point, its floors and its bbox test)."""
    return bound(U * 21 + L * U * 4 + n_cells * 12 + n_new * 4
                 + n_written * 4, 10 * L * n_gated)


def buffer_replay(P: int, n_owners: int, n_points: int, n_pairs: int,
                  n_hit_owners: int) -> dict:
    """B7 on P link lanes (the owner-major links, a line slot or -1, 4 B
    each): per candidate with a written link (``n_owners``) its slot, key
    and normal (20 B); each buffered point of a replayed cell read once,
    with its slot (16 B); per owner with a hit its 5 cyl_stats sums read
    and written (40 B).  ~20 f32 operations per (link, point) pair
    (``n_pairs``) for the cylinder gate and the sums."""
    return bound(P * 4 + n_owners * 20 + n_points * 16 + n_hit_owners * 40,
                 20 * n_pairs)


def buffer_replay_per_link(P: int, n_links: int, n_points: int,
                           n_pairs: int, n_hit_owners: int) -> dict:
    """The yardstick B7's shares were first read against, kept so that
    they compare across designs: 8 B a link lane (a line slot and a
    candidate, as B6 first wrote the links) and the owner's 20 B for each
    of the ``n_links`` written links, the rest as ``buffer_replay``.  It
    counts more than the function needs; ``buffer_replay`` is the
    bound."""
    return bound(P * 8 + n_links * 20 + n_points * 16 + n_hit_owners * 40,
                 20 * n_pairs)


def buffer_replay_counts(links: torch.Tensor, bslot: torch.Tensor,
                         hits_added: torch.Tensor) -> dict:
    """The counts of ``buffer_replay`` and ``buffer_replay_per_link`` for
    the (U, L) owner-major ``links`` (-1 = no link), the slot-sorted
    buffer ``bslot`` and the (C,) hits the call added to each owner."""
    s = links[links >= 0]
    first = torch.searchsorted(bslot, s)
    run = torch.searchsorted(bslot, s, right=True) - first
    cells = torch.unique(s)
    cfirst = torch.searchsorted(bslot, cells)
    crun = torch.searchsorted(bslot, cells, right=True) - cfirst
    return {"P": int(links.numel()), "n_links": int(s.numel()),
            "n_owners": int((links >= 0).any(1).sum()),
            "n_points": int(crun.sum()), "n_pairs": int(run.sum()),
            "n_hit_owners": int((hits_added > 0).sum())}
