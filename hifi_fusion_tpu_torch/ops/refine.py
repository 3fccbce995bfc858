"""Normal refinement pass.

The counterpart of ``refine_pass_impl`` in ``hifi_fusion_tpu/ops/refine.py``
(:138-599) at the full config budgets, with no budget tiers:

1. candidates: occupied voxels without a normal, ascending slot, at most
   ``max_refine_candidates`` (the rest are deferred and counted in
   ``overflow_refine``);
2. the normal fit, kernel K4 (``normal_fit``): the (2k+1)^3 occupancy
   window, the ``total >= min_neighbors`` gate, offset-space moments,
   the closed-form smallest eigenvector, orientation toward the stored
   viewpoint;
3. line cells: ``center + (s * xres) * normal`` for s in [-K, K] (the
   reference steps by xres on every axis; the multiply-add fused, as XLA
   compiles it), deduplicated and found or inserted with kernel K2; new
   cells are ghosts (a key, no points);
4. dependant append: links (line slot -> owner) grouped by line slot in
   (step, candidate) order, each at ``dep_count + rank`` while it fits in
   D, else counted in ``overflow_dep``; a line that revisits a cell keeps
   both visits, as the reference does;
5. replay: every link created in this pass streams the line slot's
   buffered points through the owner's new cylinder;
6. reclamation: with ``reclaim_buffer`` the buffer keeps only lanes whose
   voxel still lacks a normal; without it the buffer is re-laid out by
   slot, unchanged in content.

Stages 3-4 are kernel B6 (``refine_lines``), stage 5 kernel B7
(``buffer_replay``); stages 1 and 6 are PyTorch ops.  The pass reads the
host once: the candidate count and the buffer count, in one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import FusionConfig
from ..grid import GridState, occupied_slots
from . import geometry, hashing
from .eigen33 import smallest_eigenpair_sym
from .hashing import INVALID_ID
from .integrate import cylinder_add
from .scatter import run_sums, runs


def _neighbor_offsets(config: FusionConfig) -> np.ndarray:
    """(3,M) int offsets of the (2k+1)^3 window, dx-major, dz fastest."""
    k = config.k_neighborhood
    r = np.arange(-k, k + 1)
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).T.copy()


def normal_fit_plain(cand, grid, config, offset=None):
    dev = cand.device
    f32 = torch.float32
    coords = geometry.id_to_coords(grid.key[cand.long()], config)   # (3,U)
    offs = torch.from_numpy(_neighbor_offsets(config)).to(
        dev, torch.int32)                                           # (3,M)
    nc = coords[:, None, :] + offs[:, :, None]                      # (3,M,U)
    nvalid = geometry.valid_coords(nc, config)
    nid = torch.where(nvalid, geometry.cell_id(nc, config),
                      torch.zeros_like(nvalid, dtype=torch.int32))
    words = grid.occ_bits[(nid >> 5).long()]
    nocc = nvalid & (((words >> (nid & 31)) & 1) != 0)              # (M,U)
    total = nocc.sum(dim=0)
    gated = total >= config.min_neighbors

    res = torch.tensor(config.resolution, dtype=f32, device=dev)
    off_m = offs.to(f32) * res[:, None]
    ox, oy, oz = off_m[0], off_m[1], off_m[2]
    basis = torch.stack([ox, oy, oz, ox * ox, ox * oy, ox * oz,
                         oy * oy, oy * oz, oz * oz], dim=0)         # (9,M)
    # moments summed over the window in (dx, dy, dz) order, as kernel K4
    # sums them (adding 0 for an empty cell leaves a sum unchanged)
    noccf = nocc.to(f32)
    m = torch.zeros((9, coords.shape[1]), dtype=f32, device=dev)
    for o in range(basis.shape[1]):
        m += basis[:, o, None] * noccf[o]                           # (9,U)
    tot = torch.clamp(total.to(f32), min=1.0)
    mx, my, mz = m[0] / tot, m[1] / tot, m[2] / tot
    _, nvec = smallest_eigenpair_sym(
        m[3] / tot - mx * mx, m[4] / tot - mx * my, m[5] / tot - mx * mz,
        m[6] / tot - my * my, m[7] / tot - my * mz, m[8] / tot - mz * mz)

    center = geometry.cell_center(geometry.shift(coords, offset), config)
    vp = grid.viewpoint.view(-1, 3)[cand.long()].t()
    dv = vp - center
    flip = ((dv[0] * nvec[0] + dv[1] * nvec[1]) + dv[2] * nvec[2]) < 0.0
    nvec = torch.where(flip[None, :], -nvec, nvec)
    gs = cand[gated].long()
    grid.normal.view(-1, 3)[gs] = nvec[:, gated].t()
    grid.normal_found[gs] = True
    return nvec.contiguous(), gated


def normal_fit(cand: torch.Tensor, grid: GridState, config: FusionConfig,
               offset=None):
    """Fit, gate and orient the normals of the (U,) i32 candidate slots.
    Gated candidates get ``normal`` and ``normal_found`` in place; returns
    ``(nvec (3,U) f32, gated (U,) bool)`` for every candidate.  The window
    is local, the orientation uses the global center (``offset``: the
    shard's coordinate offset).  Kernel K4 on CUDA tensors, its plain
    version on CPU tensors."""
    dev = grid.device
    if cand.dtype != torch.int32 or cand.dim() != 1 \
            or cand.device != dev or not cand.is_contiguous():
        raise ValueError(f"candidates must be contiguous (U,) int32 on {dev}")
    if dev.type == "cpu":
        return normal_fit_plain(cand, grid, config, offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    U = cand.numel()
    nvec = torch.empty((3, U), dtype=torch.float32, device=dev)
    gated = torch.empty((U,), dtype=torch.bool, device=dev)
    if U == 0:
        return nvec, gated
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    kernels.check(lib.launch_normal_fit(
        cand.data_ptr(), U, grid.key.data_ptr(), grid.occ_bits.data_ptr(),
        grid.occ_bits.numel(), grid.viewpoint.data_ptr(), kernels.ptr(gf),
        kernels.ptr(gi), config.k_neighborhood, config.min_neighbors,
        nvec.data_ptr(), gated.data_ptr(), grid.normal.data_ptr(),
        grid.normal_found.data_ptr(), kernels.stream()), "normal_fit")
    kernels.LAUNCHES["normal_fit"] += 1
    return nvec, gated


def line_cells(cand, nvec, gated, grid, config, offset=None):
    """The (L*U,) i32 local cell ids of the candidates' line points, lanes
    step-major, and their (L*U,) bool validity (a gated candidate, a point
    strictly inside the bbox, a cell inside the grid): plain PyTorch on
    any device.  XLA's jitted program computes each point as steps * res0
    rounded, then one fused multiply-add onto the center; so does this,
    and so does kernel B6."""
    dev = cand.device
    Kl = config.line_k
    f32 = torch.float32
    center = geometry.center_of_ids(grid.key[cand.long()], config, offset)
    sr = torch.arange(-Kl, Kl + 1, dtype=f32, device=dev) * torch.tensor(
        config.resolution[0], dtype=f32, device=dev)
    line = geometry.fma_f32(sr[None, :, None], nvec[:, None, :],
                            center[:, None, :])                     # (3,L,U)
    lc = geometry.shift(geometry.cell_coords(line, config), offset, -1)
    valid = (geometry.valid_points(line, config) & gated[None, :]
             & geometry.valid_coords(lc, config)).reshape(-1)
    return geometry.cell_id(lc, config).reshape(-1), valid


def refine_lines_plain(cand, nvec, gated, grid, config, offset=None):
    dev = cand.device
    U = cand.numel()
    L, D = config.n_line, config.max_dependants
    i32 = torch.int32
    lids, lp_valid = line_cells(cand, nvec, gated, grid, config, offset)
    uq, inv = torch.unique(lids[lp_valid], return_inverse=True)
    uslot = hashing.lookup_or_insert(grid.key, uq.to(i32), config.max_probes,
                                     config.capacity, grid.overflow_probe)
    lslot = torch.full((L * U,), -1, dtype=i32, device=dev)
    lslot[lp_valid] = uslot[inv]

    # links grouped by line slot, (step, candidate) order within a slot
    sL, perm = torch.sort(torch.where(lslot >= 0, lslot, INVALID_ID),
                          stable=True)
    lu = (perm % max(U, 1)).to(i32)
    n_ok = int((sL != INVALID_ID).sum())
    sl = sL[:n_ok].long()
    lkey, lstart, _, lrun = runs(sl)
    rank = torch.arange(n_ok, device=dev) - lstart[lrun]
    pos = grid.dep_count[sl] + rank
    write = pos < D
    grid.overflow_dep += (~write).sum().to(i32)
    grid.dep[sl[write] * D + pos[write]] = cand[lu[:n_ok][write].long()]
    grid.dep_count[lkey] += run_sums(write.to(i32), lrun, lkey.numel())
    ls = torch.full((L * U,), -1, dtype=i32, device=dev)
    ls[:n_ok] = torch.where(write, sL[:n_ok], -1)
    return ls, lu


def refine_lines(cand: torch.Tensor, nvec: torch.Tensor,
                 gated: torch.Tensor, grid: GridState,
                 config: FusionConfig, offset=None):
    """Stages 3-4 for the (U,) i32 candidate slots with their fitted
    normals ``nvec`` (3,U) f32 and gates ``gated`` (U,) bool: the L = 2k+1
    line points ``center + (s*xres)*normal`` of each gated candidate,
    their cells found or inserted (K2; a new one is a ghost), and each
    candidate appended to the dependant list of every cell its line
    visits, at ``dep_count + rank`` in (step, candidate) order while that
    is under D, else counted in ``overflow_dep``.  Updates ``grid`` in
    place; returns the links ``(ls, lu)``, (L*U,) i32 each, one a lane,
    the lanes of one line cell together in (step, candidate) order: the
    line slot where the link was written (-1 where not) and the candidate
    index, the input of ``buffer_replay``.  Centers and line points are
    global, line cells local (``offset``).

    Kernel B6 (``csrc/refine_lines.cu``) with K2 and a library sort on
    CUDA tensors, reading nothing back to the host, its groups in cell-id
    order; its plain version on CPU tensors, grouped by slot as the JAX
    package groups them.  Line slots may differ (K2's CAS race); the cells,
    the dependant lists in order and the set of links are the same by cell
    id."""
    dev = grid.device
    U = cand.numel()
    kernels.check_inputs(dev, ("cand", cand, torch.int32, (U,)),
                         ("nvec", nvec, torch.float32, (3, U)),
                         ("gated", gated, torch.bool, (U,)))
    if dev.type == "cpu":
        return refine_lines_plain(cand, nvec, gated, grid, config, offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    i32 = torch.int32
    P = config.n_line * U
    ls = torch.empty((P,), dtype=i32, device=dev)
    lu = torch.empty((P,), dtype=i32, device=dev)
    if P == 0:
        return ls, lu
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    st = kernels.stream()
    lid = torch.empty((P,), dtype=i32, device=dev)
    kernels.check(lib.launch_refine_lines_points(
        cand.data_ptr(), U, config.n_line, config.line_k,
        float(config.resolution[0]), grid.key.data_ptr(), nvec.data_ptr(),
        gated.data_ptr(), kernels.ptr(gf), kernels.ptr(gi), lid.data_ptr(),
        st), "refine_lines")
    sid, lane = torch.sort(lid, stable=True)
    starts = torch.empty((P,), dtype=i32, device=dev)
    kernels.check(lib.launch_refine_lines_starts(
        sid.data_ptr(), P, starts.data_ptr(), st), "refine_lines")
    kslot = hashing.lookup_or_insert(grid.key, starts, config.max_probes,
                                     config.capacity, grid.overflow_probe)
    kernels.check(lib.launch_refine_lines_append(
        sid.data_ptr(), lane.data_ptr(), starts.data_ptr(),
        kslot.data_ptr(), P, U, cand.data_ptr(), config.max_dependants,
        grid.dep.data_ptr(), grid.dep_count.data_ptr(),
        grid.overflow_dep.data_ptr(), ls.data_ptr(), lu.data_ptr(), st),
        "refine_lines")
    kernels.LAUNCHES["refine_lines"] += 1
    return ls, lu


def buffer_replay_plain(ls, lu, cand, nvec, bslot, bpts, grid, config,
                        offset=None):
    dev = ls.device
    w = ls >= 0
    l_s, l_u = ls[w], lu[w].long()
    first = torch.searchsorted(bslot, l_s)
    cnt = torch.searchsorted(bslot, l_s, right=True) - first
    link = torch.repeat_interleave(torch.arange(l_s.numel(), device=dev),
                                   cnt)
    within = (torch.arange(link.numel(), device=dev)
              - (torch.cumsum(cnt, 0) - cnt)[link])
    u = l_u[link]
    center = geometry.center_of_ids(grid.key[cand.long()], config, offset)
    cylinder_add(grid.cyl_stats, cand[u].long(), bpts[:, first[link] + within],
                 center[:, u], nvec[:, u], config.cylinder_radius)


def buffer_replay(ls: torch.Tensor, lu: torch.Tensor, cand: torch.Tensor,
                  nvec: torch.Tensor, bslot: torch.Tensor,
                  bpts: torch.Tensor, grid: GridState, config: FusionConfig,
                  offset=None) -> None:
    """Stage 5: every link written in this pass (``ls``, ``lu`` from
    ``refine_lines``: line slot, -1 where none, and candidate index)
    streams the buffered points of its line cell through its owner's
    cylinder (the candidate ``cand[lu]`` with normal ``nvec[:, lu]`` and
    its global center); hits add [t, t², d, d², 1] to the owner's
    ``cyl_stats`` in place.  ``bslot`` (bc,) i32 ascending and ``bpts``
    (3,bc) f32 are the live buffer sorted by slot.  Kernel B7
    (``csrc/buffer_replay.cu``) on CUDA tensors, its plain version on CPU
    tensors: hit counts equal, the sums up to addition order."""
    dev = grid.device
    P, U, bc = ls.numel(), cand.numel(), bslot.numel()
    kernels.check_inputs(dev, ("ls", ls, torch.int32, (P,)),
                         ("lu", lu, torch.int32, (P,)),
                         ("cand", cand, torch.int32, (U,)),
                         ("nvec", nvec, torch.float32, (3, U)),
                         ("bslot", bslot, torch.int32, (bc,)),
                         ("bpts", bpts, torch.float32, (3, bc)))
    if dev.type == "cpu":
        buffer_replay_plain(ls, lu, cand, nvec, bslot, bpts, grid, config,
                            offset)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if P == 0 or bc == 0:
        return
    gf, gi = kernels.geometry_args(config, offset)
    lib = kernels.library()
    kernels.check(lib.launch_buffer_replay(
        ls.data_ptr(), lu.data_ptr(), P, cand.data_ptr(), U, nvec.data_ptr(),
        grid.key.data_ptr(), bslot.data_ptr(), bpts.data_ptr(), bc,
        kernels.ptr(gf), kernels.ptr(gi), float(config.cylinder_radius),
        grid.cyl_stats.data_ptr(), kernels.stream()), "buffer_replay")
    kernels.LAUNCHES["buffer_replay"] += 1


def refine_pass(grid: GridState, config: FusionConfig,
                offset=None) -> GridState:
    """One refinement pass over ``grid`` in place; returns ``grid``.
    ``offset``: a shard's coordinate offset; centers and line points are
    global, line cells local (JAX refine.py:172-176, :269-270).  One read
    back to the host: the candidate count and the buffer count, fetched
    together, which size the candidates and the live buffer."""
    dev = grid.device
    C = config.capacity
    i32 = torch.int32

    # --- 1. candidates: a stable compaction on the device ------------------
    mask = occupied_slots(grid) & ~grid.normal_found
    idx = torch.cumsum(mask, 0)
    cand_all = torch.empty((C + 1,), dtype=i32, device=dev)
    cand_all.scatter_(0, torch.where(mask, idx - 1, C),
                      torch.arange(C, dtype=i32, device=dev))
    n_cand, bc = torch.stack([idx[-1], grid.buf_count.long()]).cpu().tolist()
    U = min(n_cand, config.max_refine_candidates)
    grid.overflow_refine += n_cand - U
    cand = cand_all[:U]

    # --- 2. normal fit (K4) ------------------------------------------------
    nvec, gated = normal_fit(cand, grid, config, offset)

    # --- 3-4. line cells and the dependant append (B6) -----------------------
    ls, lu = refine_lines(cand, nvec, gated, grid, config, offset)

    # --- 5. replay of the links created in this pass (B7) --------------------
    bslot, border = torch.sort(grid.buf_slot[:bc], stable=True)
    bpts = grid.buf_pts[:, :bc][:, border].contiguous()
    buffer_replay(ls, lu, cand, nvec, bslot, bpts, grid, config, offset)

    # --- 6. reclamation (B8): the kept lanes first, in slot order ------------
    if config.reclaim_buffer:
        keep = ~grid.normal_found[bslot.long()]
        korder = torch.sort((~keep).to(torch.uint8), stable=True)[1]
        n_keep = keep.sum(dtype=i32)
        grid.buf_pts[:, :bc] = bpts[:, korder]
        grid.buf_slot[:bc] = torch.where(
            torch.arange(bc, device=dev) < n_keep, bslot[korder], -1)
        grid.reclaimed += bc - n_keep
        grid.buf_count.copy_(n_keep)
    else:
        grid.buf_pts[:, :bc] = bpts
        grid.buf_slot[:bc] = bslot
    return grid
