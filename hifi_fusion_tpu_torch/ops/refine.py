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
   reference steps by xres on every axis), deduplicated and found or
   inserted with kernel K2; new cells are ghosts (a key, no points);
4. dependant append: links (line slot -> owner) grouped by line slot in
   (step, candidate) order, each at ``dep_count + rank`` while it fits in
   D, else counted in ``overflow_dep``; a line that revisits a cell keeps
   both visits, as the reference does;
5. replay: every link created in this pass streams the line slot's
   buffered points through the owner's new cylinder;
6. reclamation: with ``reclaim_buffer`` the buffer keeps only lanes whose
   voxel still lacks a normal; without it the buffer is re-laid out by
   slot, unchanged in content.

Stages 3-6 are plain PyTorch in this slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..config import FusionConfig
from ..grid import GridState, occupied_slots
from . import geometry, hashing
from .eigen33 import smallest_eigenpair_sym
from .integrate import cylinder_add
from .scatter import run_sums, runs


def _neighbor_offsets(config: FusionConfig) -> np.ndarray:
    """(3,M) int offsets of the (2k+1)^3 window, dx-major, dz fastest."""
    k = config.k_neighborhood
    r = np.arange(-k, k + 1)
    grid = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1)
    return grid.reshape(-1, 3).T.copy()


def normal_fit_plain(cand, grid, config):
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

    center = geometry.cell_center(coords, config)
    vp = grid.viewpoint.view(-1, 3)[cand.long()].t()
    dv = vp - center
    flip = ((dv[0] * nvec[0] + dv[1] * nvec[1]) + dv[2] * nvec[2]) < 0.0
    nvec = torch.where(flip[None, :], -nvec, nvec)
    gs = cand[gated].long()
    grid.normal.view(-1, 3)[gs] = nvec[:, gated].t()
    grid.normal_found[gs] = True
    return nvec.contiguous(), gated


def normal_fit(cand: torch.Tensor, grid: GridState, config: FusionConfig):
    """Fit, gate and orient the normals of the (U,) i32 candidate slots.
    Gated candidates get ``normal`` and ``normal_found`` in place; returns
    ``(nvec (3,U) f32, gated (U,) bool)`` for every candidate.  Kernel K4
    on CUDA tensors, its plain version on CPU tensors."""
    dev = grid.device
    if cand.dtype != torch.int32 or cand.dim() != 1 \
            or cand.device != dev or not cand.is_contiguous():
        raise ValueError(f"candidates must be contiguous (U,) int32 on {dev}")
    if dev.type == "cpu":
        return normal_fit_plain(cand, grid, config)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    U = cand.numel()
    nvec = torch.empty((3, U), dtype=torch.float32, device=dev)
    gated = torch.empty((U,), dtype=torch.bool, device=dev)
    if U == 0:
        return nvec, gated
    gf, gi = kernels.geometry_args(config)
    lib = kernels.library()
    kernels.check(lib.launch_normal_fit(
        cand.data_ptr(), U, grid.key.data_ptr(), grid.occ_bits.data_ptr(),
        grid.occ_bits.numel(), grid.viewpoint.data_ptr(), kernels.ptr(gf),
        kernels.ptr(gi), config.k_neighborhood, config.min_neighbors,
        nvec.data_ptr(), gated.data_ptr(), grid.normal.data_ptr(),
        grid.normal_found.data_ptr(), kernels.stream()), "normal_fit")
    kernels.LAUNCHES["normal_fit"] += 1
    return nvec, gated


def refine_pass(grid: GridState, config: FusionConfig) -> GridState:
    """One refinement pass over ``grid`` in place; returns ``grid``."""
    dev = grid.device
    C = config.capacity
    D = config.max_dependants
    Kl = config.line_k
    L = config.n_line
    f32, i32 = torch.float32, torch.int32

    # --- 1. candidates ---------------------------------------------------
    cand = torch.nonzero(occupied_slots(grid) & ~grid.normal_found
                         ).squeeze(1)
    n_cand = cand.numel()
    U = min(n_cand, config.max_refine_candidates)
    grid.overflow_refine += n_cand - U
    cand = cand[:U].to(i32)

    # --- 2. normal fit (K4) -----------------------------------------------
    nvec, gated = normal_fit(cand, grid, config)
    center = geometry.center_of_ids(grid.key[cand.long()], config)  # (3,U)

    # --- 3. line cells ----------------------------------------------------
    res0 = torch.tensor(config.resolution[0], dtype=f32, device=dev)
    steps = torch.arange(-Kl, Kl + 1, dtype=f32, device=dev)
    line = (center[:, None, :]
            + steps[None, :, None] * res0 * nvec[:, None, :])       # (3,L,U)
    lc = geometry.cell_coords(line, config)
    lp_valid = (geometry.valid_points(line, config) & gated[None, :]
                & geometry.valid_coords(lc, config)).reshape(-1)    # (L*U,)
    lids = geometry.cell_id(lc, config).reshape(-1)
    uq, inv = torch.unique(lids[lp_valid], return_inverse=True)
    uslot, n_failed = hashing.lookup_or_insert(
        grid.key, uq.to(i32), config.max_probes, C)
    grid.overflow_probe += n_failed
    lslot = torch.full((L * U,), -1, dtype=i32, device=dev)
    lslot[lp_valid] = uslot[inv]

    # --- 4. dependant append ----------------------------------------------
    pair = torch.nonzero(lslot >= 0).squeeze(1)     # (step, cand) order
    sL, perm = torch.sort(lslot[pair], stable=True)
    sU = (pair[perm] % max(U, 1))                   # candidate index
    sO = cand[sU]                                   # owner slot
    lkey, lstart, _, lrun = runs(sL)
    rank = torch.arange(sL.numel(), device=dev) - lstart[lrun]
    sl = sL.long()
    pos = grid.dep_count[sl] + rank
    write = pos < D
    grid.overflow_dep += (~write).sum().to(i32)
    grid.dep[sl[write] * D + pos[write]] = sO[write]
    grid.dep_count[lkey.long()] += run_sums(write.to(i32), lrun,
                                            lkey.numel())

    # --- 5. replay of the links created in this pass ------------------------
    bc = int(grid.buf_count)
    bslot, border = torch.sort(grid.buf_slot[:bc], stable=True)
    bpts = grid.buf_pts[:, :bc][:, border]
    ls, lu = sL[write], sU[write]
    first = torch.searchsorted(bslot, ls)
    cnt = torch.searchsorted(bslot, ls, right=True) - first
    link = torch.repeat_interleave(torch.arange(ls.numel(), device=dev),
                                   cnt)
    within = (torch.arange(link.numel(), device=dev)
              - (torch.cumsum(cnt, 0) - cnt)[link])
    u = lu[link]
    cylinder_add(grid.cyl_stats, sO[write][link].long(),
                 bpts[:, first[link] + within], center[:, u], nvec[:, u],
                 config.cylinder_radius)

    # --- 6. reclamation -----------------------------------------------------
    if config.reclaim_buffer:
        keep = ~grid.normal_found[bslot.long()]
        n_keep = int(keep.sum())
        grid.buf_pts[:, :n_keep] = bpts[:, keep]
        grid.buf_slot[:n_keep] = bslot[keep]
        grid.buf_slot[n_keep:bc] = -1
        grid.reclaimed += bc - n_keep
        grid.buf_count.fill_(n_keep)
    else:
        grid.buf_pts[:, :bc] = bpts
        grid.buf_slot[:bc] = bslot
    return grid
