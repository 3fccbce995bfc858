"""Slab-sharded fusion: the grid split into x slabs, one shard each.

The counterpart of ``hifi_fusion_tpu/parallel/sharding.py``:

* the x cell range is split into ``n`` core slabs of ``slab_w = ceil(
  x_cells / n)`` cells; shard ``j`` holds a grid of its own over its slab
  plus a halo of ``k_neighborhood + line_k + 1`` cells on each side, in
  LOCAL coordinates: its config has ``shard_x_cells = slab_w + 2 * halo``
  and its integer coordinate offset is ``(j * slab_w - halo, 0, 0)``, so
  the int32 cell-id cap holds per shard (the launch-file bbox at 1 mm,
  7.8 G cells, fits 8 shards of ~1 G).  World arithmetic and cell centers
  stay global, bit-identical across shards;
* the replicated ingest (``route=False``) runs each shard's whole frontend
  (kernel K1 or K5) on every frame with that shard's offset: each keeps
  the points of its window, halo voxels are computed on both neighbours
  identically;
* the routed ingest (``route=True``) routes each point to its owner slab
  (and at most one halo neighbour) with kernel B12 (``routing.py``), so a
  shard integrates ~``beta * N / n`` lanes a frame; send buckets past the
  top budget tier drop points and count them in ``overflow_active``,
  booked on shard 0 only;
* refine is local (the halo covers every quantity a core voxel's output
  depends on); extract emits each shard's core slab, and the host maps
  local ids to global int64 ids (x-major ids, slabs ascending in x, so
  concatenating the shards keeps the global order).

The JAX package drives a device mesh from one process through
``shard_map``; so does this module, with one process holding every shard.
Shards may share a device (the CPU tests put every shard on the CPU, one
card can hold all of them); the exchange is one code path either way
(``routing.exchange_batch``).  The shard count is always the number of
devices given.

The sharded state has the JAX package's layout: every per-voxel field
concatenated over the shards on its leading axis, ``buf_pts`` on its lane
axis, each scalar as an (n,) array (JAX sharding.py:84-96, :176-179).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..config import FusionConfig
from ..grid import GridState
from ..models.pipeline import FusionPipeline
from ..ops.extract import (EXTRACT_FIELDS, ExtractResult, cached_fetch,
                           to_host)
from ..ops.integrate import integrate
from . import routing


def shard_devices(device, n: int) -> List[torch.device]:
    """Shard ``j``'s device: ``cuda:(j % device_count)`` for a CUDA
    ``device``, ``device`` itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA card is visible")
    return [torch.device("cuda", j % count) for j in range(n)]


def send_lanes_tiers(N: int, n: int, betas: Sequence[float]):
    """The per-destination send budgets of ascending ``betas``: ``beta * N
    / n^2`` rounded up to 128 lanes, duplicates dropped (JAX
    sharding.py:155-167)."""
    lanes = []
    for b in sorted({float(b) for b in betas}):
        bs = -(-int(b * N / (n * n)) // 128) * 128
        if bs not in lanes:
            lanes.append(bs)
    return tuple(lanes)


class ShardedFusion:
    """Slab-sharded fusion over ``devices`` (one shard each, repeats
    allowed).  ``config`` is the GLOBAL config (not validated: it may
    exceed the single-grid caps); its capacities are per-shard budgets.
    The grid is a list of per-shard ``GridState``s; every method updates
    it in place and returns it.  Frames are tensors on ``devices[0]``
    (``put``).  It has the single-grid ``FusionPipeline``'s interface, so
    the session drives it as its pipeline."""

    def __init__(self, config: FusionConfig, devices: Sequence,
                 route: bool = False,
                 route_betas: Optional[Sequence[float]] = None):
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.n = n = len(self.devices)
        self.route = route
        self.global_config = config
        xdim = config.global_x_cells
        self.slab_w = W = -(-xdim // n)
        self.halo = halo = config.k_neighborhood + config.line_k + 1
        cfg = dataclasses.replace(config,
                                  shard_x_cells=W + 2 * halo).validate()
        if route:
            routing.check_slabs(W, halo)
            N = config.max_points
            if N % n:
                raise ValueError(f"max_points {N} must divide the mesh "
                                 f"({n})")
            self.send_lanes_tiers = send_lanes_tiers(
                N, n, route_betas or (2.0, float(n)))
            self.send_lanes = self.send_lanes_tiers[-1]
            R = n * self.send_lanes
            cfg = dataclasses.replace(
                cfg, max_points=R,
                max_active_points=min(R, config.max_active_points),
            ).validate()
        self.config = cfg                        # per-shard local config
        self.shards = [FusionPipeline(cfg, dev, (j * W - halo, 0, 0))
                       for j, dev in enumerate(self.devices)]
        # the routed dispatches' chosen budgets: {Bs: dispatches}, and the
        # largest bucket load seen
        self.tier_counts = {}
        self.max_bucket = 0

    def _core_range(self, j: int):
        """Shard ``j``'s core slab in local x."""
        width = min(self.slab_w, self.global_config.global_x_cells
                    - j * self.slab_w)
        return self.halo, self.halo + width

    def _each(self, grid, fn, *frame):
        """``fn(shard, grid_j, *frame)`` on every shard, the frame's tensors
        on the shard's device (replicated ingest)."""
        for j, p in enumerate(self.shards):
            grid[j] = fn(p, grid[j], *(t.to(p.device, non_blocking=True)
                                       for t in frame))
        return grid

    def _each_routed(self, grid, fn, packed, poses, single: bool):
        """Exchange a B12-packed batch and run ``fn(shard, grid_j, world,
        rgb, present, poses, pre_transformed=True, extra_dropped=...)`` on
        every shard, the router's drops booked on shard 0 only (JAX
        sharding.py:337-340); ``single`` drops the batch axis."""
        world, rgb, present, Bs, dropped, mx = packed
        self.tier_counts[Bs] = self.tier_counts.get(Bs, 0) + 1
        self.max_bucket = max(self.max_bucket, mx)
        recv = routing.exchange_batch(world, rgb, present, self.devices)
        for j, (p, lanes) in enumerate(zip(self.shards, recv)):
            lanes = (*lanes, poses.to(p.device, non_blocking=True))
            if single:
                lanes = tuple(t[0] for t in lanes)
            grid[j] = fn(p, grid[j], *lanes, pre_transformed=True,
                         extra_dropped=dropped if j == 0 else 0)
        return grid

    def _pack(self, pts, rgb, mask, poses):
        return routing.route_pack(pts, rgb, mask, poses, self.global_config,
                                  self.n, self.slab_w, self.halo,
                                  self.send_lanes_tiers)

    def _pack_depth(self, dq, r565, counts, poses, rays):
        return routing.route_pack_depth(dq, r565, counts, poses, rays,
                                        self.global_config, self.n,
                                        self.slab_w, self.halo,
                                        self.send_lanes_tiers)

    # -- public API -------------------------------------------------------
    def init(self) -> List[GridState]:
        return [p.init() for p in self.shards]

    def put(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the first shard's device."""
        return self.shards[0].put(array)

    def put_rays(self, rays) -> torch.Tensor:
        """The (3,N) ray table on the first shard's device (each shard
        reads it there or takes a copy)."""
        return self.put(np.asarray(rays, np.float32))

    def step(self, grid, pts, rgb, mask, pose):
        """One planar frame, then a refine when a mark falls on it."""
        if self.route:
            mask = mask.reshape(1) if mask.dim() == 0 else mask[None]
            return self._each_routed(
                grid, FusionPipeline.step,
                self._pack(pts[None], rgb[None], mask, pose[None]),
                pose[None], True)
        return self._each(grid, FusionPipeline.step, pts, rgb, mask, pose)

    def step_depth(self, grid, dq, r565, count, pose, rays):
        """One depth frame, then a refine when a mark falls on it."""
        if self.route:
            return self._each_routed(
                grid, FusionPipeline.step,
                self._pack_depth(dq[None], r565[None], count.reshape(1),
                                 pose[None], rays), pose[None], True)
        return self._each(grid, FusionPipeline.step_depth, dq, r565, count,
                          pose, rays)

    def step_batch(self, grid, pts, rgb, mask, poses):
        """K planar frames; no refine (the caller fires ``refine`` at the
        cadence marks, as the single-grid session does)."""
        if self.route:
            return self._each_routed(grid, FusionPipeline.step_batch,
                                     self._pack(pts, rgb, mask, poses),
                                     poses, False)
        return self._each(grid, FusionPipeline.step_batch, pts, rgb, mask,
                          poses)

    def step_batch_depth(self, grid, dq, r565, counts, poses, rays):
        """K depth frames; no refine."""
        if self.route:
            return self._each_routed(
                grid, FusionPipeline.step_batch,
                self._pack_depth(dq, r565, counts, poses, rays), poses,
                False)
        return self._each(grid, FusionPipeline.step_batch_depth, dq, r565,
                          counts, poses, rays)

    def integrate(self, grid, pts, rgb, mask, pose):
        """One planar frame without the refine."""
        def fn(p, g, *frame, **kw):
            return integrate(g, *frame, p.config, offset=p.offset, **kw)
        if self.route:
            mask = mask.reshape(1) if mask.dim() == 0 else mask[None]
            return self._each_routed(
                grid, fn, self._pack(pts[None], rgb[None], mask, pose[None]),
                pose[None], True)
        return self._each(grid, fn, pts, rgb, mask, pose)

    def refine(self, grid):
        for j, p in enumerate(self.shards):
            grid[j] = p.refine(grid[j])
        return grid

    def run_sweep(self, grid, pts, rgb, mask, poses):
        """``step`` over the (F,...) frames in order."""
        for f in range(poses.shape[0]):
            grid = self.step(grid, pts[f], rgb[f], mask[f], poses[f])
        return grid

    def extract(self, grid) -> "ShardedExtract":
        results = [p.extract(g, x_range=self._core_range(j))
                   for j, (p, g) in enumerate(zip(self.shards, grid))]
        return ShardedExtract(results, self.config, self.slab_w, self.halo)

    def extract_host(self, grid, fields=None) -> dict:
        return self.extract(grid).to_host(fields=fields)

    def extract_fetcher(self, grid):
        """One extraction, fetched by field on demand and cached (JAX
        sharding.py:689-727; the shards' extracts are already on the
        host side of their one sync each)."""
        result = self.extract(grid)
        return cached_fetch(lambda need: result.to_host(fields=need),
                            EXTRACT_FIELDS)

    def put_state(self, fields: dict):
        """Host arrays in the sharded JAX layout -> per-shard grids."""
        return convert.sharded_grid_from_jax(fields, self.config,
                                             self.devices)

    def host_state(self, grid) -> dict:
        """The per-shard grids as host arrays in the sharded JAX layout."""
        return convert.sharded_grid_to_jax(grid, self.config)

    def grid_metrics(self, grid) -> dict:
        return self.metrics(grid)

    def metrics(self, grid) -> dict:
        """The JAX package's sharded counters (sharding.py:532-587): counts
        summed over the shards on the host, exactly."""
        C = self.config.capacity
        rows = torch.stack([torch.stack([t.to(torch.int64) for t in (
            (g.n_pts > 0).sum(), (g.key != -1).sum(), g.normal_found.sum(),
            g.overflow_probe, g.overflow_buf, g.overflow_dep,
            g.overflow_refine, g.overflow_unique, g.overflow_hits,
            g.overflow_replay, g.overflow_active, g.frames)]).cpu()
            for g in grid]).numpy()
        used = rows[:, 1]
        out = {"devices": self.n,
               "occupied_voxels_incl_halo": int(rows[:, 0].sum()),
               "slots_used": int(used.sum()),
               "hash_load_factor_max": float(np.float32(used.max() / C)),
               "normals_found_incl_halo": int(rows[:, 2].sum())}
        for i, k in enumerate(("overflow_probe", "overflow_buffer",
                               "overflow_dependants", "overflow_refine",
                               "overflow_unique", "overflow_hits",
                               "overflow_replay", "overflow_active")):
            out[k] = int(rows[:, 3 + i].sum())
        out["frames"] = int(rows[0, 11])
        return out


class ShardedExtract:
    """The shards' extracts and their host assembly."""

    def __init__(self, results: List[ExtractResult], config: FusionConfig,
                 slab_w: int, halo: int):
        self.results = results
        self.config = config
        self.slab_w = slab_w
        self.halo = halo

    @property
    def n_valid(self) -> int:
        return sum(r.n_valid for r in self.results)

    def to_host(self, fields=None) -> dict:
        """The shards' core emissions concatenated in ascending x, local
        cell ids mapped to GLOBAL int64 ids by each shard's x offset
        (JAX sharding.py:607-632).  ``fields`` restricts the fetch."""
        keys = tuple(fields) if fields is not None else EXTRACT_FIELDS
        _, dy, dz = self.config.dims
        yz = np.int64(dy) * np.int64(dz)
        parts = {k: [] for k in keys}
        for s, r in enumerate(self.results):
            host = to_host(r, keys)
            for k in keys:
                if k == "cell":
                    local = host["cell"].astype(np.int64)
                    off_x = np.int64(s * self.slab_w - self.halo)
                    parts[k].append((local // yz + off_x) * yz + local % yz)
                else:
                    parts[k].append(host[k])
        return {k: np.concatenate(v) for k, v in parts.items()}


# the JAX package's session-facing name: ``ShardedFusion`` already has the
# single-grid pipeline's interface (JAX sharding.py:635-733)
ShardedPipeline = ShardedFusion
