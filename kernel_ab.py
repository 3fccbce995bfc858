#!/usr/bin/env python3
"""Times kernels K1, K2 (at its three call shapes), K4, T1, K3, T3 (at two
shapes), K5, T2p, B11 (at two shapes), B12 (on two wires, alone and with
the exchange), B3, B6 and B7, the TSDF batch's reduce stage (T4 where a
checkout has it), K1 and K5 with a shard's offset, and the replays with
the fusion and TSDF replays' device idle shares, of one or more
checkouts of the PyTorch port on one CUDA card, in the order A, B, ...,
..., B, A.

    python3 kernel_ab.py [--only SECTION,...] A_DIR [B_DIR ...]

``--only`` runs the sections named and reports None for the rest:
``fusion`` (K1, K2 at its fusion shapes, K3, K4), ``lanes`` (B3, B6,
B7), ``tsdf`` (T1, K2's TSDF shape, the reduce stage and its parts, a
dispatch's peak memory, T3), ``planar`` (K5 on its f32 and record
wires, T2p), ``routed`` (the offsets, B12), ``queries`` (B11) and
``replays``.

Each run is a process of its own that imports ``hifi_fusion_tpu_torch``
from its checkout (building that checkout's kernels there) and prints one
JSON line.  The inputs are built through that checkout's own paths, with
``chip_smoke.py``'s functions from this script's checkout, apart from
the ``lanes`` section's checks, which come from the checkout's own
``chip_smoke.py`` where it has them, since they follow its API:

* ``hash_insert/integrate``, ``hash_insert/refine``, ``hash_insert/tsdf``:
  K2 on the key table and ids of the calls that the fusion integrate of
  the seeded sweep's third K=8 batch, the refine after it, and the TSDF
  config-5 integrate of that batch make (``chip_smoke.fusion_state`` and
  ``tsdf_state``), in the form the checkout's callers use: the failures
  added into their counter (one launch), or for a wrapper without that
  argument the returned count added by the caller, and the caller's
  device-side live count where it passes one;
* ``normal_fit``: K4 on the refine's candidates after that batch;
* ``segscan``: T1 (kind add) on the batch's sorted sample lanes at TSDF
  config 5 (6 x 27,033,600 lanes);
* ``tsdf_reduce/sort``, ``tsdf_reduce/gather``: the batch's stable sort
  of its 27,033,600 cell ids alone, and the gather of its six channels in
  sorted order (``vals6[:, order]``) alone; ``tsdf_reduce/gather_rows``
  the same gather from a lane-major copy of the channels (a lane's six
  words in one 24-byte row), the layout T2 does not write;
* ``tsdf_reduce/stage``: the TSDF batch's reduce stage on those lanes
  into the grid after two batches, through the checkout's own API: for a
  checkout whose T4 takes the sort's order (``tsdf.sort_lanes``), the
  sort and T4 with K2; for one whose T4 takes T1's sums
  (``tsdf.sorted_sums``), the sort, the gather, T1 and T4 with K2; else
  the sort, the gather, T1, the two ``nonzero`` reads, K2 and
  ``index_add_``; its events span any wait of the host on a read;
* ``tsdf_sort``: for a checkout with ``tsdf.sort_lanes``, that sort
  alone on the batch's ids (kernel T5 where the checkout has it);
* ``tsdf_reduce/after_sort``: the stage from the sorted ids and order on,
  for a checkout with T4 (the first: T4; the second: the starts, the
  gather, T1 and T4);
* ``tsdf_reduce``: for a checkout with T4, its call alone (with K2) on
  the inputs its contract takes, and its device ms by kernel of one
  profiled call (``tsdf_reduce/passes``);
* ``tsdf_dispatch_peak_gb``: the peak device memory of one K=8 TSDF depth
  dispatch (``step_batch_depth`` of the third batch into the grid after
  two), above what was allocated when it began
  (``torch.cuda.max_memory_allocated``);
* ``dep_stream``: K3 on the batch's points at the fusion bench config;
* ``tsdf_surface/batch2``, ``tsdf_surface/replay``: T3 on the surface of
  the config-5 grid after two batches and after every batch of the sweep
  (the grid ``process()`` extracts at the end of the replay);
* ``depth_frontend``: K1 on the first batch;
* ``planar_frontend``: K5 on the host decode's planar wire of the first
  batch (``chip_smoke.planar_wires``), for a checkout that has it;
* ``planar_frontend/records``: K5's record wire on the first batch's
  PointCloud2 records (``chip_smoke.record_batch``: a (8, 307200 * 16)
  u8 batch and the frame table), as a fusion session uploads them, for a
  checkout that has ``integrate.record_frontend``;
* ``depth_frontend/offset``, ``planar_frontend/offset``: K1 and K5 on the
  same inputs for shard 1 of the bench config split into 4 slabs (its
  local window and coordinate offset), for a checkout with the offset;
* ``route_pack/depth``, ``route_pack/planar``: B12 at ``chip_smoke.py``
  phase 14's shape (4 shards, the default tiers) on the third batch's
  depth wire and on its session planar wire, for a checkout that has
  ``parallel/routing``;
* ``route_exchange/depth``, ``route_exchange/planar``: the same B12 call
  followed by ``routing.exchange_batch`` to the 4 shards' devices (all
  the one card), the unit a routed dispatch runs before its shards'
  integrates, each checkout through its own pair of calls: the views of
  B12's destination-major output, or for a checkout whose B12 returns
  the (K, n, 7, n * Bs) send buffer, its stack-and-slice copies;
* ``tsdf_lanes_planar``: T2p at TSDF config 5 on the planar wire of the
  third batch's records (``chip_smoke.record_wire``), for a checkout that
  has it;
* ``neighbor_count/ror``, ``neighbor_count/occupied``: B11 at r=2 on the
  fusion replay's final grid (``chip_smoke.fusion_final_grid``) over all
  2^22 slots (-1 where unoccupied, the ROR call) and over the occupied
  slots alone, for a checkout that has ``ops/queries``;
* ``integrate_lanes``, ``refine_lines``, ``buffer_replay``: B3 on the
  third batch into the carried grid, B6 and B7 on the first refine
  (``chip_smoke.check_integrate_lanes`` and ``check_refine_kernels``,
  each held to its plain version there), for a checkout that has them,
  with B6's library sort timed alone (``refine_lines/sort``) and the rest
  of its call, the hand passes with K2 (``refine_lines/hand``), and B6's
  and B7's device ms by kernel of one profiled call
  (``refine_lines/passes``, ``buffer_replay/passes``);
* ``fusion_mpts``, ``tsdf_mpts``, ``planar_mpts``, ``sharded_mpts``: the
  96-frame replays of phases 4, 6, 7 and 14's routed one (4 shards on the
  card; push to drain; ``process()`` follows, untimed; the planar one for
  a checkout with ``push_frame``, the sharded one for a checkout with
  ``parallel/routing``), with the session's ``device_step`` and
  ``refine`` ms a dispatch (``*_dispatch_ms``) of the fusion, planar and
  sharded ones;
* ``fusion_profile``: the fusion replay again under ``torch.profiler``
  (``chip_smoke.profiled_replay``): the seconds the card was busy over
  the window, the busy share, and ``device_step`` / ``refine`` a
  dispatch;
* ``tsdf_profile``: the TSDF replay under ``torch.profiler`` the same
  way (``chip_smoke.profiled_replay`` with the TSDF session).

Kernel times are device times (``chip_smoke.device_ms``): the median of 10
calls, CUDA events around each call, with a sleep kernel ahead of the
start event so that the card is busy while the host enqueues the call; K2
and K4 find the L2 cold (``chip_smoke.cold``), as on the main path.  The
last line is a JSON object with every run's results and the card's
``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import inspect
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPS = 10
SECTIONS = ("fusion", "lanes", "tsdf", "planar", "routed", "queries",
            "replays")
TIMED = ("depth_frontend", "hash_insert/integrate", "hash_insert/refine",
         "hash_insert/tsdf", "normal_fit", "segscan", "dep_stream",
         "tsdf_surface/batch2", "tsdf_surface/replay", "planar_frontend",
         "planar_frontend/records",
         "tsdf_lanes_planar", "neighbor_count/ror",
         "neighbor_count/occupied", "depth_frontend/offset",
         "planar_frontend/offset", "route_pack/depth", "route_pack/planar",
         "route_exchange/depth", "route_exchange/planar",
         "integrate_lanes", "refine_lines", "refine_lines/sort",
         "refine_lines/hand", "buffer_replay", "tsdf_reduce",
         "tsdf_reduce/stage", "tsdf_reduce/sort", "tsdf_reduce/gather",
         "tsdf_reduce/gather_rows", "tsdf_reduce/after_sort", "tsdf_sort")


def smoke(path=HERE / "chip_smoke.py"):
    """The chip_smoke.py at ``path`` (this checkout's) as a module."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def callers_insert(hashing):
    """K2 as the checkout's callers make it: the wrapper itself where it
    takes their overflow counter, else the returning form and the
    caller's ``+=``."""
    if "overflow" in inspect.signature(
            hashing.lookup_or_insert).parameters:
        return hashing.lookup_or_insert

    def insert(key_table, ids, max_probes, capacity, overflow):
        slot, n_failed = hashing.lookup_or_insert(key_table, ids,
                                                  max_probes, capacity)
        overflow += n_failed
        return slot
    return insert


def route_exchange(routing, pack, devices):
    """B12's call ``pack()`` and the exchange of its result to
    ``devices``, through the checkout's own API."""
    if hasattr(routing, "Routed"):
        def fn():
            r = pack()
            return routing.exchange_batch(r.world, r.rgb, r.present,
                                          devices)
    else:
        def fn():
            send, Bs = pack()[:2]
            return routing.exchange_batch(send, devices, Bs)
    return fn


def child(root: str, sections=SECTIONS) -> dict:
    """One run: the checkout at ``root``'s kernels and replays, of the
    ``sections`` named."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    cs = smoke()
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.config import FusionConfig
    from hifi_fusion_tpu_torch.models import tsdf
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    from hifi_fusion_tpu_torch.ops import hashing, integrate, refine, scatter
    from hifi_fusion_tpu_torch.runtime import session
    from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                       make_depth_sweep)
    if not Path(kernels.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise RuntimeError(f"imported {kernels.__file__}, not {root}'s")
    kernels.library()
    dev = torch.device("cuda")
    cfg = cs.bench_config(FusionConfig)
    rays_np = camera_rays(cs.WIDTH, cs.HEIGHT, fx=cs.FX, fy=cs.FX)
    frames = make_depth_sweep(cfg, cs.FRAMES, width=cs.WIDTH,
                              height=cs.HEIGHT, seed=0, noise_sd=3e-4,
                              camera_height=0.4, srays=rays_np,
                              arc_frames=cs.ARC_FRAMES)
    rays = torch.from_numpy(rays_np).cuda()

    def batcher(pipe, K=8):
        def batch(i):
            fs = frames[K * i:K * i + K]
            return (pipe.put(np.stack([f.depth_q for f in fs])),
                    pipe.put(np.stack([f.rgb565 for f in fs])),
                    pipe.put(np.full((K,), fs[0].count, np.int32)),
                    pipe.put(np.stack([f.pose for f in fs])))
        return batch

    insert = callers_insert(hashing)

    def time_insert(table, ids, n_live, max_probes):
        live = () if n_live is None else (n_live,)

        def setup():
            return cs.cold(torch, table.clone(), ids, max_probes,
                           table.numel(), torch.zeros(
                               (), dtype=torch.int32, device=dev), *live)
        return cs.device_ms(torch, insert, setup, reps=REPS)

    res = {"root": root, "tsdf_dispatch_peak_gb": None,
           **{k: None for k in TIMED}}
    # K2 (integrate, refine), K3, K4
    pipe = FusionPipeline(cfg, dev)
    batch = batcher(pipe)
    b0 = batch(0)
    if "fusion" in sections:
        res["depth_frontend"] = cs.device_ms(
            torch, lambda: integrate.depth_frontend(*b0, rays, cfg), tuple,
            reps=REPS)
        grid, calls = cs.fusion_state(torch, hashing, pipe, batch, rays)
        for shape, (table, ids, n_live) in calls.items():
            res[f"hash_insert/{shape}"] = time_insert(table, ids, n_live,
                                                      cfg.max_probes)
        del calls
        world, ids, _ = integrate.depth_frontend(*batch(2), rays, cfg)
        sid, order = torch.sort(ids, stable=True)
        n_act = int((sid != integrate.INVALID_ID).sum())
        uids, run = torch.unique_consecutive(sid[:n_act],
                                             return_inverse=True)
        pts = world[:, order[:n_act]].contiguous()
        slot_pt = hashing.lookup(grid.key, uids, cfg.max_probes,
                                 cfg.capacity)[run].contiguous()
        res["dep_stream"] = cs.device_ms(
            torch, integrate.dep_stream, lambda: (
                pts, slot_pt, dataclasses.replace(
                    grid, cyl_stats=grid.cyl_stats.clone()), cfg),
            reps=REPS)
        cand = torch.nonzero((grid.n_pts > 0) & ~grid.normal_found
                             ).squeeze(1).to(torch.int32)
        res["normal_fit"] = cs.device_ms(
            torch, refine.normal_fit, lambda: cs.cold(
                torch, cand, dataclasses.replace(
                    grid, normal=grid.normal.clone(),
                    normal_found=grid.normal_found.clone()), cfg),
            reps=REPS)
        del grid, world, ids, sid, order, pts
    # B3, B6, B7 (phase 3's checks and inputs), for a checkout with them
    if "lanes" in sections and hasattr(integrate, "aggregate_lanes"):
        own = Path(root) / "chip_smoke.py"
        own = smoke(own) if own.exists() else cs
        if not hasattr(own, "check_refine_kernels"):
            own = cs
        res["integrate_lanes"] = own.check_integrate_lanes(
            torch, cfg, pipe, batch, rays)["ms"]
        for name, r in own.check_refine_kernels(
                torch, cfg, pipe, batch, rays).items():
            res[name] = r["ms"]
            res[f"{name}/passes"] = r.get("passes_ms")
            if name == "refine_lines":
                res["refine_lines/sort"] = r["sort_ms"]
                res["refine_lines/hand"] = r["hand_ms"]
    del pipe
    torch.cuda.empty_cache()
    # T1, K2 (tsdf)
    tcfg = cs.tsdf_config(FusionConfig, tsdf.TsdfConfig)
    if "tsdf" in sections:
        tp = tsdf.TsdfPipeline(tcfg, dev)
        batch = batcher(tp)
        skey, vals = tsdf.tsdf_lanes(*batch(2), rays, tcfg)
        sid, order = torch.sort(skey, stable=True)
        svals = vals[:, order].contiguous()
        starts = scatter.segment_starts(sid, sid != tsdf.BIG)
        del skey, vals, order
        res["segscan"] = cs.device_ms(torch, scatter.segment_reduce,
                                      lambda: (svals, starts, "add"),
                                      reps=REPS)
        del svals, starts, sid
        grid, (table, ids, n_live) = cs.tsdf_state(hashing, tp, batch, rays)
        res["hash_insert/tsdf"] = time_insert(table, ids, n_live,
                                              tcfg.base.max_probes)
        del table, ids
        skey, vals = tsdf.tsdf_lanes(*batch(2), rays, tcfg)
        U = min(tcfg.batch_unique, skey.numel(), tsdf.tail(tcfg))
        sid, order = torch.sort(skey, stable=True)
        res["tsdf_reduce/sort"] = cs.device_ms(
            torch, lambda: torch.sort(skey, stable=True), tuple, reps=REPS)
        res["tsdf_reduce/gather"] = cs.device_ms(
            torch, lambda: vals[:, order], tuple, reps=REPS)
        rows = vals.t().contiguous()
        res["tsdf_reduce/gather_rows"] = cs.device_ms(
            torch, lambda: rows[order], tuple, reps=REPS)
        del rows
        if hasattr(tsdf, "sort_lanes"):
            # T4 gathers through the sort's order and runs the ladder; a
            # checkout with T5 sorts by the grid's cell range, into an
            # i32 order, with tables kept between sorts where it has them
            n_params = len(inspect.signature(tsdf.sort_lanes).parameters)
            if n_params == 3:
                tables = tsdf.SortTables(tcfg.base.n_cells, skey.device)

                def sort(k):
                    return tsdf.sort_lanes(k, tcfg.base.n_cells, tables)
            elif n_params == 2:
                def sort(k):
                    return tsdf.sort_lanes(k, tcfg.base.n_cells)
            else:
                sort = tsdf.sort_lanes
            sid, order = sort(skey)
            res["tsdf_sort"] = cs.device_ms(torch, lambda: sort(skey),
                                            tuple, reps=REPS)

            def stage(g):
                tsdf.tsdf_reduce(g, *sort(skey), vals, U, tcfg)

            def after(g):
                tsdf.tsdf_reduce(g, sid, order, vals, U, tcfg)
            t4_args = (sid, order, vals)
        elif hasattr(tsdf, "sorted_sums"):
            # T4 on the gathered lanes and T1's sums
            def stage(g):
                tsdf.tsdf_reduce(g, *tsdf.sorted_sums(skey, vals), U, tcfg)

            def after(g):
                starts = scatter.segment_starts(sid, sid != tsdf.BIG)
                tsdf.tsdf_reduce(g, sid, scatter.segment_sums(
                    vals[:, order], starts), U, tcfg)
            t4_args = (sid, scatter.segment_sums(
                vals[:, order], scatter.segment_starts(
                    sid, sid != tsdf.BIG)).contiguous())
        else:
            def stage(g):
                tsdf.tsdf_reduce(g, skey, vals, U, tcfg)
            after, t4_args = None, None
        res["tsdf_reduce/stage"] = cs.device_ms(
            torch, stage, lambda: (cs.copy_grid(grid),), reps=REPS)
        if after is not None:
            res["tsdf_reduce/after_sort"] = cs.device_ms(
                torch, after, lambda: (cs.copy_grid(grid),), reps=REPS)

            def t4():
                return (cs.copy_grid(grid), *t4_args, U, tcfg)
            res["tsdf_reduce"] = cs.device_ms(
                torch, tsdf.tsdf_reduce, lambda: cs.cold(torch, *t4()),
                reps=REPS)
            res["tsdf_reduce/passes"] = cs.kernel_split(
                torch, tsdf.tsdf_reduce, t4)
            del t4_args
        # the peak device memory of one K=8 TSDF depth dispatch above what
        # was allocated when it began
        g = cs.copy_grid(grid)
        b = batch(2)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tp.step_batch_depth(g, *b, rays)
        torch.cuda.synchronize()
        res["tsdf_dispatch_peak_gb"] = (torch.cuda.max_memory_allocated()
                                        - base) / 1e9
        del g, b, sid, order
        del skey, vals
        final = tp.init()
        for i in range(cs.FRAMES // 8):
            tp.step_batch_depth(final, *batch(i), rays)
        for shape, g in (("batch2", grid), ("replay", final)):
            cell, slots = tsdf.surface_cells(g, tcfg)
            res[f"tsdf_surface/{shape}"] = cs.device_ms(
                torch, tsdf.tsdf_surface, lambda: (cell, slots, g, tcfg),
                reps=REPS)
        del tp, grid, final, cell, slots
    torch.cuda.empty_cache()
    if "planar" in sections and hasattr(integrate, "planar_frontend"):
        p, c, m, t, q, _ = cs.planar_wires(torch, frames,
                                            dev)["f32-f32-count"]
        res["planar_frontend"] = cs.device_ms(
            torch, lambda: integrate.planar_frontend(p, c, m, t, cfg, q),
            tuple, reps=REPS)
        del p, c, m, t
    if "planar" in sections and hasattr(integrate, "record_frontend"):
        wire = cs.record_batch(torch, cs.cloud_frames(frames[:8]),
                               cfg.max_points, dev)
        res["planar_frontend/records"] = cs.device_ms(
            torch, lambda: integrate.record_frontend(*wire, cfg), tuple,
            reps=REPS)
        del wire
    if "planar" in sections and hasattr(tsdf, "tsdf_lanes_planar"):
        wire = cs.record_wire(torch, cs.cloud_frames(frames[16:24]),
                              tcfg.base.max_points, dev)
        res["tsdf_lanes_planar"] = cs.device_ms(
            torch, lambda: tsdf.tsdf_lanes_planar(*wire, tcfg), tuple,
            reps=REPS)
        del wire
    routed = importlib.util.find_spec("hifi_fusion_tpu_torch.parallel")
    if "routed" in sections and routed:
        from hifi_fusion_tpu_torch.parallel import routing
        from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
        shard = ShardedFusion(cfg, [dev] * 4).shards[1]
        res["depth_frontend/offset"] = cs.device_ms(
            torch, lambda: integrate.depth_frontend(
                *b0, rays, shard.config, shard.offset), tuple, reps=REPS)
        p, c, m, t, _, _ = cs.planar_wires(torch, frames,
                                            dev)["f32-f32-count"]
        res["planar_frontend/offset"] = cs.device_ms(
            torch, lambda: integrate.planar_frontend(
                p, c, m, t, shard.config, offset=shard.offset), tuple,
            reps=REPS)
        sf = ShardedFusion(cfg, [dev] * 4, route=True)
        args = (cfg, 4, sf.slab_w, sf.halo, sf.send_lanes_tiers)
        b2 = batch(2)
        p, c, m, t, _, _ = cs.planar_wires(torch, frames[16:24],
                                            dev)["f32-f32-count"]
        for wire, pack in (
                ("depth", lambda: routing.route_pack_depth(*b2, rays,
                                                           *args)),
                ("planar", lambda: routing.route_pack(p, c, m, t, *args))):
            res[f"route_pack/{wire}"] = cs.device_ms(torch, pack, tuple,
                                                     reps=REPS)
            res[f"route_exchange/{wire}"] = cs.device_ms(
                torch, route_exchange(routing, pack, sf.devices), tuple,
                reps=REPS)
        del p, c, m, t, b2
    torch.cuda.empty_cache()
    if "queries" in sections and importlib.util.find_spec(
            "hifi_fusion_tpu_torch.ops.queries"):
        from hifi_fusion_tpu_torch.ops import queries
        grid = cs.fusion_final_grid(cfg, frames, rays, dev)
        occ = grid.n_pts > 0
        live = torch.nonzero(occ).squeeze(1).to(torch.int32)
        every = torch.full((cfg.capacity,), -1, dtype=torch.int32,
                           device=dev)
        every[live.long()] = live
        for shape, s in (("ror", every), ("occupied", live)):
            res[f"neighbor_count/{shape}"] = cs.device_ms(
                torch, queries.occupied_neighbor_counts,
                lambda: (grid, s, cfg, 2), reps=REPS)
        del grid, occ, live, every
    torch.cuda.empty_cache()
    # the replays, with the session's device_step and refine ms a dispatch
    def per_dispatch(m):
        t = m["stage_timers"]
        return {k: 1e3 * t[k]["total_s"] / t[k]["count"]
                for k in ("device_step", "refine") if t.get(k, {}).get(
                    "count")}

    res["fusion_profile"] = res["tsdf_profile"] = None
    for name in ("fusion", "tsdf", "planar", "sharded"):
        res[f"{name}_mpts"] = None
    if "replays" in sections:
        with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
            _, dt, _, m = cs.replay(torch, cfg, frames, rays_np, "cuda",
                                    tmp + "/f")
            res["fusion_mpts"] = cs.FRAMES * cs.WIDTH * cs.HEIGHT / dt / 1e6
            res["fusion_dispatch_ms"] = per_dispatch(m)
            res["fusion_profile"] = cs.profiled_replay(torch, cfg, frames,
                                                       rays_np)
            dt = cs.replay(torch, tcfg.base, frames, rays_np, "cuda",
                           tmp + "/t", model="tsdf",
                           model_params=cs.TSDF_PARAMS)[1]
            res["tsdf_mpts"] = cs.FRAMES * cs.WIDTH * cs.HEIGHT / dt / 1e6
            res["tsdf_profile"] = cs.profiled_replay(
                torch, tcfg.base, frames, rays_np, model="tsdf",
                model_params=cs.TSDF_PARAMS)
            if hasattr(session.FusionSession, "push_frame"):
                _, dt, _, m = cs.replay(torch, cfg, frames, None, "cuda",
                                        tmp + "/p",
                                        clouds=cs.cloud_frames(frames))
                res["planar_mpts"] = (cs.FRAMES * cs.WIDTH * cs.HEIGHT
                                      / dt / 1e6)
                res["planar_dispatch_ms"] = per_dispatch(m)
            if routed:
                _, dt, _, m = cs.replay(torch, cfg, frames, rays_np, "cuda",
                                        tmp + "/s", n_devices=4,
                                        route=True)
                res["sharded_mpts"] = (cs.FRAMES * cs.WIDTH * cs.HEIGHT
                                       / dt / 1e6)
                res["sharded_dispatch_ms"] = per_dispatch(m)
    return res


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--child":
        print(json.dumps(child(argv[2], argv[3].split(","))), flush=True)
        return 0
    sections = SECTIONS
    if len(argv) > 2 and argv[1] == "--only":
        sections = tuple(argv[2].split(","))
        if not set(sections) <= set(SECTIONS):
            print(f"kernel_ab: sections are {SECTIONS}", file=sys.stderr)
            return 2
        argv = argv[:1] + argv[3:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing run", file=sys.stderr)
        return 1
    roots = argv[1:]
    labels = [chr(ord("A") + i) for i in range(len(roots))]
    order = list(zip(labels, roots))
    runs = []
    for label, root in order + order[::-1]:
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child", root, ",".join(sections)],
                             capture_output=True, text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise RuntimeError(f"run {label} ({root}) failed")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        times = ", ".join(f"{k} {r[k]}" if r[k] is None
                          else f"{k} {r[k]:.4f}" for k in TIMED)
        print(f"{label}: {times} ms; fusion {r['fusion_mpts']}, tsdf "
              f"{r['tsdf_mpts']}, planar {r['planar_mpts']}, sharded "
              f"{r['sharded_mpts']} Mpts/s ({root}); ms a dispatch: fusion "
              f"{r.get('fusion_dispatch_ms')}, planar "
              f"{r.get('planar_dispatch_ms')}, sharded "
              f"{r.get('sharded_dispatch_ms')}; fusion replay profiled "
              f"{json.dumps(r['fusion_profile'])}; TSDF replay profiled "
              f"{json.dumps(r['tsdf_profile'])}; by kernel: B6 "
              f"{r.get('refine_lines/passes')}, B7 "
              f"{r.get('buffer_replay/passes')}, T4 "
              f"{r.get('tsdf_reduce/passes')}; a K=8 TSDF dispatch's peak "
              f"{r['tsdf_dispatch_peak_gb']} GB above its start", flush=True)
    print(json.dumps({"runs": runs, "card": smoke().nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
