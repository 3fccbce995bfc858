#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hifi_fusion_tpu_torch) on one CUDA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card's name and power limit (nvidia-smi); no CUDA, no run;
2. a fresh build of the CUDA kernels from ``hifi_fusion_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) with the build seconds and ptxas'
   register / spill report, and of the two host libraries (``g++``: the
   native host runtime, ``runtime/native``, and the C++ oracle,
   ``oracle/native``) with their build seconds;
3. each kernel against its plain PyTorch version on the card, at the shapes
   its main path gives it, timed on the card (``device_ms``) in the order
   plain, kernel, kernel, plain: K1-K4 at the fusion bench config, K5 on
   the planar wires of a K=8 batch of that sweep (f32 points with f32
   colour and count prefixes, as the host decode packs them; f32 points
   with packed colour and a lane mask; the q16 wire) and on its record
   wire (the batch's PointCloud2 records as a fusion session uploads
   them, bit-exact also against the f32 wire of the host decode), T1-T3
   at the TSDF config
   5, T3 at two shapes (the grid after two batches and the final grid of
   the 96-frame replay), and K2 at each of its three call shapes (the
   fusion integrate, the refine's line cells and the TSDF batch, on the
   key table and ids those calls get, captured from the port's own
   paths), K2 and K4 behind a read that leaves the L2 cold, as the main
   path does; T2p on the planar wire of a config-5 K=8 batch decoded from
   phase 7's records (bit-equal keys and values, the same valid lanes as
   T2's depth batch); B11 at r=2 over all 2^22 slots of the fusion
   replay's final grid (built here through the pipeline at phase 4's
   cadence), counts exact against its plain version (the JAX package's
   lookup form), timed there and over the occupied slots alone; beside
   each time the kernel's bound (the least time the
   card could take for the same inputs,
   ``hifi_fusion_tpu_torch/bounds.py``) and the share of it reached, for
   K2 each shape's ids, new ids and load factor, for K4 its candidates,
   gated candidates and window words, for T1 the time of one PyTorch
   call that computes its segment totals (``torch.segment_reduce``) and
   for B11 that of one ``avg_pool3d`` summing every window of the dense
   occupancy volume (its counts at the queried cells checked equal),
   yardsticks the port never calls; B12 (owner-slab route and pack)
   bit-exact against its plain pair (world, rgb and present in the
   destinations' layout) on the third K=8 batch at phase 14's shape (4
   shards, depth wire and the session's planar wire) and at phase 15's
   (the launch-file extent, 8 shards, depth wire), the host read of its
   budget inside the time, and its device ms split by pass (count, scan
   and budget with the budget's copy; pack; fill); B3
   (``integrate.aggregate_lanes``, with K2) on the third K=8 batch's
   sorted lanes into the grid carried through two batches and refines,
   against its plain version: every integer field, the integer-valued
   sums and viewpoints by cell id (K2 may pick other slots), the buffer
   in order and K3's sorted lanes exactly, and a repeat on another copy
   of the grid bit-identical by cell id; B6 (``refine.refine_lines``)
   and B7 (``refine.buffer_replay``) on the first refine of phase 4's
   sweep: the dependant lists in order, the counts and the owner-major
   links exactly, then B7's hit counts exactly and sums within
   ``checks.RTOL`` of the terms, whether its ``cyl_stats`` are the plain
   version's bit for bit, and a second launch on another copy
   bit-identical; each with its counts, bound and share and its device
   ms by kernel (B7's share also on ``bounds.buffer_replay_per_link``,
   the yardstick its earlier shares were read against); B6's library
   sort timed alone on the pass's line-cell ids, its share taken on the
   rest of the call (the hand passes with K2); then that refine's
   device ms by stage (candidates with the host read, K4, B6, the
   buffer's sort and gather, B7, reclamation) and whole; T4
   (``tsdf.tsdf_reduce``, with K2) on the TSDF third K=8 batch's sorted
   ids, the sort's order and the sample lanes into the config-5 grid
   after two batches, against its plain version: the key set, ``vstats``
   by cell bit for bit, both overflow counters and the live count K2 is
   handed, with its ids, exactly, and a repeat launch bit-identical by
   cell; the same on five edge cases of seeded lanes (a run of over 1024
   lanes over three ladder blocks, one over ~78 blocks, runs across every
   block edge, M <= 1024 under and over U); its counts, bound, share and
   device ms by kernel;
4. the fusion path: a bench-config ``FusionSession`` replay (640x480 depth
   frames, fx=900, 1 mm pitch, K=8 batches, a refine every 8 frames) of a
   seeded sweep, a ``save_state`` of its grid, then ``process()`` with the
   four export variants; checks overflow counters, voxel count, unit
   normals, the PCD and CSV files, each variant's rows against its
   ``io/downloads`` view, and that K1-K4, B3, B6 and B7 launched; prints
   the session's stage timers; then one K=8 integrate dispatch under
   ``torch.cuda.set_sync_debug_mode("error")`` (no synchronizing call)
   and the refine after it under ``"warn"`` (exactly one: its count
   read), and the replay again under ``torch.profiler`` (CUDA activity):
   the seconds the card was busy over the window and the idle share;
   then ``FusionPipeline.run_sweep`` over the first 16 frames (the
   session's planar wire) against the same frames through ``step``, and
   ``extract_fetcher`` in two waves against ``extract_host`` on the
   replay's final grid;
5. reduced sweeps through the port on the card and through its plain path
   on the CPU: the fusion path compared by cell id with the benchmark's
   structural gates, the TSDF path by cell id (grid sums exact, extract
   within ``checks.TSDF_TOL``);
6. the TSDF path: the config-5 ``FusionSession(model="tsdf")`` replay of
   the same sweep (0.8 mm pitch, S=11 samples, K=8 batches), then
   ``process()``; checks overflow counters, frames, unit normals, the PCD
   and CSV files, the surface count against phase 3's final grid, and
   that T2-T4 and K2 launched; prints the stage timers; then one K=8
   TSDF depth dispatch under ``set_sync_debug_mode("error")`` (no
   synchronizing call) and the replay again under ``torch.profiler``
   (the idle share, as phase 4's);
7. the PointCloud2 ingest path: the sweep of phase 4 turned on the host
   into ``runtime/decode.CloudFrame`` records of its valid pixels (their
   f32 camera points, bit-identical to the card's unprojection, and their
   8-bit colour), replayed through ``FusionSession.push_frame`` at the
   same K and cadence, then ``process()``; checks overflow, truncation
   and pose-failure counters, that the extract holds phase 4's cells with
   the same cylinder and point counts, that every frame took K5's
   record wire (decoded on the card) and that it, K2, K3 and K4
   launched.  It prints the replay's rate and the host's layout check
   and upload a frame (the session's ``decode`` stage and
   ``device_step.upload`` span);
8. the state round trip: a second bench-config session ``warm()``s
   (kernels, host library, every step on a throwaway grid, the extract),
   loads phase 4's checkpoint (``load_state``) and ``process()``es it into
   a PLY, which must hold phase 4's cells with equal counts and
   centroids;
9. the full sweep against the C++ oracle: the 96 frames' camera points
   (the records of phase 7) through ``oracle/native.NativeOracle`` at the
   session's cadence (a refine after each K-batch holding a mark, buffer
   reclamation as the config says), its extract held to phase 4's under
   ``checks.parity_gates`` and a unit-normal agreement gate
   (bench.py:709-775); prints the oracle's seconds and Mpts/s on this
   host, single-threaded, and how many count flips lie within reach of a
   face point (``face_floors``);
10. the TSDF planar replay: the config-5 ``FusionSession(model="tsdf")``
    takes phase 7's 96 records through ``push_frame`` (K=8), then
    ``process()``; checks overflow counters, that the surface holds phase
    6's depth-replay cells and integer weights with tsdf values within
    ``checks.TSDF_TOL`` (the records are the depth wire's unprojection,
    bit for bit), and that T2p, T4, K2 and T3 launched; prints the
    rate, the host decode and the stage timers; then one K=8 planar TSDF
    dispatch (count prefixes of the records) under
    ``set_sync_debug_mode("error")`` (no synchronizing call);
11. the queries (BASELINE config 4) on phase 4's checkpoint:
    ``radius_outlier_mask`` (r=2, min_neighbors=5), ``occupied_neighbor_
    counts`` of the occupied slots (by cell, phase 3's B11 counts) and
    ``query_points`` of one frame's 307,200 world points; prints the
    voxels kept and removed and each call's ms;
12. the command line on the card: ``cli synth --wire depth`` of 16
    640x480 frames with a JSON ``--config`` of the bench config and
    ``fuse`` of it, ``fuse --model tsdf`` of a 16-frame xyzrgb sweep at
    config 5, and ``fuse --export-variants hq,normals`` of a capture
    directory written from 8 of phase 7's records, each held to a direct
    session of the same frames (the PCD's rows and the CSV's counts);
    then ``cmd_serve`` on a thread at 127.0.0.1:0 (``--warm
    --live-batching``, socket timeouts): rays, 16 ``depth_frame``s, 4
    ``frame``s, ``metrics``, ``process`` and ``shutdown``, its extract
    held to a direct session's;
13. the paced live session (BASELINE config 3): a ``warm()``ed
    ``live_batching`` bench-config session takes the 96 frames through
    ``push_depth_frame`` at 30 Hz; checks that no frame was dropped and
    that the extract holds phase 4's cells and counts; prints the lag from
    the last arrival to the end of ``drain()`` and how many dispatches
    were batched;
14. the bench sweep through ``FusionSession(n_devices=4)``, its 4 shards
    on the one card: routed (B12 and the world wire of K5, then K2-K4 a
    shard), then replicated (K1-K4 a shard); each must have zero overflow
    counters, report 4 devices and hold phase 4's extract under
    ``checks.parity_gates``; prints the rate, stage timers, the budget
    tier each routed dispatch chose, the largest bucket, the receive
    lanes and the voxels of each shard's core;
15. the launch-file extent (the bench config over (-0.80, 1.80, -1.5,
    1.5, 0, 1.0) m at 1 mm: 7.8 G cells, which ``validate()`` refuses for
    one grid) on 8 routed shards of the one card: the device memory by
    stage (the grids, then the peak above them while a K=8 batch is
    dispatched, refined and extracted); its own 96-frame sweep through
    the session, ``process()``, zero overflow counters, the grids'
    reckoned bytes beside the session's peak allocated (which must stay
    under the grids and twice the largest stage's peak); the extract equal
    to that of one grid with the same lower corner cut to the surface's
    reach (1800 x 1700 x 500 cells: the same cells, counts and point
    counts), and held to the C++ oracle (int64 cell keys): cell sets,
    total hits and normals as in phase 9, count flips under 2% of the
    voxels and, out of reach of every face point (a point the card's
    reciprocal floor and the oracle's division put in different cells;
    ``oracle_flips.py`` measures the cause), under 25 a frame; then the
    sweep with its face points blanked, through the 8 shards again, under
    ``checks.parity_gates`` whole.

The last lines are a JSON object of per-kernel results (K2's entry holds
its integrate shape's numbers and, under ``shapes``, every shape's), the
nvidia-smi line, and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FRAMES = 96          # replay length (bench.py runs 100)
ARC_FRAMES = 100     # pose spacing of bench.py's 100-frame sweep
WIDTH, HEIGHT, FX = 640, 480, 900.0
REPS = 5             # timed calls per slot of plain, kernel, kernel, plain
SLEEP_CYCLES = 2_000_000   # ~1 ms of card time ahead of each timed call

KERNELS = {
    "depth_frontend": ("hifi_fusion_tpu_torch/csrc/depth_frontend.cu",
                       "hifi_fusion_tpu/ops/pallas_kernels.py:67"),
    "hash_insert": ("hifi_fusion_tpu_torch/csrc/hash_insert.cu",
                    "hifi_fusion_tpu/ops/hashing.py:159"),
    "dep_stream": ("hifi_fusion_tpu_torch/csrc/dep_stream.cu",
                   "hifi_fusion_tpu/ops/integrate.py:590"),
    "normal_fit": ("hifi_fusion_tpu_torch/csrc/normal_fit.cu",
                   "hifi_fusion_tpu/ops/refine.py:171"),
    "segscan": ("hifi_fusion_tpu_torch/csrc/segscan.cu",
                "hifi_fusion_tpu/ops/pallas_segscan.py:74"),
    "tsdf_lanes": ("hifi_fusion_tpu_torch/csrc/tsdf_lanes.cu",
                   "hifi_fusion_tpu/models/tsdf.py:86"),
    "tsdf_surface": ("hifi_fusion_tpu_torch/csrc/tsdf_surface.cu",
                     "hifi_fusion_tpu/models/tsdf.py:228"),
    "planar_frontend": ("hifi_fusion_tpu_torch/csrc/planar_frontend.cu",
                        "hifi_fusion_tpu/ops/pallas_kernels.py:67"),
    "tsdf_lanes_planar": ("hifi_fusion_tpu_torch/csrc/tsdf_lanes.cu",
                          "hifi_fusion_tpu/ops/pallas_kernels.py:67"),
    "record_frontend": ("hifi_fusion_tpu_torch/csrc/planar_frontend.cu",
                        "hifi_fusion_tpu/runtime/decode.py"),
    "neighbor_count": ("hifi_fusion_tpu_torch/csrc/neighbor_count.cu",
                       "hifi_fusion_tpu/ops/queries.py:41"),
    "route_pack": ("hifi_fusion_tpu_torch/csrc/route_pack.cu",
                   "hifi_fusion_tpu/parallel/routing.py:93"),
    "integrate_lanes": ("hifi_fusion_tpu_torch/csrc/integrate_lanes.cu",
                        "hifi_fusion_tpu/ops/integrate.py:339"),
    "refine_lines": ("hifi_fusion_tpu_torch/csrc/refine_lines.cu",
                     "hifi_fusion_tpu/ops/refine.py:262"),
    "buffer_replay": ("hifi_fusion_tpu_torch/csrc/buffer_replay.cu",
                      "hifi_fusion_tpu/ops/refine.py:341"),
    "tsdf_reduce": ("hifi_fusion_tpu_torch/csrc/tsdf_reduce.cu",
                    "hifi_fusion_tpu/models/tsdf.py:135"),
}
# the kernels of the fusion family's integrate and refine, on every path
# that fuses (B3, B6, B7 around K2, K3, K4)
FUSION_STEPS = ("hash_insert", "integrate_lanes", "dep_stream", "normal_fit",
                "refine_lines", "buffer_replay")
# the kernels each main path must launch
FUSION_PATH = ("depth_frontend",) + FUSION_STEPS
# a fusion session's clouds take K5's record wire
PLANAR_PATH = ("record_frontend",) + FUSION_STEPS
# (T4 runs P2's segment ladder itself, so T1 launches in phase 3's own
# check only)
TSDF_PATH = ("tsdf_lanes", "tsdf_reduce", "hash_insert", "tsdf_surface")
TSDF_PLANAR_PATH = ("tsdf_lanes_planar", "tsdf_reduce", "hash_insert",
                    "tsdf_surface")
QUERY_PATH = ("neighbor_count",)
# the routed sharded path: B12 routes, K5 takes the routed world points
ROUTED_PATH = ("route_pack", "planar_frontend") + FUSION_STEPS
CLI_PATH = ("depth_frontend", "record_frontend", "tsdf_lanes_planar",
            "tsdf_reduce", "tsdf_surface") + FUSION_STEPS
# the reference's download* views (OccupancyGrid.hpp:491-601)
VARIANTS = ("hq", "classified", "xyzrgb", "normals")
# an extract fetched in two waves, as an export takes it: the CSV's
# columns, then the PCD's and the rest
CSV_WAVE = ("sd", "mean_dist", "sd_dist", "count")
PCD_WAVE = ("cell", "centroid", "normal", "rgb", "n_pts")
# tools/tsdf_bench.py:39-76: 11 samples across +-4 mm, a 2^21 K=8 budget
TSDF_PARAMS = {"n_samples": 11, "batch_unique": 1 << 21}


def log(msg: str) -> None:
    print(msg, flush=True)


# bench.py:bench_config (bench.py:361-406) with the fields the port reads;
# its TPU lane budgets and tiers are not read by the port
BENCH_FIELDS = dict(
    max_batch_frames=8,
    bbox=(-0.35, 0.35, -0.35, 0.35, 0.0, 0.4),
    resolution=(0.001, 0.001, 0.001),
    capacity_log2=22,
    max_points=WIDTH * HEIGHT,
    buffer_capacity_log2=22,
    max_refine_candidates=1 << 18,
    max_dependants=10,
    refine_every=8,
    z_clip=(0.28, 0.6),
)
# the launch-file extent (the reference's launch bounding_box, config.py's
# default bbox) at the bench config's 1 mm: 2600 x 3000 x 1000 cells, past
# the int32 cell-id cap of one grid
FLAGSHIP_BBOX = (-0.80, 1.80, -1.5, 1.5, 0.0, 1.0)
# the launch-file extent cut to the surface's reach, with the same lower
# corner (so the same cell coordinates, floors and centers): 1800 x 1700 x
# 500 cells, which one grid holds
FLAGSHIP_SUB_BBOX = (-0.80, 1.00, -1.5, 0.2, 0.0, 0.5)
# the TSDF config 5 changes to it (tools/tsdf_bench.py:39-76)
TSDF_FIELDS = dict(resolution=(0.0008, 0.0008, 0.0008), capacity_log2=24,
                   max_unique_per_frame=1 << 19, refine_every=0)


def bench_config(FusionConfig):
    return FusionConfig(**BENCH_FIELDS).validate()


def tsdf_config(FusionConfig, TsdfConfig):
    """TSDF config 5 as tools/tsdf_bench.py:39-76 runs it: the bench
    config at 0.8 mm pitch over the same bbox (875 x 875 x 500 cells), a
    2^24-slot table, 2^19 uniques a frame, no refine, K=8."""
    base = dataclasses.replace(bench_config(FusionConfig),
                               **TSDF_FIELDS).validate()
    return TsdfConfig(base=base, **TSDF_PARAMS)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, setup, reps=REPS) -> float:
    """Median device ms of ``fn(*setup())`` over ``reps`` calls: CUDA events
    around each call, with a sleep kernel ahead of the start event so that
    the card is still busy while the host enqueues the call (the events
    time the card's work, not the host's launch overhead)."""
    times = []
    for _ in range(reps):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_pair(torch, kernel_fn, plain_fn, setup):
    """``device_ms`` of the kernel and of the plain version, REPS calls in
    each slot of the order plain, kernel, kernel, plain; the medians of the
    slots' medians."""
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if name == "kernel" else plain_fn
        times[name].append(device_ms(torch, fn, setup))
    return statistics.median(times["kernel"]), statistics.median(
        times["plain"])


def timed(max_abs_err, ms, plain_ms, bound, library_ms=None) -> dict:
    """A kernel's phase-3 entry: its error and times, and its bound
    (``bounds.bound``) with the share of it reached."""
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                share=bound["bound_ms"] / ms, library_ms=library_ms,
                bytes=bound["bytes"])


def bits_equal(torch, a, b) -> bool:
    """Same shape and the same 32-bit words (-0.0 differs from +0.0)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def max_err(pairs) -> float:
    return max((float((g.double() - w.double()).abs().max())
                for g, w in pairs if g.numel()), default=0.0)


def captured_inserts(hashing, fn) -> list:
    """Run ``fn()`` and return ``(table, ids, n_live)`` for every
    ``hashing.lookup_or_insert`` call it makes: a copy of the key table as
    it stood before the call, the ids and the caller's device-side live
    count (None where it passes none), so that K2 is held and timed on
    exactly the inputs a main path gives it."""
    calls = []
    real = hashing.lookup_or_insert

    def spy(key_table, ids, *args, **kw):
        n_live = kw.get("n_live")
        calls.append((key_table.clone(), ids.clone(),
                      None if n_live is None else n_live.clone()))
        return real(key_table, ids, *args, **kw)

    hashing.lookup_or_insert = spy
    try:
        fn()
    finally:
        hashing.lookup_or_insert = real
    return calls


def copy_grid(grid):
    """A copy of a grid dataclass with every tensor cloned."""
    return dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).clone()
        for f in dataclasses.fields(grid)})


@functools.cache
def flush_buffer(torch):
    """128 MB on the card, written once, so that a flush only reads."""
    return torch.ones(32 << 20, dtype=torch.int32, device="cuda")


def cold(torch, *args):
    """``args`` after reading 128 MB, so that the timed call finds the
    50 MB L2 holding none of its inputs, as the main path does after its
    sorts and scans."""
    flush_buffer(torch).sum()
    return args


def carried_state(pipe, batch, rays):
    """The fusion bench grid after two K=8 batches and a refine after
    each."""
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *batch(i), rays)
        pipe.refine(grid)
    return grid


def fusion_state(torch, hashing, pipe, batch, rays):
    """The fusion bench grid after two K=8 batches and a refine after each,
    then the third batch integrated, with K2's call captured (shape
    ``integrate``), and the refine after it run on a copy, with K2's line
    cell call captured (shape ``refine``).  Returns the grid after the
    third batch and ``{shape: (table, ids, n_live)}``."""
    grid = carried_state(pipe, batch, rays)
    (a,) = captured_inserts(hashing, lambda: pipe.step_batch_depth(
        grid, *batch(2), rays))
    (b,) = captured_inserts(hashing, lambda: pipe.refine(copy_grid(grid)))
    return grid, {"integrate": a, "refine": b}


def tsdf_state(hashing, pipe, batch, rays):
    """The config-5 grid after two K=8 batches, and the third batch
    integrated into a copy, with K2's call captured (shape ``tsdf``)."""
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *batch(i), rays)
    (c,) = captured_inserts(hashing, lambda: pipe.step_batch_depth(
        copy_grid(grid), *batch(2), rays))
    return grid, c


def check_insert(torch, table, ids, n_live, max_probes, shape) -> dict:
    """K2 against its plain version on one captured call: both tables must
    hold the same id set, every id at its slot, no failures.  Times the
    form the callers use (the failures added into their counter, the live
    count where the caller passes one).  The bound counts the ids alone;
    the lanes of the budget-sized array are logged beside it.  Returns the
    ``timed`` entry with the shape's counts."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.ops import hashing
    C = table.numel()

    def counter():
        return torch.zeros((), dtype=torch.int32, device=table.device)

    def insert(fn):
        key, nf = table.clone(), counter()
        slot = fn(key, ids, max_probes, C, nf, n_live)
        return key, slot, int(nf)

    kk, sk, fk = insert(hashing.lookup_or_insert)
    kp, sp, fp = insert(hashing.insert_plain)
    # the lanes before the live count hold the ids; among them INVALID_ID
    # lanes (the refine's non-start line lanes) get -1; the kernel leaves
    # the lanes past the count unset
    n = ids.numel() if n_live is None else int(n_live)
    head = torch.arange(ids.numel(), device=ids.device) < n
    live = head & (ids != hashing.INVALID_ID)
    bad = sum(int((k[s[live].long()] != ids[live]).sum())
              + int((s[head & ~live] != -1).sum())
              for k, s in ((kk, sk), (kp, sp)))
    bad += int((torch.sort(kk).values != torch.sort(kp).values).sum())
    if bad or fk or fp:
        raise AssertionError(f"hash_insert {shape}: {bad} id mismatches, "
                             f"failures kernel {fk} plain {fp}")
    counts = bounds.hash_insert_counts(table, kk)
    ms, pms = time_pair(
        torch, hashing.lookup_or_insert, hashing.insert_plain,
        lambda: cold(torch, table.clone(), ids, max_probes, C, counter(),
                     n_live))
    warm = device_ms(torch, hashing.lookup_or_insert, lambda: (
        table.clone(), ids, max_probes, C, counter(), n_live))
    log(f"phase 3: hash_insert {shape}: n {ids.numel()} lanes, "
        f"live count {'none' if n_live is None else n}, "
        f"{int(live.sum())} ids, n_new "
        f"{counts['n_new']}, load {counts['load_before']:.4f} -> "
        f"{counts['load_after']:.4f} of {C} slots; {warm:.4f} ms with the "
        f"table left in L2 by its copy")
    return {**timed(float(bad), ms, pms, bounds.hash_insert(
        int(live.sum()), counts["n_new"])),
        "n": int(live.sum()), "lanes": int(ids.numel()), **counts,
        "warm_ms": warm}


def check_kernels(torch, cfg, frames, rays, dev):
    """Phase 3: every kernel against its plain version at main-path
    shapes.  Returns {name: ``timed`` entry}; K2's entries are named
    ``hash_insert/<shape>``."""
    from hifi_fusion_tpu_torch import bounds, checks
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    from hifi_fusion_tpu_torch.ops import hashing, integrate, refine
    pipe = FusionPipeline(cfg, dev)
    res = {}

    def batch(i):
        fs = frames[8 * i:8 * i + 8]
        return (pipe.put(np.stack([f.depth_q for f in fs])),
                pipe.put(np.stack([f.rgb565 for f in fs])),
                pipe.put(np.full((len(fs),), fs[0].count, np.int32)),
                pipe.put(np.stack([f.pose for f in fs])))

    # K1: bit-exact on the first batch
    b0 = batch(0)
    got = integrate.depth_frontend(*b0, rays, cfg)
    want = integrate.depth_frontend_plain(*b0, rays, cfg)
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    if err != 0.0:
        raise AssertionError(f"depth_frontend differs from plain: {err}")
    ms, pms = time_pair(
        torch, lambda: integrate.depth_frontend(*b0, rays, cfg),
        lambda: integrate.depth_frontend_plain(*b0, rays, cfg), tuple)
    res["depth_frontend"] = timed(err, ms, pms,
                                  bounds.depth_frontend(*b0[0].shape))

    # K2 at the integrate and refine shapes of the third batch
    grid, calls = fusion_state(torch, hashing, pipe, batch, rays)
    for shape, (table, ids, n_live) in calls.items():
        res[f"hash_insert/{shape}"] = check_insert(
            torch, table, ids, n_live, cfg.max_probes, shape)

    # K3: the third batch's points through the grid's dependants (the
    # integrate streams them after the per-cell sums, which K3 does not
    # read)
    world, ids, _ = integrate.depth_frontend(*batch(2), rays, cfg)
    sid, order = torch.sort(ids, stable=True)
    n_act = int((sid != integrate.INVALID_ID).sum())
    uids, run = torch.unique_consecutive(sid[:n_act], return_inverse=True)
    pts = world[:, order[:n_act]].contiguous()
    slot_pt = hashing.lookup(grid.key, uids, cfg.max_probes,
                             cfg.capacity)[run].contiguous()

    def stream_grid():
        return (pts, slot_pt, dataclasses.replace(
            grid, cyl_stats=grid.cyl_stats.clone()), cfg)

    gk, gp = stream_grid()[2], stream_grid()[2]
    integrate.dep_stream(pts, slot_pt, gk, cfg)
    integrate.dep_stream_plain(pts, slot_pt, gp, cfg)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     cfg.cylinder_radius)
    added = (gk.cyl_stats.view(-1, 5)[:, 4]
             - grid.cyl_stats.view(-1, 5)[:, 4])
    hits = float(added.sum())
    if not ok or hits <= 0:
        raise AssertionError(f"dep_stream: ok={ok} max err {err}, "
                             f"{hits} new hits")
    counts = bounds.dep_stream_counts(slot_pt, grid.dep, grid.dep_count,
                                      cfg.max_dependants, added)
    log(f"phase 3: dep_stream: {counts}, {hits:.0f} hits")
    ms, pms = time_pair(torch, integrate.dep_stream,
                        integrate.dep_stream_plain, stream_grid)
    res["dep_stream"] = timed(err, ms, pms, bounds.dep_stream(**counts))

    # K4: the refine's candidates after the third batch
    cand = torch.nonzero((grid.n_pts > 0) & ~grid.normal_found
                         ).squeeze(1).to(torch.int32)

    def warm_grid():
        return cand, dataclasses.replace(
            grid, normal=grid.normal.clone(),
            normal_found=grid.normal_found.clone()), cfg

    def fit_grid():
        return cold(torch, *warm_grid())

    gk, gp = fit_grid()[1], fit_grid()[1]
    nk, okk = refine.normal_fit(cand, gk, cfg)
    np_, okp = refine.normal_fit_plain(cand, gp, cfg)
    words = bounds.normal_fit_words(grid.key[cand.long()], cfg.dims,
                                    cfg.k_neighborhood, grid.occ_bits.numel())
    log(f"phase 3: normal_fit: U {cand.numel()}, n_gated "
        f"{int(okk.sum())}, {words} distinct window words, k "
        f"{cfg.k_neighborhood}")
    if not torch.equal(okk, okp) or not torch.equal(gk.normal_found,
                                                    gp.normal_found):
        raise AssertionError("normal_fit: gate differs from plain")
    err = float((gk.normal - gp.normal).abs().max())
    if err > 1e-5 or int(okk.sum()) == 0:
        raise AssertionError(f"normal_fit: normals differ by {err} "
                             f"({int(okk.sum())} gated)")
    ms, pms = time_pair(torch, refine.normal_fit, refine.normal_fit_plain,
                        fit_grid)
    warm = device_ms(torch, refine.normal_fit, warm_grid)
    log(f"phase 3: normal_fit: {warm:.4f} ms without the L2 read ahead")
    res["normal_fit"] = {**timed(err, ms, pms, bounds.normal_fit(
        cand.numel(), int(okk.sum()), words)), "U": int(cand.numel()),
        "n_gated": int(okk.sum()), "words": words, "warm_ms": warm}
    del grid, calls, gk, gp
    res["integrate_lanes"] = check_integrate_lanes(torch, cfg, pipe, batch,
                                                   rays)
    res.update(check_refine_kernels(torch, cfg, pipe, batch, rays))
    return res


def with_copies(grid, names):
    """``grid`` with the fields ``names`` cloned (the ones a call writes)."""
    return dataclasses.replace(grid, **{n: getattr(grid, n).clone()
                                        for n in names})


def cells_at(torch, grid, slots):
    """The cell id at each slot, -1 where the slot is -1."""
    return torch.where(slots >= 0, grid.key[slots.clamp(min=0).long()], -1)


def grid_problems(cfg, got, want) -> list:
    """``checks.grid_problems`` of two grids on the card."""
    from hifi_fusion_tpu_torch import checks, convert
    return checks.grid_problems(convert.grid_to_numpy(got),
                                convert.grid_to_numpy(want), cfg)


# the fields B3 (with K2) and B6 (with K2) write
B3_WRITES = ("key", "n_pts", "rgb_sum", "viewpoint", "occ_bits", "buf_pts",
             "buf_slot", "buf_count", "overflow_active", "overflow_probe",
             "overflow_buf")
B6_WRITES = ("key", "dep", "dep_count", "overflow_dep", "overflow_probe")


def kernel_split(torch, fn, setup) -> dict:
    """Device ms by kernel name of one ``fn(*setup())`` call, from a
    ``torch.profiler`` trace (CUDA activity; library kernels and copies
    included), after one untraced call.  The traces have dropped the
    first launches of a window (a call's first kernel, once a whole
    call), so a sleep kernel goes first and is left out of the split,
    and a trace without any device activity is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn(*setup())
    out = {}
    for _ in range(3):
        args = setup()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SLEEP_CYCLES)
            fn(*args)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            trace = json.loads(path.read_text())
        for e in trace.get("traceEvents", ()):
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                    and "dur" in e and "spin_kernel" not in e["name"]:
                name = e["name"].split("(")[0].split("<")[0][:48]
                out[name] = out.get(name, 0.0) + e["dur"] / 1e3
        if out:
            break
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def same_grid_bits(cfg, a, b) -> bool:
    """Two grids on the card hold the same cells with bit-identical fields
    (``checks.by_cell``, floats compared as their words) and the same
    buffer in order."""
    from hifi_fusion_tpu_torch import checks, convert
    fa, fb = convert.grid_to_numpy(a), convert.grid_to_numpy(b)
    ca, cb = checks.by_cell(fa, cfg), checks.by_cell(fb, cfg)

    def words(v):
        v = np.asarray(v)
        return v.view(np.int32) if v.dtype == np.float32 else v

    oa, ob = checks.ordered_rows(fa, cfg), checks.ordered_rows(fb, cfg)
    return (all(np.array_equal(words(ca[k]), words(cb[k])) for k in ca)
            and np.array_equal(oa["buffer"].view(np.int64),
                               ob["buffer"].view(np.int64)))


def check_integrate_lanes(torch, cfg, pipe, batch, rays) -> dict:
    """Phase 3, B3: the third K=8 batch's sorted lanes into the grid
    carried through two batches and two refines, against the plain
    version: every integer field, the integer-valued sums and the
    viewpoints by cell id, the buffer in order, and the sorted points and
    cells K3 takes.  Returns the ``timed`` entry with the call's counts."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.ops import integrate
    grid = carried_state(pipe, batch, rays)
    b = batch(2)
    K, N = b[0].shape
    world, ids, rgb = integrate.depth_frontend(*b, rays, cfg)
    sid, order = torch.sort(ids, stable=True)
    NA = min(K * cfg.max_active_points, K * N)

    def setup():
        return (with_copies(grid, B3_WRITES), sid, order, world, rgb, b[3],
                N, NA, cfg)

    gk, gp = setup()[0], setup()[0]
    pk, sk = integrate.aggregate_lanes(gk, *setup()[1:])
    pp, sp = integrate.aggregate_lanes_plain(gp, *setup()[1:])
    torch.cuda.synchronize()
    problems = grid_problems(cfg, gk, gp)
    if not bits_equal(torch, pk, pp):
        problems.append("sorted points differ")
    if not torch.equal(cells_at(torch, gk, sk), cells_at(torch, gp, sp)):
        problems.append("sorted lanes' cells differ")
    if problems:
        raise AssertionError(f"integrate_lanes: {problems}")
    v = sid[:NA]
    v = v[v != integrate.INVALID_ID]
    counts = {
        "NA": NA, "n_sv": int(v.numel()),
        "U": int(torch.unique_consecutive(v).numel()),
        "n_new": int(((grid.key < 0) & (gk.key >= 0)).sum()),
        "n_first": int(((grid.n_pts == 0) & (gk.n_pts > 0)).sum()),
        "n_words": int(torch.unique_consecutive(v >> 5).numel()),
        "n_want": int(gk.buf_count - grid.buf_count)}
    # the same call again on another copy: bit-identical by cell id
    g2 = setup()[0]
    integrate.aggregate_lanes(g2, *setup()[1:])
    torch.cuda.synchronize()
    if not same_grid_bits(cfg, gk, g2):
        raise AssertionError("integrate_lanes: a repeat differs")
    log(f"phase 3: integrate_lanes: {counts}; the grid, buffer order and "
        f"K3's lanes exact against the plain version, a repeat "
        f"bit-identical")
    ms, pms = time_pair(torch, integrate.aggregate_lanes,
                        integrate.aggregate_lanes_plain,
                        lambda: cold(torch, *setup()))
    split = kernel_split(torch, integrate.aggregate_lanes, setup)
    log(f"phase 3: integrate_lanes by kernel, ms: {json.dumps(split)}")
    return {**timed(0.0, ms, pms, bounds.integrate_lanes(
        store_color=cfg.store_color, **counts)), **counts,
        "passes_ms": split}


def check_refine_kernels(torch, cfg, pipe, batch, rays) -> dict:
    """Phase 3, B6 and B7 on the first refine of phase 4's sweep (after the
    first K=8 batch): B6 against its plain version (the grid by cell id
    with the dependant lists in order, the links by cell), then B7 on B6's
    links against its plain version (hit counts exact, sums under
    ``checks.cyl_stats_error``) and a second launch on another copy
    (``cyl_stats`` bit-identical); then the whole refine's device ms by
    stage.  Returns both ``timed``
    entries with their counts."""
    from hifi_fusion_tpu_torch import bounds, checks
    from hifi_fusion_tpu_torch.ops import refine
    grid = pipe.init()
    pipe.step_batch_depth(grid, *batch(0), rays)
    cand = torch.nonzero((grid.n_pts > 0) & ~grid.normal_found
                         ).squeeze(1).to(torch.int32)
    nvec, gated = refine.normal_fit(
        cand, with_copies(grid, ("normal", "normal_found")), cfg)

    def setup6():
        return cand, nvec, gated, with_copies(grid, B6_WRITES), cfg

    gk, gp = setup6()[3], setup6()[3]
    lk = refine.refine_lines(cand, nvec, gated, gk, cfg)
    lp = refine.refine_lines_plain(cand, nvec, gated, gp, cfg)
    torch.cuda.synchronize()
    problems = grid_problems(cfg, gk, gp)
    if not torch.equal(cells_at(torch, gk, lk), cells_at(torch, gp, lp)):
        problems.append("links differ")
    n_written = int((lk >= 0).sum())
    if problems or n_written == 0:
        raise AssertionError(f"refine_lines: {problems}, {n_written} links")
    lids, valid = refine.line_cells(cand, nvec, gated, grid, cfg)
    c6 = {"U": int(cand.numel()), "n_gated": int(gated.sum()),
          "L": cfg.n_line,
          "n_cells": int(torch.unique(lids[valid]).numel()),
          "n_new": int(((grid.key < 0) & (gk.key >= 0)).sum()),
          "n_written": n_written}
    log(f"phase 3: refine_lines: {c6}, overflow_dep "
        f"{int(gk.overflow_dep)}; dependant lists in order and links "
        f"exact against the plain version")
    ms, pms = time_pair(torch, refine.refine_lines, refine.refine_lines_plain,
                        lambda: cold(torch, *setup6()))
    # the library sort alone, on the pass's line-cell ids (the kernel's
    # points pass is bit-equal to line_cells); the hand passes are the
    # rest, and the share is theirs
    lid = torch.where(valid, lids, refine.INVALID_ID).contiguous()
    sort_ms = device_ms(torch, lambda: torch.sort(lid, stable=True), tuple)
    split = kernel_split(torch, refine.refine_lines, setup6)
    log(f"phase 3: refine_lines by kernel, ms: {json.dumps(split)}")
    b6 = bounds.refine_lines(**c6)
    hand_ms = ms - sort_ms
    log(f"phase 3: refine_lines: {ms:.4f} ms, the library sort of "
        f"{lid.numel()} ids {sort_ms:.4f} ms, the hand passes "
        f"{hand_ms:.4f} ms, share {b6['bound_ms'] / hand_ms:.3f} of "
        f"{b6['bound_ms']:.4f} ms")
    res = {"refine_lines": {**timed(0.0, ms, pms, b6), **c6,
                            "share": b6["bound_ms"] / hand_ms,
                            "sort_ms": sort_ms, "hand_ms": hand_ms,
                            "passes_ms": split}}

    bc = int(gk.buf_count)
    bslot, bpts = refine.sorted_buffer(gk, bc)

    def setup7():
        return (lk, cand, nvec, bslot, bpts, with_copies(gk, ("cyl_stats",)),
                cfg)

    rk, rp, r2 = setup7()[-2], setup7()[-2], setup7()[-2]
    refine.buffer_replay(lk, cand, nvec, bslot, bpts, rk, cfg)
    refine.buffer_replay_plain(lk, cand, nvec, bslot, bpts, rp, cfg)
    refine.buffer_replay(lk, cand, nvec, bslot, bpts, r2, cfg)
    torch.cuda.synchronize()
    ok, err = checks.cyl_stats_error(rk.cyl_stats.cpu().numpy(),
                                     rp.cyl_stats.cpu().numpy(),
                                     cfg.cylinder_radius)
    added = rk.cyl_stats.view(-1, 5)[:, 4] - gk.cyl_stats.view(-1, 5)[:, 4]
    if not ok or float(added.sum()) <= 0:
        raise AssertionError(f"buffer_replay: ok={ok} max err {err}, "
                             f"{float(added.sum())} hits")
    if not bits_equal(torch, rk.cyl_stats, r2.cyl_stats):
        raise AssertionError("buffer_replay: a repeat differs")
    c7 = bounds.buffer_replay_counts(lk, bslot, added)
    log(f"phase 3: buffer_replay: {c7}, {float(added.sum()):.0f} hits, "
        f"buffer {bc} lanes; hit counts exact, sums within rtol "
        f"{checks.RTOL} of the terms (max_abs_err {err:.3g}, bit-equal to "
        f"the plain version: "
        f"{bits_equal(torch, rk.cyl_stats, rp.cyl_stats)}); a repeat "
        f"bit-identical")
    ms, pms = time_pair(torch, refine.buffer_replay,
                        refine.buffer_replay_plain,
                        lambda: cold(torch, *setup7()))
    split = kernel_split(torch, refine.buffer_replay, setup7)
    log(f"phase 3: buffer_replay by kernel, ms: {json.dumps(split)}")
    b7 = bounds.buffer_replay(c7["P"], c7["n_owners"], c7["n_points"],
                              c7["n_pairs"], c7["n_hit_owners"])
    per_link = bounds.buffer_replay_per_link(
        c7["P"], c7["n_links"], c7["n_points"], c7["n_pairs"],
        c7["n_hit_owners"])["bound_ms"]
    log(f"phase 3: buffer_replay: {ms:.4f} ms, share "
        f"{b7['bound_ms'] / ms:.3f} of its bound {b7['bound_ms']:.4f} ms "
        f"({b7['bytes'] / 1e6:.1f} MB); on the per-link yardstick "
        f"(bounds.buffer_replay_per_link, {per_link:.4f} ms) "
        f"{per_link / ms:.3f}")
    res["buffer_replay"] = {**timed(err, ms, pms, b7), **c7,
                            "passes_ms": split,
                            "per_link_share": per_link / ms}
    stages = refine_stages(torch, cfg, grid, refine)
    log(f"phase 3: the first refine's device ms by stage: "
        f"{json.dumps(stages)}")
    res["buffer_replay"]["refine_stages_ms"] = stages
    return res


def refine_stages(torch, cfg, grid, refine) -> dict:
    """Device ms of each stage of ``refine_pass`` on ``grid`` (the state
    before phase 4's first refine), each timed alone on the inputs the
    earlier stages give it, and of the whole pass: the candidates with
    the pass's one host read, K4, B6, the buffer's sort and gather, B7,
    reclamation."""
    g = copy_grid(grid)
    cand, bc = refine.refine_candidates(g, cfg)
    nvec, gated = refine.normal_fit(cand, g, cfg)
    links = refine.refine_lines(cand, nvec, gated, g, cfg)
    bslot, bpts = refine.sorted_buffer(g, bc)
    refine.buffer_replay(links, cand, nvec, bslot, bpts, g, cfg)
    buf = ("buf_pts", "buf_slot", "buf_count", "reclaimed")
    out = {
        "candidates": device_ms(torch, refine.refine_candidates, lambda: (
            with_copies(grid, ("overflow_refine",)), cfg)),
        "normal_fit": device_ms(torch, refine.normal_fit, lambda: (
            cand, with_copies(grid, ("normal", "normal_found")), cfg)),
        "refine_lines": device_ms(torch, refine.refine_lines, lambda: (
            cand, nvec, gated, with_copies(grid, B6_WRITES), cfg)),
        "buffer_sort": device_ms(torch, refine.sorted_buffer,
                                 lambda: (grid, bc)),
        "buffer_replay": device_ms(torch, refine.buffer_replay, lambda: (
            links, cand, nvec, bslot, bpts, with_copies(g, ("cyl_stats",)),
            cfg)),
        "reclaim": device_ms(torch, refine.reclaim, lambda: (
            with_copies(g, buf), cfg, bslot, bpts)),
        "refine_pass": device_ms(torch, refine.refine_pass, lambda: (
            copy_grid(grid), cfg))}
    out["sum_of_stages"] = sum(v for k, v in out.items()
                               if k != "refine_pass")
    return out


def check_tsdf_kernels(torch, tcfg, frames, clouds, rays, dev):
    """Phase 3, TSDF config 5: T2 and T1 on the sweep's third K=8 batch
    (27.0 M sample lanes), T2p on the same frames' records, T3 on the
    surface of a grid after two batches, K2 on that batch's insert into
    that grid.  Returns {name: ``timed`` entry}."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.models import tsdf
    from hifi_fusion_tpu_torch.ops import hashing, scatter
    pipe = tsdf.TsdfPipeline(tcfg, dev)
    K = tcfg.base.max_batch_frames
    res = {}

    def batch(i):
        fs = frames[K * i:K * i + K]
        return (pipe.put(np.stack([f.depth_q for f in fs])),
                pipe.put(np.stack([f.rgb565 for f in fs])),
                pipe.put(np.full((K,), fs[0].count, np.int32)),
                pipe.put(np.stack([f.pose for f in fs])))

    # T2: bit-exact
    b2 = batch(2)
    lanes = tsdf.tsdf_lanes(*b2, rays, tcfg)
    want = tsdf.tsdf_lanes_plain(*b2, rays, tcfg)
    err = max_err(zip(lanes, want))
    if not all(bits_equal(torch, g, w) for g, w in zip(lanes, want)):
        raise AssertionError(f"tsdf_lanes differs from plain: {err}")
    del want
    ms, pms = time_pair(
        torch, lambda: tsdf.tsdf_lanes(*b2, rays, tcfg),
        lambda: tsdf.tsdf_lanes_plain(*b2, rays, tcfg), tuple)
    res["tsdf_lanes"] = timed(err, ms, pms, bounds.tsdf_lanes(
        *b2[0].shape, tcfg.n_samples))

    # T2p: bit-exact on the session's planar wire of the same frames'
    # records, whose valid lanes are T2's
    wire = record_wire(torch, clouds[2 * K:3 * K], tcfg.base.max_points,
                       dev)
    got = tsdf.tsdf_lanes_planar(*wire, tcfg)
    want = tsdf.tsdf_lanes_planar_plain(*wire, tcfg)
    err = max_err(zip(got, want))
    if not all(bits_equal(torch, g, w) for g, w in zip(got, want)):
        raise AssertionError(f"tsdf_lanes_planar differs from plain: {err}")
    del want
    if not torch.equal(torch.sort(got[0]).values,
                       torch.sort(lanes[0]).values):
        raise AssertionError("tsdf_lanes_planar: the records' lanes hold "
                             "other cells than the depth batch's")
    log(f"phase 3: tsdf_lanes_planar: bit-exact, "
        f"{int((got[0] != tsdf.BIG).sum())} valid lanes of "
        f"{got[0].numel()}, the depth batch's cells")
    del got
    ms, pms = time_pair(
        torch, lambda: tsdf.tsdf_lanes_planar(*wire, tcfg),
        lambda: tsdf.tsdf_lanes_planar_plain(*wire, tcfg), tuple)
    res["tsdf_lanes_planar"] = timed(err, ms, pms, bounds.tsdf_lanes_planar(
        K, tcfg.base.max_points, tcfg.n_samples))
    del wire

    # T1: bit-exact for every kind, on the batch's sorted lanes and on a
    # flat-ladder prefix (n <= 1024)
    sid, order = tsdf.sort_lanes(lanes[0])
    vals6 = lanes[1]
    svals = vals6[:, order]
    del lanes
    starts = scatter.segment_starts(sid, sid != tsdf.BIG)
    words = svals.view(torch.int32)
    cases = [("add", svals), ("first", svals), ("first", words),
             ("or", words)]
    cases += [(kind, v[:, :1000].contiguous()) for kind, v in cases]
    err = 0.0
    for kind, v in cases:
        f = starts[:v.shape[1]].contiguous()
        g = scatter.segment_reduce(v, f, kind)
        w = scatter.segment_reduce_plain(v, f, kind)
        if not bits_equal(torch, g, w):
            raise AssertionError(f"segscan {kind} {v.dtype} n={v.shape[1]} "
                                 f"differs from plain")
        err = max(err, max_err([(g, w)]))
        del g, w
    log(f"phase 3: segscan: {sid.numel()} lanes x 6, "
        f"{int(starts.sum())} segments")
    ms, pms = time_pair(torch, scatter.segment_reduce,
                        scatter.segment_reduce_plain,
                        lambda: (svals, starts, "add"))
    lib_ms = segscan_yardstick(torch, scatter, tsdf, sid, svals, starts)
    res["segscan"] = timed(err, ms, pms, bounds.segscan(*svals.shape),
                           lib_ms)
    del svals, words, starts, cases

    # T3, bit-exact, at two shapes: the grid after two batches, and the
    # final grid of the replay (every batch of the sweep), the one its
    # real call in process() meets
    grid, (table, ids, n_live) = tsdf_state(hashing, pipe, batch, rays)
    # T4 on the same batch's sorted ids, order and lanes into the grid
    # after two batches
    res["tsdf_reduce"] = check_tsdf_reduce(torch, tcfg, grid, sid, order,
                                           vals6)
    del sid, order, vals6
    final = pipe.init()
    for i in range(len(frames) // K):
        pipe.step_batch_depth(final, *batch(i), rays)
    shapes = {"batch2": check_surface(torch, tcfg, grid, "batch2"),
              "replay": check_surface(torch, tcfg, final, "replay")}
    del final
    res["tsdf_surface"] = {**shapes["replay"], "shapes": shapes}

    # K2 at the TSDF batch shape: the third batch's distinct cells into
    # the 2^24-slot table after two batches
    res["hash_insert/tsdf"] = check_insert(torch, table, ids, n_live,
                                           tcfg.base.max_probes, "tsdf")
    return res


def t4_problems(torch, tcfg, grid, sid, order, vals6, U) -> tuple:
    """T4 (``tsdf.tsdf_reduce``, with K2) and its plain version on copies
    of ``grid``, and T4 again on a third copy: the problems found (the
    key set, ``vstats`` by cell bit for bit, both counters and the live
    count K2 is handed, with its ids, against the plain version; the
    repeat's cells, ``vstats`` words and counters against the first
    launch), the kernel's grid and K2's captured call."""
    from hifi_fusion_tpu_torch import checks, convert
    from hifi_fusion_tpu_torch.models import tsdf
    from hifi_fusion_tpu_torch.ops import hashing
    C = tcfg.base.capacity
    fields = ("key", "vstats", "overflow_probe", "overflow_unique")
    gk, gp, gr = (with_copies(grid, fields) for _ in range(3))
    (ck,), (cp,), _ = (
        captured_inserts(hashing, lambda: fn(g, sid, order, vals6, U, tcfg))
        for fn, g in ((tsdf.tsdf_reduce, gk), (tsdf.tsdf_reduce_plain, gp),
                      (tsdf.tsdf_reduce, gr)))
    torch.cuda.synchronize()
    a, b, r = (checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(g, tcfg), C)
               for g in (gk, gp, gr))
    n_live = ck[1].numel() if ck[2] is None else int(ck[2])
    problems = [k for k in ("overflow_probe", "overflow_unique")
                if a[k] != b[k] or a[k] != r[k]]
    if not np.array_equal(a["cell"], b["cell"]):
        problems.append("cell sets differ")
    elif a["vstats"].tobytes() != b["vstats"].tobytes():
        problems.append("vstats differ")
    if not np.array_equal(a["cell"], r["cell"]) \
            or a["vstats"].tobytes() != r["vstats"].tobytes():
        problems.append("a repeat differs")
    if n_live != cp[1].numel() or not torch.equal(ck[1][:n_live], cp[1]):
        problems.append(f"live ids differ: {n_live} / {cp[1].numel()}")
    return problems, gk, n_live


def check_tsdf_reduce(torch, tcfg, grid, sid, order, vals6) -> dict:
    """Phase 3, T4 (``tsdf.tsdf_reduce``, with K2): the third K=8 batch's
    sorted ids ``sid``, the sort's ``order`` and the sample lanes
    ``vals6`` into the config-5 grid after two batches, against the plain
    version: the key set, ``vstats`` by cell bit for bit, both counters
    and the live count K2 was handed (with its ids) exactly, and a repeat
    launch bit-identical by cell; then the same on the lanes' edge cases
    (``checks.tsdf_reduce_case``): a run of over 1024 lanes over three
    ladder blocks, one over ~78 blocks, runs of a few lanes across every
    block edge, and M <= 1024 (the flat ladder) under and over U.
    Returns the ``timed`` entry with the call's counts and its device ms
    by kernel."""
    from hifi_fusion_tpu_torch import bounds, checks
    from hifi_fusion_tpu_torch.models import tsdf
    K = tcfg.base.max_batch_frames
    M = sid.numel()
    U = min(tcfg.batch_unique or K * 4 * tcfg.base.max_unique_per_frame, M,
            tsdf.tail(tcfg))
    problems, gk, n_live = t4_problems(torch, tcfg, grid, sid, order,
                                       vals6, U)
    if problems:
        raise AssertionError(f"tsdf_reduce: {problems}")
    v = sid[sid != tsdf.BIG]
    counts = {"M": M, "U": U,
              "n_u": int(torch.unique_consecutive(v).numel()),
              "n_live": n_live,
              "n_new": int(((grid.key < 0) & (gk.key >= 0)).sum()),
              "n_placed": n_live - int(gk.overflow_probe
                                       - grid.overflow_probe)}
    del gk
    log(f"phase 3: tsdf_reduce: {counts}; the key set, vstats (bits) and "
        f"counters exact against the plain version, a repeat bit-identical")
    # (cells, lanes, valid lanes (-1: 3/4), extra lanes of one run, U)
    edge = {"run over three blocks": (300, 12288, -1, 2000, 1000),
            "run over 78 blocks": (200, 65536, -1, 40000, 4000),
            "block edges": (3000, 12288, -1, 0, 4000),
            "flat": (500, 1000, -1, 0, 1000),
            "flat over U": (700, 1000, -1, 0, 300)}
    for name, (n_cells, m, n_valid, run, u) in edge.items():
        skey, vals = (torch.from_numpy(x).cuda() for x in
                      checks.tsdf_reduce_case(n_cells, m, seed=7,
                                              n_valid=n_valid,
                                              run_lanes=run))
        s, o = tsdf.sort_lanes(skey)
        problems = t4_problems(torch, tcfg, grid, s, o, vals, u)[0]
        if problems:
            raise AssertionError(f"tsdf_reduce, {name}: {problems}")
    log(f"phase 3: tsdf_reduce: exact against the plain version and on a "
        f"repeat in {len(edge)} edge cases ({', '.join(edge)})")

    def setup():
        return (with_copies(grid, ("key", "vstats", "overflow_probe",
                                   "overflow_unique")), sid, order, vals6,
                U, tcfg)

    ms, pms = time_pair(torch, tsdf.tsdf_reduce, tsdf.tsdf_reduce_plain,
                        lambda: cold(torch, *setup()))
    split = kernel_split(torch, tsdf.tsdf_reduce, setup)
    log(f"phase 3: tsdf_reduce by kernel, ms: {json.dumps(split)}")
    return {**timed(0.0, ms, pms, bounds.tsdf_reduce(
        M, n_live, counts["n_new"], counts["n_placed"])), **counts,
        "passes_ms": split}


def tsdf_sync_reads(torch, tcfg, frames, clouds, rays_np, wire) -> int:
    """One K=8 TSDF dispatch on ``wire`` ("depth": phase 6's; "planar":
    phase 10's count prefixes of the records) under
    ``torch.cuda.set_sync_debug_mode("error")``, its inputs put on the
    card first, as the session does: raises on any synchronizing call,
    else returns 0."""
    from hifi_fusion_tpu_torch.models import tsdf
    pipe = tsdf.TsdfPipeline(tcfg, "cuda")
    fs = frames[:8]
    if wire == "depth":
        args = (pipe.put(np.stack([f.depth_q for f in fs])),
                pipe.put(np.stack([f.rgb565 for f in fs])),
                pipe.put(np.full((8,), fs[0].count, np.int32)),
                pipe.put(np.stack([f.pose for f in fs])), pipe.put(rays_np))
        step = pipe.step_batch_depth
    else:
        args = record_wire(torch, clouds[:8], tcfg.base.max_points, "cuda")
        step = pipe.step_batch
    grid = pipe.init()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(grid, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if int(grid.frames) != 8 or int((grid.key >= 0).sum()) == 0:
        raise AssertionError(f"TSDF {wire} dispatch: {int(grid.frames)} "
                             f"frames")
    return 0


def record_wire(torch, clouds, N, dev):
    """The session's planar wire of K ``(CloudFrame, pose)`` records:
    each decoded by ``decode_frame`` into a count prefix of (K,3,N) f32
    points and colour, as ``FusionSession._decode_planar`` packs them, and
    the (K,4,4) poses, on ``dev``."""
    from hifi_fusion_tpu_torch.runtime.decode import decode_frame
    K = len(clouds)
    pts = np.zeros((K, 3, N), np.float32)
    rgb = np.zeros((K, 3, N), np.float32)
    counts = np.zeros((K,), np.int32)
    for k, (frame, _) in enumerate(clouds):
        xyz, col = decode_frame(frame)
        n = xyz.shape[0]
        pts[k, :, :n], rgb[k, :, :n], counts[k] = xyz.T, col.T, n
    poses = np.stack([p for _, p in clouds]).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (pts, rgb, counts, poses))


def fusion_final_grid(cfg, frames, rays, dev):
    """The fusion replay's final grid through the pipeline, at phase 4's
    cadence: every K=8 batch, a refine after each batch holding a mark."""
    from hifi_fusion_tpu_torch.models.pipeline import (FusionPipeline,
                                                       refine_due)
    pipe = FusionPipeline(cfg, dev)
    grid = pipe.init()
    K = cfg.max_batch_frames
    for i in range(len(frames) // K):
        fs = frames[K * i:K * i + K]
        pipe.step_batch_depth(
            grid, pipe.put(np.stack([f.depth_q for f in fs])),
            pipe.put(np.stack([f.rgb565 for f in fs])),
            pipe.put(np.full((K,), fs[0].count, np.int32)),
            pipe.put(np.stack([f.pose for f in fs])), rays)
        if refine_due(K * (i + 1), K, cfg):
            pipe.refine(grid)
    return grid


def check_neighbor_count(torch, cfg, frames, rays, dev):
    """Phase 3, B11: r=2 over every slot of the fusion replay's final grid
    (-1 where no point landed) against its plain version, counts exact,
    timed with its bound and the ``avg_pool3d`` yardstick.  Returns the
    ``timed`` entry and the occupied cells (ascending) with their
    counts."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.ops import queries
    r = 2
    grid = fusion_final_grid(cfg, frames, rays, dev)
    C = cfg.capacity
    occ = grid.n_pts > 0
    slots = torch.where(occ, torch.arange(C, dtype=torch.int32, device=dev),
                        torch.full((), -1, dtype=torch.int32, device=dev))
    got = queries.occupied_neighbor_counts(grid, slots, cfg, r)
    want = queries.neighbor_counts_plain(grid, slots, cfg, r)
    if not torch.equal(got, want) or int(got.max()) <= 1:
        raise AssertionError(f"neighbor_count differs from plain on "
                             f"{int((got != want).sum())} of {C} slots")
    live = torch.nonzero(occ).squeeze(1)
    cells = grid.key[live]
    words = bounds.normal_fit_words(cells, cfg.dims, r,
                                    grid.occ_bits.numel())
    log(f"phase 3: neighbor_count: {C} query slots, {live.numel()} "
        f"occupied, counts exact, {words} distinct window words, r {r}")
    lib_ms = neighbor_count_yardstick(torch, grid, cfg, r, cells, got[live])
    # the ROR call's shape (every slot), and the occupied slots alone
    shapes = {}
    for shape, q in (("ror", slots), ("occupied", live.to(torch.int32))):
        ms, pms = time_pair(torch, queries.occupied_neighbor_counts,
                            queries.neighbor_counts_plain,
                            lambda: (grid, q, cfg, r))
        shapes[shape] = {**timed(0.0, ms, pms, bounds.neighbor_count(
            q.numel(), live.numel(), words),
            lib_ms if shape == "ror" else None), "Q": int(q.numel())}
    order = torch.argsort(cells)
    return ({**shapes["ror"], "n_live": int(live.numel()), "words": words,
             "shapes": shapes},
            cells[order].cpu().numpy(), got[live][order].cpu().numpy())


def neighbor_count_yardstick(torch, grid, cfg, r, cells, counts) -> float:
    """ms of one ``avg_pool3d`` (``divisor_override=1``) summing every
    (2r+1)^3 window of the dense occupancy volume unpacked from the
    bitmap: every cell's count, where B11 counts the queried ones; checked
    equal to ``counts`` at ``cells``.  The unpacking is made outside the
    timed window."""
    import torch.nn.functional as F
    n = int(np.prod(cfg.dims))
    shifts = torch.arange(32, dtype=torch.int32, device=grid.device)
    bits = (grid.occ_bits[:, None] >> shifts) & 1
    vol = bits.reshape(-1)[:n].to(torch.float32).view(1, 1, *cfg.dims)
    del bits

    def pool(v):
        return F.avg_pool3d(v, 2 * r + 1, stride=1, padding=r,
                            divisor_override=1)

    at = pool(vol).view(-1)[cells.long()]
    if not torch.equal(at.to(torch.int32), counts):
        raise AssertionError("avg_pool3d yardstick differs from B11")
    ms = device_ms(torch, pool, lambda: (vol,))
    del vol, at
    return ms


def check_surface(torch, tcfg, grid, shape) -> dict:
    """T3 against its plain version, bit for bit, on the surface of
    ``grid``; its ``timed`` entry with the surface cell count ``E``."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.models import tsdf
    cell, slots = tsdf.surface_cells(grid, tcfg)
    got = tsdf.tsdf_surface(cell, slots, grid, tcfg)
    want = tsdf.tsdf_surface_plain(cell, slots, grid, tcfg)
    err = max_err(zip(got, want))
    if cell.numel() == 0 or not all(bits_equal(torch, g, w)
                                    for g, w in zip(got, want)):
        raise AssertionError(f"tsdf_surface {shape}: {cell.numel()} "
                             f"cells, max err {err} vs plain")
    ms, pms = time_pair(torch, tsdf.tsdf_surface, tsdf.tsdf_surface_plain,
                        lambda: (cell, slots, grid, tcfg))
    z_next = float((torch.diff(cell) == 1).float().mean())
    log(f"phase 3: tsdf_surface {shape}: {cell.numel()} surface cells, "
        f"bit-exact, {ms:.4f} ms; share of cells whose z+1 neighbour is "
        f"the next surface cell {z_next:.4f}")
    return {**timed(err, ms, pms, bounds.tsdf_surface(cell.numel())),
            "E": int(cell.numel())}


def rgb8(rgb565) -> np.ndarray:
    """(n,) u16 rgb565 -> (n,3) f32 8-bit channels, as the frontends
    expand them (x8, x4, x8)."""
    v = rgb565.astype(np.uint32)
    return np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                     (v & 0x1F) * 8], axis=1).astype(np.float32)


def camera_points(f) -> np.ndarray:
    """(n,3) f32 camera points of a depth frame's valid pixels (depth > 0):
    the card's unprojection, bit for bit."""
    return np.ascontiguousarray(f.points_f32[:, f.depth_q > 0].T)


def cloud_frames(frames) -> list:
    """``(CloudFrame, pose)`` for each depth frame: the PointCloud2 record
    of its valid pixels, their ``camera_points`` and their 8-bit
    colour."""
    from hifi_fusion_tpu_torch.runtime.decode import make_cloud_frame
    return [(make_cloud_frame(camera_points(f),
                              rgb8(f.rgb565[f.depth_q > 0])), f.pose)
            for f in frames]


def planar_wires(torch, frames, dev) -> dict:
    """K5's inputs for the first K=8 frames on three wires: ``{name:
    (points, rgb, mask, poses, quant, (point, rgb, mask) bytes a lane)}``.
    ``f32-f32-count`` is the session's (each frame's valid pixels as a
    count prefix of f32 points and colour), ``f32-u32-bool`` every pixel
    with packed colour and a lane mask, ``q16-u32-count`` the session's
    lanes quantized by ``pack_frame_q16``."""
    from hifi_fusion_tpu_torch.utils.synthetic import Frame, pack_frame_q16
    fs = frames[:8]
    K, N = len(fs), fs[0].depth_q.shape[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    keep = np.stack([f.depth_q > 0 for f in fs])
    pts = np.zeros((K, 3, N), np.float32)
    rgb = np.zeros((K, 3, N), np.float32)
    counts = keep.sum(axis=1).astype(np.int32)
    packed = []
    for k, f in enumerate(fs):
        n = counts[k]
        pts[k, :, :n] = f.points_f32[:, keep[k]]
        rgb[k, :, :n] = rgb8(f.rgb565[keep[k]]).T
        packed.append(pack_frame_q16(Frame(
            pts[k, :, :n].T, rgb[k, :, :n].T, f.pose, np.ones(n, bool)), N))
    r = np.stack([rgb8(f.rgb565) for f in fs]).astype(np.uint32)  # (K,N,3)
    poses = put(np.stack([f.pose for f in fs]))
    return {
        "f32-f32-count": (put(pts), put(rgb), put(counts), poses, None,
                          (12, 12, 0)),
        "f32-u32-bool": (put(np.stack([f.points_f32 for f in fs])),
                         put((r[..., 0] << 16) | (r[..., 1] << 8)
                             | r[..., 2]), put(keep), poses, None,
                         (12, 4, 1)),
        "q16-u32-count": (put(np.stack([p.points_q for p in packed])),
                          put(np.stack([p.rgb_u32 for p in packed])),
                          put(counts), poses,
                          put(np.stack([p.quant for p in packed])),
                          (6, 4, 0)),
    }


def check_planar_frontend(torch, cfg, frames, dev) -> dict:
    """Phase 3, K5: bit-exact against its plain version on each wire of
    ``planar_wires``, timed with its bound; the entry is the session's
    wire, every wire's under ``wires``."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.ops import integrate
    wires = {}
    for name, (p, c, m, t, q, nb) in planar_wires(torch, frames,
                                                   dev).items():
        got = integrate.planar_frontend(p, c, m, t, cfg, q)
        want = integrate.planar_frontend_plain(p, c, m, t, q, cfg)
        err = max_err(zip(got, want))
        if not all(bits_equal(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError(f"planar_frontend {name} differs from "
                                 f"plain: {err}")
        n_valid = int((got[1] != integrate.INVALID_ID).sum())
        del got, want
        ms, pms = time_pair(
            torch, lambda: integrate.planar_frontend(p, c, m, t, cfg, q),
            lambda: integrate.planar_frontend_plain(p, c, m, t, q, cfg),
            tuple)
        wires[name] = {**timed(err, ms, pms, bounds.planar_frontend(
            p.shape[0], p.shape[2], *nb)), "n_valid": n_valid}
        log(f"phase 3: planar_frontend {name}: bit-exact, {n_valid} valid "
            f"lanes of {p.shape[0]} x {p.shape[2]}, {ms:.4f} ms")
    return {**wires["f32-f32-count"], "wires": wires}


def record_batch(torch, clouds, N, dev):
    """The record wire of K ``(CloudFrame, pose)`` records, as
    ``FusionSession`` uploads it: a (K, N * point_step) u8 batch holding
    each frame's records from the start of its row, the (K,6) i32 frame
    table and the (K,4,4) poses, on ``dev``."""
    from hifi_fusion_tpu_torch.runtime.decode import record_fields
    rows = [record_fields(f) for f, _ in clouds]
    rec = torch.zeros((len(clouds), N * max(r[1] for r in rows)),
                      dtype=torch.uint8)
    table = np.asarray([[min(n, N), *rest] for n, *rest in rows], np.int32)
    for k, (f, _) in enumerate(clouds):
        nb = int(table[k, 0] * table[k, 1])
        rec[k, :nb] = torch.from_numpy(np.frombuffer(f.data, np.uint8,
                                                     count=nb).copy())
    poses = np.stack([p for _, p in clouds]).astype(np.float32)
    return rec.to(dev), torch.from_numpy(table).to(dev), \
        torch.from_numpy(poses).to(dev)


def check_record_frontend(torch, cfg, clouds, dev) -> dict:
    """Phase 3, K5's record wire on the first K=8 frames' records: bit-
    exact against its plain version and against K5's f32 wire on the same
    frames decoded on the host (``record_wire``), timed with the bound of
    a lane's 16 record bytes as 12 of points and 4 of packed colour."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.ops import integrate
    N = cfg.max_points
    rec, table, poses = record_batch(torch, clouds[:8], N, dev)
    got = integrate.record_frontend(rec, table, poses, cfg)
    plain = integrate.record_frontend_plain(rec, table, poses, cfg)
    host = integrate.planar_frontend(*record_wire(torch, clouds[:8], N, dev),
                                     cfg)
    err = max_err(zip(got, plain))
    for name, want in (("plain", plain), ("host decode", host)):
        if not all(bits_equal(torch, g, w) for g, w in zip(got, want)):
            raise AssertionError(f"record_frontend differs from the "
                                 f"{name}: {max_err(zip(got, want))}")
    n_valid = int((got[1] != integrate.INVALID_ID).sum())
    del got, plain, host
    ms, pms = time_pair(
        torch, lambda: integrate.record_frontend(rec, table, poses, cfg),
        lambda: integrate.record_frontend_plain(rec, table, poses, cfg),
        tuple)
    out = {**timed(err, ms, pms, bounds.planar_frontend(8, N, 12, 4, 0)),
           "n_valid": n_valid}
    log(f"phase 3: record_frontend: bit-exact against the plain version "
        f"and the host decode's f32 wire, {n_valid} valid lanes of 8 x {N}, "
        f"{ms:.4f} ms (bound {out['bound_ms']:.4f}, share "
        f"{out['share']:.3f})")
    return out


def segscan_yardstick(torch, scatter, tsdf, sid, svals, starts) -> float:
    """ms of ``torch.segment_reduce`` summing the valid sorted lanes of a
    batch into one row per segment, the totals the TSDF path reads at the
    end lanes; checked against T1's end lanes at rtol 1e-5 of the terms'
    magnitudes (it adds in another order).  The transpose is made outside
    the timed window."""
    valid = sid != tsdf.BIG
    nv = int(valid.sum())
    first = torch.nonzero(starts).squeeze(1)
    lengths = torch.diff(first, append=first.new_full((1,), nv))
    data = svals[:, :nv].t().contiguous()
    got = torch.segment_reduce(data, "sum", lengths=lengths, axis=0)
    mag = torch.segment_reduce(data.abs(), "sum", lengths=lengths, axis=0)
    ends = scatter.segment_ends(sid, valid)
    want = scatter.segment_reduce(svals, starts, "add")[:, ends].t()
    err = float(((got - want).abs() - 1e-5 * mag).max())
    if got.shape != want.shape or err > 0:
        raise AssertionError(f"segment_reduce yardstick differs from T1: "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"excess {err}")
    return device_ms(torch, lambda: torch.segment_reduce(
        data, "sum", lengths=lengths, axis=0), tuple, reps=2 * REPS)


def replay(torch, cfg, frames, rays_np, device, out_dir, fill_wait=10.0,
           clouds=None, state_path=None, variants=(), probe=None,
           **session_kw):
    """A session replay of the depth ``frames`` (or, given ``clouds``,
    ``push_frame`` of those ``(CloudFrame, pose)`` pairs), a ``save_state``
    to ``state_path`` when given, then ``process(variants=variants)``:
    ``(result, replay s, process s, metrics)``, the metrics read before
    ``process()`` with the stage timers read after it, and under
    ``probe`` what ``probe(session)`` returned before it."""
    from hifi_fusion_tpu_torch.runtime.session import FusionSession
    with FusionSession(cfg, device, output_dir=out_dir,
                       batch_fill_wait=fill_wait, **session_kw) as s:
        s.start()
        t0 = time.monotonic()
        if clouds is None:
            for f in frames:
                s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                   rays=rays_np)
        else:
            for frame, pose in clouds:
                s.push_frame(frame, pose)
        if not s.drain(900):
            raise AssertionError("session did not drain")
        dt = time.monotonic() - t0
        m = s.metrics()
        if probe is not None:
            m["probe"] = probe(s)
        if state_path is not None:
            t1 = time.monotonic()
            s.save_state(state_path)
            log(f"save_state: {time.monotonic() - t1:.3f} s")
        t1 = time.monotonic()
        r = s.process(variants=variants)
        t_proc = time.monotonic() - t1
        m["stage_timers"] = s.timers.report()
    if m["frames_integrated"] != len(frames) or m["dispatch_errors"]:
        raise AssertionError(f"session integrated "
                             f"{m['frames_integrated']}/{len(frames)} "
                             f"frames, {m['dispatch_errors']} errors")
    return r, dt, t_proc, m


def sync_reads(torch, cfg, frames, rays_np) -> tuple:
    """The synchronizing calls of one K=8 integrate dispatch, run under
    ``torch.cuda.set_sync_debug_mode("error")`` (any raises), and of the
    refine after it, run under ``"warn"`` and counted: ``(0, n)``; raises
    unless n is 1 (the refine's one read of its counts).  The inputs are
    put on the card first, as the session does before it dispatches."""
    import warnings
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    pipe = FusionPipeline(cfg, "cuda")
    fs = frames[:8]
    b = (pipe.put(np.stack([f.depth_q for f in fs])),
         pipe.put(np.stack([f.rgb565 for f in fs])),
         pipe.put(np.full((8,), fs[0].count, np.int32)),
         pipe.put(np.stack([f.pose for f in fs])), pipe.put(rays_np))
    grid = pipe.init()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step_batch_depth(grid, *b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe.refine(grid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchronizing" in str(w.message)]
    if len(syncs) != 1 or int(grid.normal_found.sum()) == 0:
        raise AssertionError(f"the refine made {len(syncs)} synchronizing "
                             f"calls: {syncs}")
    return 0, len(syncs)


def pipeline_api(torch, cfg, frames, rays, dev) -> dict:
    """Phase 4, the pipeline's other entry points on the card:
    ``FusionPipeline.run_sweep`` over the first 16 frames on the session's
    planar wire (each frame's valid pixels as a count prefix) against the
    same frames through ``step`` (the grids by cell id, the extracts'
    cells and counts exactly); ``extract_fetcher`` in two waves (the
    CSV's fields, then the PCD's and the rest) against ``extract_host`` on
    the fusion replay's final grid (``fusion_final_grid``), every field
    bit for bit.  Raises on a difference; returns the counts."""
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    pipe = FusionPipeline(cfg, dev)
    fs = frames[:16]
    F, N = len(fs), fs[0].depth_q.shape[0]
    pts = np.zeros((F, 3, N), np.float32)
    rgb = np.zeros((F, 3, N), np.float32)
    counts = np.zeros((F,), np.int32)
    for k, f in enumerate(fs):
        keep = f.depth_q > 0
        n = counts[k] = int(keep.sum())
        pts[k, :, :n] = f.points_f32[:, keep]
        rgb[k, :, :n] = rgb8(f.rgb565[keep]).T
    wire = [pipe.put(a) for a in (pts, rgb, counts,
                                  np.stack([f.pose for f in fs]))]
    sweep = pipe.run_sweep(pipe.init(), *wire)
    steps = pipe.init()
    for k in range(F):
        steps = pipe.step(steps, *(a[k] for a in wire))
    problems = grid_problems(cfg, sweep, steps)
    a, b = pipe.extract_host(sweep), pipe.extract_host(steps)
    if not (np.array_equal(a["cell"], b["cell"])
            and np.array_equal(a["count"], b["count"])):
        problems.append("extract cells or counts differ")
    if problems or int(sweep.frames) != F:
        raise AssertionError(f"run_sweep against step: {problems}")
    grid = fusion_final_grid(cfg, frames, rays, dev)
    fetch = pipe.extract_fetcher(grid)
    waves = {**fetch(CSV_WAVE), **fetch(PCD_WAVE)}
    whole = pipe.extract_host(grid)
    bad = [f for f in whole if waves[f].tobytes() != whole[f].tobytes()]
    if bad or set(waves) != set(whole) or whole["cell"].size == 0:
        raise AssertionError(f"extract_fetcher against extract_host: {bad}")
    out = {"sweep_frames": F, "sweep_voxels": int(a["cell"].size),
           "sweep_hits": int(a["count"].sum()),
           "fetched_voxels": int(whole["cell"].size)}
    log(f"phase 4: run_sweep of {F} frames equals {F} steps (grid by cell, "
        f"extract cells and counts); extract_fetcher's two waves equal "
        f"extract_host on the replay's final grid: {json.dumps(out)}")
    return out


def busy_intervals(trace: dict) -> list:
    """Merged [start, end) microsecond intervals of the device's kernels,
    copies and fills in a ``torch.profiler`` chrome trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in trace.get("traceEvents", ())
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profiled_replay(torch, cfg, frames, rays_np, **session_kw) -> dict:
    """The depth replay (push to the end of ``drain()``; the fusion family
    unless ``session_kw`` names another model) under
    ``torch.profiler`` with CUDA activity: the window's host seconds, the
    seconds the card ran a kernel, a copy or a fill (the union of their
    spans), the busy share of the window and of the span from the first
    device event to the last, and the session's per-dispatch
    ``device_step`` and ``refine`` ms.  The profiler's own host cost
    lengthens the window, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile
    from hifi_fusion_tpu_torch.runtime.session import FusionSession
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        with FusionSession(cfg, "cuda", output_dir=tmp,
                           batch_fill_wait=10.0, **session_kw) as s:
            s.start()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.monotonic()
                for f in frames:
                    s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                       rays=rays_np)
                if not s.drain(900):
                    raise AssertionError("session did not drain")
                dt = time.monotonic() - t0
            timers = s.timers.report()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    spans = busy_intervals(trace)
    busy = sum(b - a for a, b in spans) / 1e6
    span = (spans[-1][1] - spans[0][0]) / 1e6 if spans else 0.0
    out = {"window_s": dt, "busy_s": busy, "n_spans": len(spans),
           "busy_share": busy / dt, "device_span_s": span,
           "busy_share_of_span": busy / span if span else 0.0}
    for stage in ("device_step", "refine"):
        t = timers.get(stage, {})
        out[f"{stage}_ms"] = (1e3 * t["total_s"] / t["count"]
                              if t.get("count") else None)
    return out


def check_outputs(r) -> int:
    """Zero overflow counters, unit normals, and a PCD and CSV that parse
    with the extracted voxel count; returns that count."""
    gm = r["grid_metrics"]
    bad = {k: v for k, v in gm.items() if k.startswith("overflow") and v}
    if bad:
        raise AssertionError(f"overflow counters fired: {bad}")
    n = r["n_points"]
    nrm = np.linalg.norm(r["host"]["normal"].astype(np.float64), axis=1)
    if n == 0 or np.abs(nrm - 1.0).max() > 1e-5:
        raise AssertionError(f"{n} voxels, normals off unit by "
                             f"{np.abs(nrm - 1.0).max(initial=0.0)}")
    from hifi_fusion_tpu_torch.io.pcd import read_pcd
    cols, n_pcd = read_pcd(r["cloud"])
    if n_pcd != n or len(cols) != 8 or any(
            c.shape != (n,) or not np.isfinite(c).all()
            for c in cols.values()):
        raise AssertionError(f"PCD: {n_pcd} points, fields {list(cols)}")
    csv = np.genfromtxt(r["metadata"], delimiter=",", skip_header=1,
                        ndmin=2)
    if csv.shape != (n, 7) or not np.isfinite(csv).all():
        raise AssertionError(f"CSV: shape {csv.shape}")
    return n


def path_launches(names) -> dict:
    """The launch counts of a main path's run; raises if one of its
    kernels never launched."""
    from hifi_fusion_tpu_torch import kernels
    counts = dict(kernels.LAUNCHES)
    missing = [k for k in names if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}")
    return counts


def planar_replay(torch, cfg, frames, clouds, depth_host, device,
                  card) -> None:
    """Phase 7: the depth ``frames`` as their PointCloud2 records
    (``clouds``) through ``push_frame``; raises unless the counters stay
    zero and the extract holds ``depth_host``'s cells with the same
    cylinder and point counts."""
    n_pts = sum(f.n_points for f, _ in clouds)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        r, dt, t_proc, m = replay(torch, cfg, frames, None, device, tmp,
                                  clouds=clouds)
        n = check_outputs(r)
    host = r["host"]
    bad = {k: m[k] for k in ("pose_failures", "frames_truncated",
                             "points_truncated") if m[k]}
    same = np.array_equal(depth_host["cell"], host["cell"])
    for f in ("count", "n_pts"):
        if same and not np.array_equal(depth_host[f], host[f]):
            bad[f] = int((depth_host[f] != host[f]).sum())
    if not same or bad:
        raise AssertionError(f"planar replay: {n} voxels against the depth "
                             f"replay's {depth_host['cell'].size}, same "
                             f"cells {same}, problems {bad}")
    px = len(frames) * frames[0].depth_q.size
    log(f"phase 7: planar replay of {len(frames)} PointCloud2 frames "
        f"({n_pts} points) in {dt:.3f} s "
        f"= {px / dt / 1e6:.3f} Mpts/s of pixels, {n_pts / dt / 1e6:.3f} "
        f"Mpts/s of points ({card}); host decode {m['decode_s']:.3f} s; "
        f"process() {t_proc:.3f} s; {n} voxels, the depth replay's cells, "
        f"cylinder and point counts; {json.dumps(r['grid_metrics'])}")
    log(f"phase 7: stage timers {json.dumps(m['stage_timers'])}")
    if m["cloud_frames_card_decoded"] != len(clouds):
        raise AssertionError(f"planar replay: {m['cloud_frames_card_decoded']}"
                             f" of {len(clouds)} frames decoded on the card")
    decode_s, upload_s = (m["stage_timers"][k]["total_s"]
                          for k in ("decode", "device_step.upload"))
    log(f"phase 7: every frame decoded on the card (K5's record wire); the "
        f"host's layout check {1e3 * decode_s / len(clouds):.3f} ms a "
        f"frame, the records' upload {1e3 * upload_s / len(clouds):.3f} ms "
        f"a frame")


def check_variants(r, cfg) -> dict:
    """Each export variant of ``process()`` parses as a PCD with the rows
    of its ``io/downloads`` view; returns {variant: rows}."""
    from hifi_fusion_tpu_torch.io import downloads
    from hifi_fusion_tpu_torch.io.pcd import read_pcd
    host = r["host"]
    want = {"hq": (downloads.download_hq(host, cfg), 8),
            "classified": (downloads.download_classified(host, cfg), 4),
            "xyzrgb": (downloads.download_xyz(host), 4),
            "normals": (downloads.download_with_normals(host), 8)}
    rows = {}
    for v, (view, k) in want.items():
        cols, n = read_pcd(r["variants"][v])
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
        if n != view["xyz"].shape[0] or len(cols) != k or not np.allclose(
                xyz, view["xyz"], rtol=0.0, atol=1e-6):
            raise AssertionError(f"variant {v}: {n} rows, {len(cols)} "
                                 f"fields, view {view['xyz'].shape}")
        rows[v] = n
    return rows


def state_round_trip(torch, cfg, rays_np, state_path, depth_host, device,
                     card) -> None:
    """Phase 8: a fresh session warms, loads ``state_path`` and exports a
    PLY that must hold ``depth_host``'s cells, counts and centroids."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.io.ply import read_ply
    from hifi_fusion_tpu_torch.runtime.session import FusionSession
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            FusionSession(cfg, device, output_dir=tmp,
                          batch_fill_wait=10.0) as s:
        t_warm = s.warm(rays_np, extract=True, depth=True)
        kernels.reset_launches()
        t0 = time.monotonic()
        s.load_state(state_path)
        t_load = time.monotonic() - t0
        t0 = time.monotonic()
        r = s.process("cloud.ply")
        t_proc = time.monotonic() - t0
        ply = read_ply(r["cloud"])
        timers = s.timers.report()
    host = r["host"]
    n = depth_host["cell"].size
    same = (np.array_equal(host["cell"], depth_host["cell"])
            and np.array_equal(host["count"], depth_host["count"]))
    err = (float(np.abs(ply["xyz"] - depth_host["centroid"]).max())
           if ply["xyz"].shape == depth_host["centroid"].shape
           else float("inf"))
    if not same or r["n_points"] != n or err > 1e-6:
        raise AssertionError(f"state round trip: {r['n_points']} voxels "
                             f"against {n}, same cells and counts {same}, "
                             f"PLY centroid error {err}")
    log(f"phase 8: warm() {t_warm:.3f} s, load_state {t_load:.3f} s, "
        f"process('cloud.ply') {t_proc:.3f} s ({card}); {n} voxels, phase "
        f"4's cells and counts, PLY centroids within {err:.3g} m; launches "
        f"after warm {dict(kernels.LAUNCHES)}; stage timers "
        f"{json.dumps(timers)}")


def face_floors(f, cfg) -> tuple:
    """The depth frame's face points: the pixels whose world point the
    card and the C++ oracle floor to different cells, and both cells.
    The card (as the JAX package's compiled programs) floors ``(p -
    origin) * inv_res``, the folded f32 reciprocal; the oracle floors
    ``(p - origin) / res``, so a point within an ulp of a cell face may
    land in the neighbouring cell.  Only points both sides keep count
    (camera-z clip, bbox, either cell in the grid).  Returns ``((N,) bool,
    (M,3) card cells, (M,3) oracle cells)``."""
    from hifi_fusion_tpu_torch.ops.geometry import inv_resolution
    pc, T = f.points_f32, f.pose
    p = np.stack([((T[r, 0] * pc[0] + T[r, 1] * pc[1]) + T[r, 2] * pc[2])
                  + T[r, 3] for r in range(3)])
    zmin, zmax = cfg.z_clip
    face = (f.depth_q > 0) & (pc[2] > np.float32(zmin)) \
        & (pc[2] < np.float32(zmax))
    b = np.asarray(cfg.bbox, np.float64)
    for a in range(3):
        face &= (p[a] > b[2 * a]) & (p[a] < b[2 * a + 1])
    d = p - np.asarray(cfg.origin, np.float32)[:, None]
    card = np.floor(d * inv_resolution(cfg)[:, None]).astype(np.int64)
    orc = np.floor(d / np.asarray(cfg.resolution, np.float32)[:, None]
                   ).astype(np.int64)
    dims = np.asarray(cfg.dims)[:, None]
    inside = ((card >= 0) & (card < dims)) | ((orc >= 0) & (orc < dims))
    face &= inside.all(axis=0) & (card != orc).any(axis=0)
    return face, card[:, face].T, orc[:, face].T


def face_cells(frames, cfg) -> np.ndarray:
    """(2M, 3) int64: both cells of every face point of the sweep."""
    out = [np.zeros((0, 3), np.int64)]
    for f in frames:
        out.extend(face_floors(f, cfg)[1:])
    return np.concatenate(out)


def blank_faces(frames, cfg) -> list:
    """The depth frames with their face points' pixels at depth 0, so
    that the card and the oracle floor every remaining point alike."""
    out = []
    for f in frames:
        face = face_floors(f, cfg)[0]
        dq = f.depth_q.copy()
        dq[face] = 0
        pf = f.points_f32.copy()
        pf[:, face] = 0.0
        out.append(dataclasses.replace(f, depth_q=dq, points_f32=pf))
    return out


def near_faces(cell, faces, cfg) -> np.ndarray:
    """(n,) bool: which of the dense cell ids ``cell`` lie within
    Chebyshev distance ``line_k + 1`` of a face point's cell, the reach of
    a point's hits (its cell's dependant owners)."""
    _, dy, dz = cfg.dims
    c = np.asarray(cell, np.int64)
    coords = np.stack([c // (dy * dz), (c // dz) % dy, c % dz], axis=1)
    r = cfg.line_k + 1
    span = np.arange(-r, r + 1)
    box = np.stack(np.meshgrid(span, span, span, indexing="ij"),
                   axis=-1).reshape(-1, 3)
    near = np.unique(np.ravel_multi_index(
        (faces[:, None, :] + box[None] + r).reshape(-1, 3).T,
        (1 << 20,) * 3))
    return np.isin(np.ravel_multi_index((coords + r).T, (1 << 20,) * 3),
                   near)


def oracle_sweep(cfg, frames, depth_host, card, phase=9) -> tuple:
    """Phase 9 (and 15): the sweep's camera points through the C++ oracle
    at the session's cadence, its extract held to ``depth_host`` under the
    benchmark's structural gates and a unit-normal agreement gate;
    returns ``(problems, info)``: the dense cell ids whose counts differ
    (``flips``), how many of them lie near a face point (``near``), the
    face points, the common voxels and the total hits of each side."""
    from hifi_fusion_tpu_torch import checks
    from hifi_fusion_tpu_torch.models.pipeline import refine_due
    from hifi_fusion_tpu_torch.oracle.native import NativeOracle
    from hifi_fusion_tpu_torch.runtime.session import batch_frames
    pts = [camera_points(f) for f in frames]
    k = batch_frames(cfg)
    cc = NativeOracle(cfg)
    t0 = time.monotonic()
    for i, f in enumerate(frames):
        cc.integrate_frame(pts[i], None, f.pose)
        done = i + 1
        if done % k == 0 and refine_due(done, k, cfg):
            cc.refine()
    if not refine_due(len(frames), 1, cfg):
        cc.refine()
    dt = time.monotonic() - t0
    orc = cc.extract(cap=1 << 22)
    problems = checks.parity_gates(depth_host, orc, len(frames))
    common, ia, ib = np.intersect1d(depth_host["cell"], orc["cell"],
                                    return_indices=True)
    dots = np.sum(depth_host["normal"][ia].astype(np.float64)
                  * orc["normal"][ib], axis=1)
    nfrac = float(np.mean(dots <= 0.999)) if common.size else 1.0
    if nfrac > 1e-3:
        problems.append(f"normal mismatch on {nfrac:.2%} of voxels")
    ca = depth_host["count"][ia].astype(np.int64)
    cb = orc["count"][ib]
    faces = face_cells(frames, cfg)
    flips = common[ca != cb]
    info = {"flips": flips, "near": int(near_faces(flips, faces, cfg).sum()),
            "face_points": faces.shape[0] // 2, "common": int(common.size),
            "hits": (int(ca.sum()), int(cb.sum()))}
    px = len(frames) * frames[0].depth_q.size
    n_pts = sum(p.shape[0] for p in pts)
    log(f"phase {phase}: C++ oracle (single-threaded, refine every {k}-frame "
        f"batch holding a mark, reclaim {cfg.reclaim_buffer}): "
        f"{len(frames)} frames in {dt:.3f} s = {px / dt / 1e6:.3f} Mpts/s "
        f"of pixels, {n_pts / dt / 1e6:.3f} Mpts/s of points on this "
        f"host ({card}); oracle {orc['cell'].size} voxels, card "
        f"{depth_host['cell'].size}, common {common.size}, count "
        f"mismatches {flips.size} ({info['near']} within reach of the "
        f"{info['face_points']} face points), total hits {info['hits'][0]} vs "
        f"{info['hits'][1]}, normal mismatch share {nfrac:.6f}, "
        f"problems {problems}")
    return problems, info


def tsdf_card_vs_cpu(torch, scfg, srays, sframes) -> list:
    """Phase 5, TSDF: two K=4 batches of the reduced sweep through
    ``TsdfPipeline`` on the card and on the CPU; problems by cell id."""
    from hifi_fusion_tpu_torch import checks, convert
    from hifi_fusion_tpu_torch.models import tsdf
    tcfg = tsdf.TsdfConfig(base=scfg, truncation=0.011, n_samples=5,
                           min_weight=2.0)
    K = scfg.max_batch_frames
    fields, ext = {}, {}
    for dev in ("cuda", "cpu"):
        pipe = tsdf.TsdfPipeline(tcfg, dev)
        grid, rays = pipe.init(), pipe.put(srays)
        for i in range(2):
            fs = sframes[K * i:K * i + K]
            pipe.step_batch_depth(
                grid, pipe.put(np.stack([f.depth_q for f in fs])),
                pipe.put(np.stack([f.rgb565 for f in fs])),
                pipe.put(np.full((K,), fs[0].count, np.int32)),
                pipe.put(np.stack([f.pose for f in fs])), rays)
        fields[dev] = convert.tsdf_grid_to_numpy(grid, tcfg)
        ext[dev] = tsdf.tsdf_to_host(pipe.extract(grid))
    problems = checks.tsdf_grid_problems(fields["cuda"], fields["cpu"],
                                         scfg.capacity)
    problems += checks.tsdf_extract_problems(ext["cuda"], ext["cpu"])
    log(f"phase 5: tsdf card {ext['cuda']['cell'].size} surface cells, "
        f"cpu {ext['cpu']['cell'].size}, "
        f"{int((fields['cpu']['key'] >= 0).sum())} grid cells, "
        f"problems {problems}")
    if ext["cpu"]["cell"].size == 0:
        problems.append("no TSDF surface cells")
    return problems


def tsdf_planar_replay(torch, tcfg, frames, clouds, tsdf_host, dev,
                       card) -> dict:
    """Phase 10: the config-5 TSDF session takes the records through
    ``push_frame``; raises unless the counters stay zero and the surface
    holds ``tsdf_host``'s (phase 6's) cells and integer weights, tsdf
    within ``checks.TSDF_TOL``.  Returns the path's launches."""
    from hifi_fusion_tpu_torch import checks, kernels
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels.reset_launches()
        r, dt, t_proc, m = replay(torch, tcfg.base, frames, None, dev, tmp,
                                  clouds=clouds, model="tsdf",
                                  model_params=TSDF_PARAMS)
        launches = path_launches(TSDF_PLANAR_PATH)
        n = check_outputs(r)
    host = r["host"]
    bad = {k: m[k] for k in ("pose_failures", "frames_truncated",
                             "points_truncated") if m[k]}
    same = np.array_equal(host["cell"], tsdf_host["cell"])
    if same and not np.array_equal(host["count"], tsdf_host["count"]):
        bad["count"] = int((host["count"] != tsdf_host["count"]).sum())
    err = (float(np.abs(host["mean_dist"].astype(np.float64)
                        - tsdf_host["mean_dist"]).max()) if same else None)
    if not same or bad or err > checks.TSDF_TOL["tsdf"]:
        raise AssertionError(f"TSDF planar replay: {n} surface voxels "
                             f"against the depth replay's "
                             f"{tsdf_host['cell'].size}, same cells {same}, "
                             f"tsdf error {err}, problems {bad}")
    px = len(frames) * frames[0].depth_q.size
    log(f"phase 10: TSDF config 5, {len(frames)} PointCloud2 frames in "
        f"{dt:.3f} s = {px / dt / 1e6:.3f} Mpts/s of pixels ({card}); host "
        f"decode {m['decode_s']:.3f} s; process() {t_proc:.3f} s; {n} "
        f"surface voxels, phase 6's cells and weights, tsdf within "
        f"{err:.3g}; launches {launches}; {json.dumps(r['grid_metrics'])}")
    log(f"phase 10: stage timers {json.dumps(m['stage_timers'])}")
    n_sync = tsdf_sync_reads(torch, tcfg, frames, clouds, None, "planar")
    log(f"phase 10: synchronizing calls of a K=8 TSDF planar dispatch: "
        f"{n_sync} (under sync_debug_mode 'error')")
    return launches


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def host_ms(torch, dev, fn):
    """``(fn(), host ms)`` of one call that ends in a synchronize."""
    sync(torch, dev)
    t0 = time.monotonic()
    out = fn()
    sync(torch, dev)
    return out, (time.monotonic() - t0) * 1e3


def queries_phase(torch, cfg, frames, state_path, b11, dev, card) -> dict:
    """Phase 11: the three queries on phase 4's checkpoint; raises unless
    its occupied cells and their window counts are phase 3's (``b11``:
    ascending cells and B11's counts on the pipeline's final grid), the
    ROR mask keeps exactly the cells whose count less one reaches 5, and
    nearly every valid pixel of a frame lands in an occupied voxel.
    Returns the path's launches."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    from hifi_fusion_tpu_torch.ops import queries
    pipe = FusionPipeline(cfg, dev)
    with np.load(state_path) as z:
        grid = pipe.put_state({f: z[f] for f in z.files})
    occ = grid.n_pts > 0
    f = frames[0]
    world = (f.pose[:3, :3].astype(np.float64) @ f.points_f32
             + f.pose[:3, 3:]).astype(np.float32)
    pts = pipe.put(world)
    kernels.reset_launches()
    keep, ms_ror = host_ms(torch, dev, lambda: queries.radius_outlier_mask(
        grid, cfg, radius_cells=2, min_neighbors=5))
    slots = torch.nonzero(occ).squeeze(1).to(torch.int32)
    counts, ms_cnt = host_ms(torch, dev, lambda: (
        queries.occupied_neighbor_counts(grid, slots, cfg, radius_cells=2)))
    q, ms_q = host_ms(torch, dev, lambda: queries.query_points(grid, pts,
                                                               cfg))
    launches = path_launches(QUERY_PATH)
    cells = grid.key[slots.long()]
    order = torch.argsort(cells)
    same = (np.array_equal(cells[order].cpu().numpy(), b11[0])
            and np.array_equal(counts[order].cpu().numpy(), b11[1]))
    kept, n_occ = int(keep.sum()), int(occ.sum())
    want = int(((counts - 1) >= 5).sum())
    valid = pipe.put(f.depth_q > 0) & (q.slot >= 0)
    share = float(q.occupied[valid].float().mean())
    if not same or kept != want or bool((keep & ~occ).any()) \
            or share < 0.99 or int(q.count.sum()) <= 0:
        raise AssertionError(f"queries: phase 3's cells and counts {same}, "
                             f"kept {kept} (want {want}), occupied share of "
                             f"a frame's points {share}")
    log(f"phase 11: queries on phase 4's grid ({card}): "
        f"radius_outlier_mask (r=2, min_neighbors=5) keeps {kept} of "
        f"{n_occ} voxels, removes {n_occ - kept}, {ms_ror:.3f} ms; "
        f"occupied_neighbor_counts of {slots.numel()} occupied slots "
        f"{ms_cnt:.3f} ms (phase 3's counts by cell); query_points of "
        f"{pts.shape[1]} world points {ms_q:.3f} ms, {int(valid.sum())} in "
        f"the table, occupied share {share:.6f}, "
        f"{int(q.normal_found.sum())} with a normal; launches {launches}")
    return launches


def run_cli(cli, argv):
    """``cli.main(argv)`` with its stdout captured; its last line, as JSON
    where it parses."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    last = buf.getvalue().strip().splitlines()[-1]
    return json.loads(last) if last.startswith("{") else last


def same_cloud(a, b, what) -> int:
    """Two ``process()`` results (or ``cli fuse`` lines): the same PCD rows
    (positions and normals within 1e-6, colours equal) and the same CSV
    counts; returns the rows."""
    from hifi_fusion_tpu_torch.io.pcd import read_metadata_csv, read_pcd
    ca, na = read_pcd(a["cloud"])
    cb, nb = read_pcd(b["cloud"])
    counts = [read_metadata_csv(r["metadata"])["count"] for r in (a, b)]
    ok = na == nb > 0 and list(ca) == list(cb) and np.array_equal(*counts)
    for k in ca if ok else ():
        if k == "rgb":
            ok = ok and np.array_equal(ca[k].view(np.uint32),
                                       cb[k].view(np.uint32))
        else:
            ok = ok and np.allclose(ca[k], cb[k], rtol=0.0, atol=1e-6)
    if not ok:
        raise AssertionError(f"{what}: {na} rows against a direct "
                             f"session's {nb}, or other counts or rows")
    return na


def direct_session(cfg, dev, out, depth=(), rays=None, clouds=(), **kw):
    """A session on the card fed the ``(depth_q, rgb565, pose)`` frames
    ``depth``, then the ``(CloudFrame, pose)`` records ``clouds``, drained
    and ``process()``ed."""
    from hifi_fusion_tpu_torch.runtime.session import FusionSession
    with FusionSession(cfg, dev, output_dir=out, **kw) as s:
        s.start()
        for dq, r565, pose in depth:
            s.push_depth_frame(dq, r565, pose, rays=rays)
        for frame, pose in clouds:
            s.push_frame(frame, pose)
        if not s.drain(900):
            raise AssertionError("direct session did not drain")
        return s.process()


def write_capture(directory, clouds) -> None:
    """A capture directory: each record's decoded points and colour as a
    binary PCD, and a CSV trajectory of 16 matrix entries a row."""
    from hifi_fusion_tpu_torch.io.pcd import write_pcd_xyzrgb
    from hifi_fusion_tpu_torch.runtime.decode import decode_frame
    os.makedirs(directory)
    rows = []
    for i, (frame, pose) in enumerate(clouds):
        xyz, rgb = decode_frame(frame)
        write_pcd_xyzrgb(os.path.join(directory, f"frame_{i:04d}.pcd"),
                         xyz, rgb, ascii_mode=False)
        rows.append(",".join(repr(float(v)) for v in pose.reshape(-1)))
    with open(os.path.join(directory, "poses.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")


def cli_phase(torch, cfg, tcfg, frames, clouds, rays_np, dev, card) -> dict:
    """Phase 12: ``synth``, ``fuse`` (depth sweep, TSDF xyzrgb sweep,
    capture directory) and ``serve`` through ``runtime/cli.py`` on the
    card, each held to a direct session.  Returns the launches of the
    CLI's runs."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.runtime import cli
    from hifi_fusion_tpu_torch.runtime.sources import (load_depth_sweep,
                                                       load_sweep)
    n_px = WIDTH * HEIGHT
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        conf, tconf = os.path.join(tmp, "bench.json"), os.path.join(
            tmp, "tsdf.json")
        with open(conf, "w") as fh:
            json.dump(BENCH_FIELDS, fh)
        with open(tconf, "w") as fh:
            json.dump({**BENCH_FIELDS, **TSDF_FIELDS,
                       "tsdf": TSDF_PARAMS}, fh)
        dsweep, xsweep = (os.path.join(tmp, f"{w}.npz")
                          for w in ("depth", "xyzrgb"))
        t0 = time.monotonic()
        run_cli(cli, ["synth", "--wire", "depth", "--frames", "16",
                      "--points", str(n_px), "--width", str(WIDTH),
                      "--config", conf, "--output", dsweep])
        run_cli(cli, ["synth", "--wire", "xyzrgb", "--frames", "16",
                      "--points", str(n_px), "--config", tconf,
                      "--output", xsweep])
        t_synth = time.monotonic() - t0
        kernels.reset_launches()
        t0 = time.monotonic()
        fd = run_cli(cli, ["fuse", "--sweep", dsweep, "--config", conf,
                           "--device", dev,
                           "--output", os.path.join(tmp, "fd")])
        ft = run_cli(cli, ["fuse", "--sweep", xsweep, "--config", tconf,
                           "--model", "tsdf", "--device", dev,
                           "--output", os.path.join(tmp, "ft")])
        cap = os.path.join(tmp, "capture")
        write_capture(cap, clouds[:8])
        fc = run_cli(cli, ["fuse", "--sweep", cap, "--config", conf,
                           "--export-variants", "hq,normals",
                           "--device", dev,
                           "--output", os.path.join(tmp, "fc")])
        t_fuse = time.monotonic() - t0
        served, t_serve = serve_on_thread(cli, conf, tmp, frames[:16],
                                          clouds[16:20], rays_np, dev)
        launches = path_launches(CLI_PATH)
        dframes, drays = load_depth_sweep(dsweep)
        rows = {
            "fuse depth": same_cloud(fd, direct_session(
                cfg, dev, os.path.join(tmp, "dd"), depth=dframes, rays=drays,
                batch_fill_wait=10.0), "fuse depth"),
            "fuse tsdf": same_cloud(ft, direct_session(
                tcfg.base, dev, os.path.join(tmp, "dt"),
                batch_fill_wait=10.0,
                clouds=list(load_sweep(xsweep)), model="tsdf",
                model_params=TSDF_PARAMS), "fuse --model tsdf"),
            "fuse capture": same_cloud(fc, direct_session(
                cfg, dev, os.path.join(tmp, "dc"), batch_fill_wait=10.0,
                clouds=clouds[:8]), "fuse capture"),
            "serve": same_cloud(served, direct_session(
                cfg, dev, os.path.join(tmp, "ds"), rays=rays_np,
                depth=[(f.depth_q, f.rgb565, f.pose) for f in frames[:16]],
                clouds=clouds[16:20]), "serve"),
        }
        from hifi_fusion_tpu_torch.io.pcd import read_pcd
        variants = {v: read_pcd(p)[1] for v, p in fc["variants"].items()}
    if set(variants) != {"hq", "normals"} or not variants["normals"]:
        raise AssertionError(f"fuse capture variants {variants}")
    log(f"phase 12: cli on the card ({card}): synth of two 16-frame "
        f"{WIDTH}x{HEIGHT} sweeps {t_synth:.3f} s; fuse depth, fuse "
        f"--model tsdf and fuse of a capture directory {t_fuse:.3f} s; serve "
        f"{t_serve:.3f} s; rows held to direct sessions {rows}; capture "
        f"variant rows {variants}; fuse depth spans {fd['spans']}; "
        f"launches {launches}")
    return launches


def serve_on_thread(cli, conf, tmp, depth, clouds, rays_np, dev):
    """``cmd_serve`` (``--port 0 --warm --live-batching``) on a thread; a
    client with socket timeouts sends rays, the depth frames as
    ``depth_frame``s, the records as ``frame``s, ``metrics``, ``process``
    and ``shutdown``.  Returns the ``process`` reply and the seconds from
    the server's start to its thread's end."""
    import queue
    import socket
    import threading
    args = cli.parse_args(["serve", "--port", "0", "--config", conf,
                           "--device", dev,
                           "--output", os.path.join(tmp, "serve"),
                           "--warm", "--live-batching"])
    ready = queue.Queue()
    t0 = time.monotonic()
    t = threading.Thread(target=cli.cmd_serve, args=(args, ready.put),
                         daemon=True, name="serve")
    t.start()
    server = ready.get(timeout=600)

    def send(sock, obj, blob=b""):
        sock.sendall((json.dumps(obj) + "\n").encode() + blob)

    try:
        with socket.create_connection(server.server_address[:2],
                                      timeout=300) as sock, \
                sock.makefile("rb") as rf:
            def reply():
                r = json.loads(rf.readline())
                if not r.get("ok"):
                    raise AssertionError(f"serve replied {r}")
                return r

            send(sock, {"cmd": "start"})
            reply()
            send(sock, {"cmd": "rays", "n": rays_np.shape[1]},
                 rays_np.astype("<f4").tobytes())
            reply()
            for f in depth:
                send(sock, {"cmd": "depth_frame", "n": f.depth_q.size,
                            "pose": f.pose.reshape(-1).tolist()},
                     f.depth_q.astype("<u2").tobytes()
                     + f.rgb565.astype("<u2").tobytes())
                if not reply()["accepted"]:
                    raise AssertionError("depth_frame not accepted")
            for frame, pose in clouds:
                send(sock, {"cmd": "frame", "n": frame.width,
                            "pose": pose.reshape(-1).tolist()}, frame.data)
                if not reply()["accepted"]:
                    raise AssertionError("frame not accepted")
            send(sock, {"cmd": "metrics"})
            m = reply()["metrics"]
            if m["frames_received"] != len(depth) + len(clouds):
                raise AssertionError(f"serve received {m}")
            send(sock, {"cmd": "process"})
            out = reply()
            send(sock, {"cmd": "shutdown"})
            reply()
    finally:
        server.shutdown()
        t.join(timeout=300)
    if t.is_alive():
        raise AssertionError("serve thread did not end")
    return out, time.monotonic() - t0


def live_phase(torch, cfg, frames, rays_np, depth_host, dev, card) -> dict:
    """Phase 13: a ``warm()``ed ``live_batching`` session takes the sweep
    through ``push_depth_frame`` at 30 Hz; raises on a dropped frame or an
    extract other than ``depth_host``'s cells and counts.  Returns the
    path's launches."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.runtime.session import (FusionSession,
                                                       batch_frames)
    period = 1.0 / 30.0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, \
            FusionSession(cfg, dev, live_batching=True,
                          output_dir=tmp) as s:
        t_warm = s.warm(rays_np, extract=True, depth=True)
        kernels.reset_launches()
        s.start()
        t0 = time.monotonic()
        for i, f in enumerate(frames):
            time.sleep(max(t0 + i * period - time.monotonic(), 0.0))
            s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=rays_np)
        t_last = time.monotonic()
        if not s.drain(900):
            raise AssertionError("live session did not drain")
        lag = time.monotonic() - t_last
        m = s.metrics()
        r = s.process()
        launches = path_launches(FUSION_PATH)
    host = r["host"]
    same = all(np.array_equal(host[k], depth_host[k])
               for k in ("cell", "count", "n_pts"))
    if m["frames_dropped_backpressure"] or m["frames_integrated"] != len(
            frames) or not same:
        raise AssertionError(f"live session: {m['frames_integrated']} "
                             f"frames, {m['frames_dropped_backpressure']} "
                             f"dropped, phase 4's cells and counts {same}")
    K = batch_frames(cfg)
    steps = m["stage_timers"]["device_step"]
    batched = (len(frames) - steps["count"]) // (K - 1)
    log(f"phase 13: live session at 30 Hz ({card}): warm() {t_warm:.3f} s; "
        f"{len(frames)} frames over {t_last - t0:.3f} s, 0 dropped; lag "
        f"from the last arrival to the end of drain() {lag:.4f} s; "
        f"{steps['count']} dispatches, {batched} of them K={K} batches; "
        f"device_step mean {steps['mean_ms']} ms; {r['n_points']} voxels, "
        f"phase 4's cells and counts; launches {launches}")
    log(f"phase 13: stage timers {json.dumps(m['stage_timers'])}")
    return launches


def flagship_config(FusionConfig):
    """The bench config over the launch-file extent, unvalidated: one grid
    cannot hold it (``validate()`` raises), 8 shards can."""
    return FusionConfig(**{**BENCH_FIELDS, "bbox": FLAGSHIP_BBOX})


def check_route_pack(torch, cfg, frames, flag_cfg, flag_frames, rays_np,
                     dev) -> dict:
    """Phase 3, B12: bit-exact against its plain pair (world, rgb and
    present in the destinations' layout, budget, drops, largest bucket),
    its device ms split by pass, and timed with its bound on the third K=8
    batch at phase 14's shape (the bench config, 4 shards, the default
    tiers) on the depth wire and the session's planar wire (f32 points and
    colour, count prefixes), and at phase 15's (the launch-file extent, 8
    shards) on the depth wire.  The entry is the depth wire at phase 14's shape,
    every shape's under ``shapes``."""
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.parallel import routing
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rays = put(rays_np)
    shapes = {}
    for name, c, fr, n, wire in (("depth_n4", cfg, frames, 4, "depth"),
                                 ("planar_n4", cfg, frames, 4, "planar"),
                                 ("depth_n8_flagship", flag_cfg,
                                  flag_frames, 8, "depth")):
        sf = ShardedFusion(c, [dev] * n, route=True)
        args = (c, n, sf.slab_w, sf.halo, sf.send_lanes_tiers)
        fs = fr[16:24]
        K, N = len(fs), fs[0].depth_q.shape[0]
        if wire == "depth":
            b = (put(np.stack([f.depth_q for f in fs])),
                 put(np.stack([f.rgb565 for f in fs])),
                 put(np.full((K,), fs[0].count, np.int32)),
                 put(np.stack([f.pose for f in fs])))

            def kern(b=b, args=args, marks=None):
                return routing.route_pack_depth(*b, rays, *args,
                                                marks=marks)

            def plain(b=b, args=args):
                return routing.route_pack_plain(
                    *routing.depth_lanes(*b[:3], rays), b[3], *args)
            mask_bytes = 0
        else:
            p, col, cnt, t, _, _ = planar_wires(torch, fs, dev)[
                "f32-f32-count"]
            lanes = (torch.arange(N, device=dev)[None, :] < cnt[:, None])

            def kern(p=p, col=col, cnt=cnt, t=t, args=args, marks=None):
                return routing.route_pack(p, col, cnt, t, *args,
                                          marks=marks)

            def plain(p=p, col=col, lanes=lanes, t=t, args=args):
                return routing.route_pack_plain(p, col, lanes, t, *args)
            mask_bytes = 0
        got, want = kern(), plain()
        same = {"world": bits_equal(torch, got.world, want.world),
                "rgb": bits_equal(torch, got.rgb, want.rgb),
                "present": torch.equal(got.present, want.present)}
        if not all(same.values()) or got[3:] != want[3:]:
            raise AssertionError(f"route_pack {name}: kernel (Bs, drops, "
                                 f"max bucket) {got[3:]}, plain {want[3:]}, "
                                 f"equal {same}")
        Bs, dropped, mx = got[3:]
        n_sent = int(got.present.sum())
        del got, want
        ms, pms = time_pair(torch, kern, plain, tuple)
        passes = route_pack_passes(torch, kern)
        shapes[name] = {**timed(0.0, ms, pms, bounds.route_pack(
            K, N, n, Bs, wire, mask_bytes)), "n": n, "Bs": Bs,
            "tiers": list(sf.send_lanes_tiers), "max_bucket": mx,
            "dropped": dropped, "sent": n_sent, "passes_ms": passes}
        log(f"phase 3: route_pack {name}: bit-exact (world, rgb, present), "
            f"K {K} x {N} lanes, {n} shards, tiers {sf.send_lanes_tiers}, "
            f"max bucket {mx} -> Bs {Bs}, {n_sent} lanes sent, {dropped} "
            f"dropped; {ms:.4f} ms, plain {pms:.4f} ms; passes (ms) "
            f"{json.dumps(passes)}")
        torch.cuda.empty_cache()
    return {**shapes["depth_n4"], "shapes": shapes}


def route_pack_passes(torch, kern) -> dict:
    """B12's device ms by pass, medians of ``REPS`` calls of ``kern(marks)``
    (a separate call from the timed ones, events at each pass boundary):
    count, scan and budget with the budget's copy to the host; pack, any
    idle time before it included (the host no longer waits between the
    two); fill."""
    names = ("count_scan", "pack", "fill")
    times = {k: [] for k in names}
    for _ in range(REPS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        kern(marks=marks)
        torch.cuda.synchronize()
        for k, a, b in zip(names, marks, marks[1:]):
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def shard_counts(cell, cfg, slab_w, n) -> list:
    """Core voxels a shard of the global extract's int64 ``cell`` ids."""
    _, dy, dz = cfg.dims
    x = np.asarray(cell, np.int64) // (np.int64(dy) * np.int64(dz))
    return np.bincount(np.minimum(x // slab_w, n - 1),
                       minlength=n).tolist()


def routing_probe(s) -> dict:
    """The sharded session's routed budgets and loads."""
    sf = s.pipeline
    return {"tier_dispatches": {str(k): v for k, v in
                                sorted(sf.tier_counts.items())},
            "tiers": list(getattr(sf, "send_lanes_tiers", ())),
            "max_bucket": sf.max_bucket,
            "max_receive_lanes": sf.n * max(sf.tier_counts, default=0),
            "slab_w": sf.slab_w, "halo": sf.halo}


def sharded_phase(torch, cfg, frames, rays_np, depth_host, dev,
                  card) -> list:
    """Phase 14: the bench sweep through ``FusionSession(n_devices=4)`` on
    the one card, routed (B12) then replicated (K1 per shard); raises
    unless each run has zero overflow counters, reports 4 devices and
    holds phase 4's extract under ``checks.parity_gates``.  Returns both
    runs' launches."""
    from hifi_fusion_tpu_torch import checks, kernels
    out = []
    for route, path in ((True, ROUTED_PATH), (False, FUSION_PATH)):
        tag = "routed" if route else "replicated"
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            kernels.reset_launches()
            r, dt, t_proc, m = replay(torch, cfg, frames, rays_np, dev,
                                      tmp, n_devices=4, route=route,
                                      probe=routing_probe)
            launches = path_launches(path)
            n = check_outputs(r)
        gm = r["grid_metrics"]
        problems = checks.parity_gates(r["host"], depth_host, len(frames))
        if gm["devices"] != 4 or m["devices"] != 4:
            problems.append(f"devices {gm['devices']}")
        if problems:
            raise AssertionError(f"phase 14 {tag}: {problems}")
        pr = m["probe"]
        mpts = len(frames) * WIDTH * HEIGHT / dt / 1e6
        log(f"phase 14: {tag}, 4 shards on one card ({card}): "
            f"{len(frames)} frames in {dt:.3f} s = {mpts:.3f} Mpts/s; "
            f"process() {t_proc:.3f} s; {n} voxels, against phase 4's "
            f"{same_voxels(r['host'], cfg, depth_host, cfg)}; per shard "
            f"{shard_counts(r['host']['cell'], cfg, pr['slab_w'], 4)}; "
            f"routing {json.dumps(pr)}; launches {launches}; "
            f"{json.dumps(gm)}")
        log(f"phase 14: {tag} stage timers {json.dumps(m['stage_timers'])}")
        out.append(launches)
    return out


def grid_bytes(cfg) -> int:
    """The device bytes of one grid of ``cfg`` (grid.make_grid)."""
    C, B, D = cfg.capacity, cfg.buffer_capacity, cfg.max_dependants
    # key, normal_found, normal, cyl_stats, viewpoint, rgb_sum, n_pts,
    # dep, dep_count; buf_pts, buf_slot; the occupancy bitmap
    return (C * (4 + 1 + 12 + 20 + 12 + 12 + 4 + 4 * D + 4) + B * 16
            + cfg.n_occ_words * 4)


def same_voxels(a, a_cfg, b, b_cfg) -> dict:
    """Two extracts of grids with one lower corner compared by cell
    coordinates: cells in one only, count and point-count mismatches,
    and the largest centroid and normal differences."""
    def coords(cell, cfg):
        _, dy, dz = cfg.dims
        c = np.asarray(cell, np.int64)
        return c // (dy * dz), (c // dz) % dy, c % dz

    ka, kb = (np.ravel_multi_index(coords(h["cell"], c), (1 << 20,) * 3)
              for h, c in ((a, a_cfg), (b, b_cfg)))
    common, ia, ib = np.intersect1d(ka, kb, return_indices=True)
    return {"cells": int(ka.size + kb.size - 2 * common.size),
            "count": int((a["count"][ia] != b["count"][ib]).sum()),
            "n_pts": int((a["n_pts"][ia] != b["n_pts"][ib]).sum()),
            "centroid": float(np.abs(a["centroid"][ia]
                                     - b["centroid"][ib]).max(initial=0)),
            "normal": float(np.abs(a["normal"][ia]
                                   - b["normal"][ib]).max(initial=0))}


def memory_stages(torch, flag_cfg, flag_frames, rays_np, dev) -> dict:
    """Phase 15's device memory by stage, on 8 routed shards driven
    directly: the bytes ``init()`` allocates, and the peak above them
    while the first K=8 depth batch is dispatched (B12, the exchange and
    each shard's integrate), while it is refined and while it is
    extracted to the host."""
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
    sf = ShardedFusion(flag_cfg, [dev] * 8, route=True)
    fs = flag_frames[:8]
    dq, r565, cnt, poses = (sf.put(np.stack(a)) for a in (
        [f.depth_q for f in fs], [f.rgb565 for f in fs],
        [np.int32(f.count) for f in fs], [f.pose for f in fs]))
    rays = sf.put_rays(rays_np)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    g = sf.init()
    torch.cuda.synchronize()
    out = {"grids": torch.cuda.memory_allocated() - base}
    for name, fn in (
            ("dispatch", lambda: sf.step_batch_depth(g, dq, r565, cnt,
                                                     poses, rays)),
            ("refine", lambda: sf.refine(g)),
            ("extract", lambda: sf.extract_host(g))):
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[name] = (torch.cuda.max_memory_allocated() - base
                     - out["grids"])
    out["tier"] = list(sf.tier_counts)
    del g, sf
    torch.cuda.empty_cache()
    return out


def flagship_phase(torch, flag_cfg, flag_frames, rays_np, dev,
                   card) -> dict:
    """Phase 15: the launch-file extent, which ``validate()`` refuses for
    one grid, on 8 routed shards of the one card: the sweep through the
    session and ``process()`` with zero overflow counters, held exactly to
    one grid of the same lower corner cut to the surface's reach (the same
    cells, counts and point counts), and to the C++ oracle (int64 cell
    keys).  Against the oracle the cell, total-hit and normal gates hold
    as in phase 9, all count flips stay under 2% of the voxels, and those
    out of reach of every face point (``face_floors``: the one arithmetic
    difference between the card's floors and the oracle's) under 25 a
    frame; the sweep with its face points blanked on both sides, again
    through the 8 shards, must then pass ``checks.parity_gates`` whole.
    Returns the run's launches."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
    try:
        flag_cfg.validate()
    except ValueError as e:
        log(f"phase 15: one grid refused: {e}")
    else:
        raise AssertionError("the launch-file extent validated as one grid")
    shard_cfg = ShardedFusion(flag_cfg, [dev] * 8, route=True).config
    want = 8 * grid_bytes(shard_cfg)
    mem = memory_stages(torch, flag_cfg, flag_frames, rays_np, dev)
    log(f"phase 15: device memory by stage ({card}): grids "
        f"{mem['grids'] / 1e9:.3f} GB allocated ({want / 1e9:.3f} GB "
        f"reckoned); peak above them while dispatching 8 frames (tier "
        f"{mem['tier']}) {mem['dispatch'] / 1e9:.3f} GB, refining "
        f"{mem['refine'] / 1e9:.3f} GB, extracting "
        f"{mem['extract'] / 1e9:.3f} GB")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels.reset_launches()
        r, dt, t_proc, m = replay(torch, flag_cfg, flag_frames, rays_np,
                                  dev, tmp, n_devices=8, route=True,
                                  probe=routing_probe)
        launches = path_launches(ROUTED_PATH)
        n = check_outputs(r)
    peak = torch.cuda.max_memory_allocated() - base
    pr = m["probe"]
    gm = r["grid_metrics"]
    if gm["devices"] != 8:
        raise AssertionError(f"phase 15: {gm['devices']} devices")
    # the session holds one set of grids and one stage's transients
    most = want + 2 * max(mem["dispatch"], mem["refine"], mem["extract"])
    if peak > most:
        raise AssertionError(f"phase 15: the session's peak allocated "
                             f"{peak} B, over {most} B")
    mpts = len(flag_frames) * WIDTH * HEIGHT / dt / 1e6
    log(f"phase 15: the launch-file extent {flag_cfg.global_x_cells} x "
        f"{flag_cfg.dims[1]} x {flag_cfg.dims[2]} cells on 8 shards of "
        f"{shard_cfg.n_cells} local cells ({card}): {len(flag_frames)} "
        f"frames in {dt:.3f} s = {mpts:.3f} Mpts/s; process() "
        f"{t_proc:.3f} s; {n} voxels, per shard "
        f"{shard_counts(r['host']['cell'], flag_cfg, pr['slab_w'], 8)}; "
        f"grids {want / 1e9:.3f} GB reckoned, the session's peak allocated "
        f"{peak / 1e9:.3f} GB; routing {json.dumps(pr)}; launches "
        f"{launches}; {json.dumps(gm)}")
    log(f"phase 15: stage timers {json.dumps(m['stage_timers'])}")
    sub = dataclasses.replace(flag_cfg, bbox=FLAGSHIP_SUB_BBOX).validate()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rs, dts = replay(torch, sub, flag_frames, rays_np, dev, tmp)[:2]
        check_outputs(rs)
    diff = same_voxels(rs["host"], sub, r["host"], flag_cfg)
    log(f"phase 15: one grid of the same lower corner, {sub.dims[0]} x "
        f"{sub.dims[1]} x {sub.dims[2]} cells, in {dts:.3f} s: "
        f"{rs['n_points']} voxels; against the 8 shards {diff}")
    if diff["cells"] or diff["count"] or diff["n_pts"] \
            or diff["centroid"] > 1e-5 or diff["normal"] > 1e-5:
        raise AssertionError(f"phase 15: the shards differ from one grid "
                             f"of the same corner: {diff}")
    problems, info = oracle_sweep(flag_cfg, flag_frames, r["host"], card,
                                  phase=15)
    flips = info["flips"].size
    far = flips - info["near"]
    rest = [p for p in problems if not p.startswith("count mismatch")]
    if rest or flips > 0.02 * info["common"] \
            or far > max(25 * len(flag_frames), 64):
        raise AssertionError(f"phase 15: shards vs C++ oracle: {problems}; "
                             f"{far} count flips out of reach of a face "
                             f"point")
    blank = blank_faces(flag_frames, flag_cfg)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rb = replay(torch, flag_cfg, blank, rays_np, dev, tmp, n_devices=8,
                    route=True)[0]
        check_outputs(rb)
    problems_b, info_b = oracle_sweep(flag_cfg, blank, rb["host"], card,
                                      phase="15, face points blanked")
    if problems_b:
        raise AssertionError(f"phase 15: shards vs C++ oracle with the face "
                             f"points blanked: {problems_b}")
    log(f"phase 15: gates held: cell sets, total hits, normals; count flips "
        f"{flips} <= 2% of {info['common']} voxels, {info['near']} of them "
        f"within reach of the {info['face_points']} face points and "
        f"{far} <= {25 * len(flag_frames)} not; with the face points "
        f"blanked {info_b['flips'].size} flips, parity_gates whole")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if not (ROOT / "hifi_fusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from hifi_fusion_tpu_torch import checks, kernels
    from hifi_fusion_tpu_torch.config import FusionConfig, small_test_config
    from hifi_fusion_tpu_torch.oracle import native as oracle_native
    from hifi_fusion_tpu_torch.runtime import native
    from hifi_fusion_tpu_torch.models.tsdf import TsdfConfig
    from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                       make_depth_sweep)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1 -------------------------------------------------------
    card = nvidia_smi()
    log(f"phase 1: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")

    # -- phase 2 -------------------------------------------------------
    shutil.rmtree(kernels.BUILD_DIR, ignore_errors=True)
    kernels.build()
    kernels.library()
    for line in kernels.BUILD_INFO["ptxas"].splitlines():
        if line.strip():
            log(f"phase 2: {line.strip()}")
    log(f"phase 2: built {kernels.LIB_PATH.name} in "
        f"{kernels.BUILD_INFO['seconds']:.1f} s")
    native.library()
    oracle_native.library()
    for stem, sec in native.BUILD_SECONDS.items():
        log(f"phase 2: g++ built {stem} in {sec:.2f} s")

    # -- phase 3 -------------------------------------------------------
    cfg = bench_config(FusionConfig)
    rays_np = camera_rays(WIDTH, HEIGHT, fx=FX, fy=FX)
    t0 = time.monotonic()
    frames = make_depth_sweep(cfg, FRAMES, width=WIDTH, height=HEIGHT,
                              seed=0, noise_sd=3e-4, camera_height=0.4,
                              srays=rays_np, arc_frames=ARC_FRAMES)
    log(f"phase 3: sweep of {FRAMES} frames made in "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    clouds = cloud_frames(frames)
    log(f"phase 3: the sweep's PointCloud2 records made in "
        f"{time.monotonic() - t0:.1f} s")
    rays = torch.from_numpy(rays_np).cuda()
    dev = torch.device("cuda")
    tcfg = tsdf_config(FusionConfig, TsdfConfig)
    kres = check_kernels(torch, cfg, frames, rays, dev)
    kres["planar_frontend"] = check_planar_frontend(torch, cfg, frames, dev)
    kres["record_frontend"] = check_record_frontend(torch, cfg, clouds, dev)
    kres.update(check_tsdf_kernels(torch, tcfg, frames, clouds, rays, dev))
    torch.cuda.empty_cache()
    kres["neighbor_count"], *b11 = check_neighbor_count(torch, cfg, frames,
                                                        rays, dev)
    torch.cuda.empty_cache()
    flag_cfg = flagship_config(FusionConfig)
    t0 = time.monotonic()
    flag_frames = make_depth_sweep(flag_cfg, FRAMES, width=WIDTH,
                                   height=HEIGHT, seed=0, noise_sd=3e-4,
                                   camera_height=0.4, srays=rays_np,
                                   arc_frames=ARC_FRAMES)
    log(f"phase 3: the launch-file extent's sweep of {FRAMES} frames made "
        f"in {time.monotonic() - t0:.1f} s")
    kres["route_pack"] = check_route_pack(torch, cfg, frames, flag_cfg,
                                          flag_frames, rays_np, dev)
    for name, r in kres.items():
        lib = ("" if r["library_ms"] is None
               else f", library {r['library_ms']:.4f} ms")
        log(f"phase 3: {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms{lib}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
            f"({r['bytes']} B), share {r['share']:.3f} ({card})")
    torch.cuda.empty_cache()

    # -- phase 4 -------------------------------------------------------
    state_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_state_")
    state_path = str(Path(state_dir.name) / "fusion_state.npz")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels.reset_launches()
        r, dt, t_proc, m = replay(torch, cfg, frames, rays_np, "cuda", tmp,
                                  state_path=state_path, variants=VARIANTS)
        fusion_launches = path_launches(FUSION_PATH)
        n = check_outputs(r)
        if n <= 20000:
            raise AssertionError(f"only {n} voxels extracted")
        rows = check_variants(r, cfg)
    depth_host = r["host"]
    mpts = FRAMES * WIDTH * HEIGHT / dt / 1e6
    log(f"phase 4: {FRAMES} frames in {dt:.3f} s = {mpts:.3f} Mpts/s "
        f"({card}); process() {t_proc:.3f} s; {n} voxels, "
        f"{int(r['host']['count'].sum())} cylinder hits; variant rows "
        f"{rows}; launches {fusion_launches}; "
        f"{json.dumps(r['grid_metrics'])}")
    log(f"phase 4: stage timers {json.dumps(m['stage_timers'])}")
    n_int, n_ref = sync_reads(torch, cfg, frames, rays_np)
    log(f"phase 4: synchronizing calls: an integrate dispatch {n_int} "
        f"(under sync_debug_mode 'error'), a refine {n_ref} (under "
        f"'warn': its count read)")
    idle = profiled_replay(torch, cfg, frames, rays_np)
    log(f"phase 4: the replay under torch.profiler ({card}): "
        f"{json.dumps(idle)}; idle share of the window "
        f"{1.0 - idle['busy_share']:.4f}")
    pipeline_api(torch, cfg, frames, rays, dev)
    torch.cuda.empty_cache()

    # -- phase 5 -------------------------------------------------------
    srays = camera_rays(128, 96, fx=160.0, fy=160.0)
    scfg = small_test_config(refine_every=4, max_batch_frames=4,
                             z_clip=(0.05, 10.0), buffer_capacity_log2=17,
                             max_points=srays.shape[1])
    sframes = make_depth_sweep(scfg, 8, width=128, height=96, srays=srays,
                               seed=1, noise_sd=3e-4, camera_height=0.4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rg = replay(torch, scfg, sframes, srays, "cuda", tmp + "/g")[0]
        rc = replay(torch, scfg, sframes, srays, "cpu", tmp + "/c")[0]
    problems = checks.parity_gates(rg["host"], rc["host"], len(sframes))
    common, ia, ib = np.intersect1d(rg["host"]["cell"], rc["host"]["cell"],
                                    return_indices=True)
    dots = np.sum(rg["host"]["normal"][ia].astype(np.float64)
                  * rc["host"]["normal"][ib], axis=1)
    if common.size == 0 or np.mean(dots <= 0.999) > 1e-3:
        problems.append("normals differ between card and CPU")
    log(f"phase 5: card {rg['n_points']} voxels, cpu {rc['n_points']}, "
        f"common {common.size}, min normal dot {dots.min():.7f}, "
        f"problems {problems}")
    if problems:
        raise AssertionError(f"card vs CPU parity: {problems}")
    tscfg = small_test_config(refine_every=0, max_batch_frames=4,
                              z_clip=(0.05, 10.0), capacity_log2=16,
                              max_points=srays.shape[1])
    problems = tsdf_card_vs_cpu(torch, tscfg, srays, sframes)
    if problems:
        raise AssertionError(f"TSDF card vs CPU parity: {problems}")

    # -- phase 6 -------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels.reset_launches()
        r, dt, t_proc, m = replay(torch, tcfg.base, frames, rays_np,
                                  "cuda", tmp, model="tsdf",
                                  model_params=TSDF_PARAMS)
        tsdf_launches = path_launches(TSDF_PATH)
        n = check_outputs(r)
    tsdf_host = r["host"]
    gm = r["grid_metrics"]
    if gm["frames"] != FRAMES:
        raise AssertionError(f"TSDF grid counted {gm['frames']} frames")
    if n != kres["tsdf_surface"]["shapes"]["replay"]["E"]:
        raise AssertionError(f"TSDF replay extracted {n} surface voxels, "
                             f"phase 3's final grid "
                             f"{kres['tsdf_surface']['shapes']['replay']}")
    mpts = FRAMES * WIDTH * HEIGHT / dt / 1e6
    log(f"phase 6: TSDF config 5, {FRAMES} frames in {dt:.3f} s = "
        f"{mpts:.3f} Mpts/s ({card}); process() {t_proc:.3f} s; {n} "
        f"surface voxels; launches {tsdf_launches}; {json.dumps(gm)}")
    log(f"phase 6: stage timers {json.dumps(m['stage_timers'])}")
    n_sync = tsdf_sync_reads(torch, tcfg, frames, clouds, rays_np, "depth")
    log(f"phase 6: synchronizing calls of a K=8 TSDF depth dispatch: "
        f"{n_sync} (under sync_debug_mode 'error')")
    idle = profiled_replay(torch, tcfg.base, frames, rays_np, model="tsdf",
                           model_params=TSDF_PARAMS)
    log(f"phase 6: the TSDF replay under torch.profiler ({card}): "
        f"{json.dumps(idle)}; idle share of the window "
        f"{1.0 - idle['busy_share']:.4f}")
    torch.cuda.empty_cache()

    # -- phase 7 -------------------------------------------------------
    kernels.reset_launches()
    planar_replay(torch, cfg, frames, clouds, depth_host, "cuda", card)
    planar_launches = path_launches(PLANAR_PATH)
    log(f"phase 7: launches {planar_launches}")

    # -- phase 8 -------------------------------------------------------
    state_round_trip(torch, cfg, rays_np, state_path, depth_host, "cuda",
                     card)

    # -- phase 9 -------------------------------------------------------
    problems = oracle_sweep(cfg, frames, depth_host, card)[0]
    if problems:
        raise AssertionError(f"card vs C++ oracle: {problems}")

    # -- phases 10-13 ----------------------------------------------------
    runs = [fusion_launches, tsdf_launches, planar_launches]
    runs.append(tsdf_planar_replay(torch, tcfg, frames, clouds, tsdf_host,
                                   "cuda", card))
    runs.append(queries_phase(torch, cfg, frames, state_path, b11, "cuda",
                              card))
    state_dir.cleanup()
    runs.append(cli_phase(torch, cfg, tcfg, frames, clouds, rays_np, "cuda",
                          card))
    runs.append(live_phase(torch, cfg, frames, rays_np, depth_host, "cuda",
                           card))

    # -- phases 14-15 ----------------------------------------------------
    torch.cuda.empty_cache()
    runs.extend(sharded_phase(torch, cfg, frames, rays_np, depth_host,
                              "cuda", card))
    torch.cuda.empty_cache()
    runs.append(flagship_phase(torch, flag_cfg, flag_frames, rays_np,
                               "cuda", card))

    # launches: the sum over the main-path runs (phases 4, 6, 7, 10-15);
    # K2's entry holds its integrate shape's numbers and every shape's
    shapes = {k.split("/")[1]: kres.pop(k) for k in list(kres)
              if k.startswith("hash_insert/")}
    kres["hash_insert"] = {**shapes["integrate"], "shapes": shapes}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(run[name] for run in runs), **kres[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
