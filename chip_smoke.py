#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hifi_fusion_tpu_torch) on one CUDA card.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. the card's name and power limit (nvidia-smi); no CUDA, no run;
2. a fresh build of the four CUDA kernels from ``hifi_fusion_tpu_torch/csrc``
   with the build seconds and ptxas' register / spill report;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the bench-size main path gives it, timed with CUDA events in the order
   plain, kernel, kernel, plain;
4. the main path: a bench-config ``FusionSession`` replay (640x480 depth
   frames, fx=900, 1 mm pitch, K=8 batches, a refine every 8 frames) of a
   seeded sweep, then ``process()``; checks overflow counters, voxel count,
   unit normals, the PCD and CSV files, and that every kernel launched;
5. a reduced sweep through the port on the card and through its plain path
   on the CPU, compared by cell id with the benchmark's structural gates.

The last lines are a JSON object of per-kernel results, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
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

KERNELS = {
    "depth_frontend": ("hifi_fusion_tpu_torch/csrc/depth_frontend.cu",
                       "hifi_fusion_tpu/ops/pallas_kernels.py:67"),
    "hash_insert": ("hifi_fusion_tpu_torch/csrc/hash_insert.cu",
                    "hifi_fusion_tpu/ops/hashing.py:159"),
    "dep_stream": ("hifi_fusion_tpu_torch/csrc/dep_stream.cu",
                   "hifi_fusion_tpu/ops/integrate.py:590"),
    "normal_fit": ("hifi_fusion_tpu_torch/csrc/normal_fit.cu",
                   "hifi_fusion_tpu/ops/refine.py:171"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_config(FusionConfig):
    """bench.py:bench_config (bench.py:361-406) with the fields the port
    reads; its TPU lane budgets and tiers are not read by the port."""
    return FusionConfig(
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
    ).validate()


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_pair(torch, kernel_fn, plain_fn, setup):
    """Median ms of ``kernel_fn(*setup())`` and ``plain_fn(*setup())``,
    CUDA events around the call only, in the order plain, kernel, kernel,
    plain."""
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if name == "kernel" else plain_fn
        for _ in range(REPS):
            args = setup()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return statistics.median(times["kernel"]), statistics.median(
        times["plain"])


def check_kernels(torch, cfg, frames, rays, dev):
    """Phase 3: every kernel against its plain version at main-path
    shapes.  Returns {name: {"max_abs_err", "ms", "plain_ms"}}."""
    from hifi_fusion_tpu_torch import checks
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
    res["depth_frontend"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    # a grid with normals and dependants: two batches, a refine after each
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *batch(i), rays)
        pipe.refine(grid)
    b2 = batch(2)
    world, ids, _ = integrate.depth_frontend(*b2, rays, cfg)
    sid, order = torch.sort(ids, stable=True)
    n_act = int((sid != integrate.INVALID_ID).sum())
    uids, run = torch.unique_consecutive(sid[:n_act], return_inverse=True)
    pts = world[:, order[:n_act]].contiguous()

    # K2: both tables must hold the same id set, every id at its slot
    def insert(fn):
        key = grid.key.clone()
        slot, failed = fn(key, uids, cfg.max_probes, cfg.capacity)
        return key, slot, int(failed)

    kk, sk, fk = insert(hashing.lookup_or_insert)
    kp, sp, fp = insert(hashing.insert_plain)
    bad = int((kk[sk.long()] != uids).sum()) + int((kp[sp.long()]
                                                     != uids).sum())
    bad += int((torch.sort(kk).values != torch.sort(kp).values).sum())
    if bad or fk or fp:
        raise AssertionError(f"hash_insert: {bad} id mismatches, failures "
                             f"kernel {fk} plain {fp}")
    ms, pms = time_pair(
        torch, hashing.lookup_or_insert, hashing.insert_plain,
        lambda: (grid.key.clone(), uids, cfg.max_probes, cfg.capacity))
    res["hash_insert"] = dict(max_abs_err=float(bad), ms=ms, plain_ms=pms)

    # K3: the third batch's points through the grid's dependants
    slot_pt = sk[run].contiguous()

    def stream_grid():
        return (pts, slot_pt, dataclasses.replace(
            grid, key=kk, cyl_stats=grid.cyl_stats.clone()), cfg)

    gk, gp = stream_grid()[2], stream_grid()[2]
    integrate.dep_stream(pts, slot_pt, gk, cfg)
    integrate.dep_stream_plain(pts, slot_pt, gp, cfg)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     cfg.cylinder_radius)
    hits = float((gk.cyl_stats.view(-1, 5)[:, 4]
                  - grid.cyl_stats.view(-1, 5)[:, 4]).sum())
    if not ok or hits <= 0:
        raise AssertionError(f"dep_stream: ok={ok} max err {err}, "
                             f"{hits} new hits")
    ms, pms = time_pair(torch, integrate.dep_stream,
                        integrate.dep_stream_plain, stream_grid)
    res["dep_stream"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)

    # K4: the candidates after the third batch
    pipe.step_batch_depth(grid, *b2, rays)
    cand = torch.nonzero((grid.n_pts > 0) & ~grid.normal_found
                         ).squeeze(1).to(torch.int32)

    def fit_grid():
        return (cand, dataclasses.replace(
            grid, normal=grid.normal.clone(),
            normal_found=grid.normal_found.clone()), cfg)

    gk, gp = fit_grid()[1], fit_grid()[1]
    nk, okk = refine.normal_fit(cand, gk, cfg)
    np_, okp = refine.normal_fit_plain(cand, gp, cfg)
    if not torch.equal(okk, okp) or not torch.equal(gk.normal_found,
                                                    gp.normal_found):
        raise AssertionError("normal_fit: gate differs from plain")
    err = float((gk.normal - gp.normal).abs().max())
    if err > 1e-5 or int(okk.sum()) == 0:
        raise AssertionError(f"normal_fit: normals differ by {err} "
                             f"({int(okk.sum())} gated)")
    ms, pms = time_pair(torch, refine.normal_fit, refine.normal_fit_plain,
                        fit_grid)
    res["normal_fit"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    for name, r in res.items():
        log(f"phase 3: {name}: max_abs_err {r['max_abs_err']:.3g}, "
            f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    return res


def read_pcd(path):
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.find(b"DATA ")
    nl = raw.find(b"\n", head_end)
    meta = {}
    for line in raw[:nl].decode().splitlines():
        parts = line.split()
        meta[parts[0]] = parts[1:]
    n = int(meta["POINTS"][0])
    cols = np.loadtxt(raw[nl + 1:].decode().splitlines(), dtype=np.float32,
                      ndmin=2)
    return n, cols


def replay(torch, cfg, frames, rays_np, device, out_dir, fill_wait=10.0):
    from hifi_fusion_tpu_torch.runtime.session import FusionSession
    with FusionSession(cfg, device, output_dir=out_dir,
                       batch_fill_wait=fill_wait) as s:
        s.start()
        t0 = time.monotonic()
        for f in frames:
            s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=rays_np)
        if not s.drain(900):
            raise AssertionError("session did not drain")
        dt = time.monotonic() - t0
        m = s.metrics()
        t1 = time.monotonic()
        r = s.process()
        t_proc = time.monotonic() - t1
    if m["frames_integrated"] != len(frames) or m["dispatch_errors"]:
        raise AssertionError(f"session integrated "
                             f"{m['frames_integrated']}/{len(frames)} "
                             f"frames, {m['dispatch_errors']} errors")
    return r, dt, t_proc


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

    # -- phase 3 -------------------------------------------------------
    cfg = bench_config(FusionConfig)
    rays_np = camera_rays(WIDTH, HEIGHT, fx=FX, fy=FX)
    t0 = time.monotonic()
    frames = make_depth_sweep(cfg, FRAMES, width=WIDTH, height=HEIGHT,
                              seed=0, noise_sd=3e-4, camera_height=0.4,
                              srays=rays_np, arc_frames=ARC_FRAMES)
    log(f"phase 3: sweep of {FRAMES} frames made in "
        f"{time.monotonic() - t0:.1f} s")
    rays = torch.from_numpy(rays_np).cuda()
    kres = check_kernels(torch, cfg, frames, rays, torch.device("cuda"))

    # -- phase 4 -------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        kernels.reset_launches()
        r, dt, t_proc = replay(torch, cfg, frames, rays_np, "cuda", tmp)
        launches = dict(kernels.LAUNCHES)
        gm = r["grid_metrics"]
        bad = {k: v for k, v in gm.items()
               if k.startswith("overflow") and v}
        if bad:
            raise AssertionError(f"overflow counters fired: {bad}")
        n = r["n_points"]
        if n <= 20000:
            raise AssertionError(f"only {n} voxels extracted")
        nrm = np.linalg.norm(r["host"]["normal"].astype(np.float64), axis=1)
        if np.abs(nrm - 1.0).max() > 1e-5:
            raise AssertionError(f"normals not unit: {np.abs(nrm-1).max()}")
        n_pcd, cols = read_pcd(r["cloud"])
        if n_pcd != n or cols.shape != (n, 8) \
                or not np.isfinite(cols).all():
            raise AssertionError(f"PCD: {n_pcd} points, {cols.shape}")
        csv = np.genfromtxt(r["metadata"], delimiter=",", skip_header=1,
                            ndmin=2)
        if csv.shape != (n, 7) or not np.isfinite(csv).all():
            raise AssertionError(f"CSV: shape {csv.shape}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched: {missing}")
    mpts = FRAMES * WIDTH * HEIGHT / dt / 1e6
    log(f"phase 4: {FRAMES} frames in {dt:.3f} s = {mpts:.3f} Mpts/s "
        f"({card}); process() {t_proc:.3f} s; {n} voxels, "
        f"{int(r['host']['count'].sum())} cylinder hits; launches "
        f"{launches}; {json.dumps(gm)}")

    # -- phase 5 -------------------------------------------------------
    scfg = small_test_config(refine_every=4, max_batch_frames=4,
                             z_clip=(0.05, 10.0))
    srays = camera_rays(128, 96, fx=160.0, fy=160.0)
    sframes = make_depth_sweep(scfg, 8, width=128, height=96, srays=srays,
                               seed=1, noise_sd=3e-4, camera_height=0.4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        rg, _, _ = replay(torch, scfg, sframes, srays, "cuda", tmp + "/g")
        rc, _, _ = replay(torch, scfg, sframes, srays, "cpu", tmp + "/c")
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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **kres[name]}
        for name, (src, rep) in KERNELS.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
