#!/usr/bin/env python3
"""Times kernels T1 and K3, and the two replays, of two checkouts of the
PyTorch port on one CUDA card, in the order A, B, B, A.

    python3 kernel_ab.py A_DIR B_DIR

Each of the four runs is a process of its own that imports
``hifi_fusion_tpu_torch`` from its checkout (building that checkout's
kernels there) and prints one JSON line:

* ``segscan``: T1 (``ops.scatter.segment_reduce``, kind add) on the sorted
  sample lanes of the seeded sweep's third K=8 batch at TSDF config 5
  (6 x 27,033,600 lanes), as ``chip_smoke.py`` phase 3 feeds it;
* ``dep_stream``: K3 (``ops.integrate.dep_stream``) on the third K=8
  batch's points at the fusion bench config, through a grid after two
  batches and refines, as phase 3 feeds it;
* ``fusion_mpts``, ``tsdf_mpts``: the 96-frame replays of phases 4 and 6
  (push to drain; ``process()`` follows, untimed).

Kernel times are device times (``chip_smoke.device_ms``): the median of 10
calls, CUDA events around each call, with a sleep kernel ahead of the
start event so that the card is busy while the host enqueues the call.
The configurations, the sweep and the replay are ``chip_smoke.py``'s, from
this script's own checkout.  The last line is a JSON object with every
run's results and the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def smoke():
    """This checkout's chip_smoke.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(root: str) -> dict:
    """One run: the checkout at ``root``'s T1, K3 and replays."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    cs = smoke()
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.config import FusionConfig
    from hifi_fusion_tpu_torch.models import tsdf
    from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
    from hifi_fusion_tpu_torch.ops import hashing, integrate, scatter
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

    def batch(pipe, i, K=8):
        fs = frames[K * i:K * i + K]
        return (pipe.put(np.stack([f.depth_q for f in fs])),
                pipe.put(np.stack([f.rgb565 for f in fs])),
                pipe.put(np.full((K,), fs[0].count, np.int32)),
                pipe.put(np.stack([f.pose for f in fs])))

    res = {"root": root}
    # K3
    pipe = FusionPipeline(cfg, dev)
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *batch(pipe, i), rays)
        pipe.refine(grid)
    world, ids, _ = integrate.depth_frontend(*batch(pipe, 2), rays, cfg)
    sid, order = torch.sort(ids, stable=True)
    n_act = int((sid != integrate.INVALID_ID).sum())
    uids, run = torch.unique_consecutive(sid[:n_act], return_inverse=True)
    pts = world[:, order[:n_act]].contiguous()
    slots, _ = hashing.lookup_or_insert(grid.key, uids, cfg.max_probes,
                                        cfg.capacity)
    slot_pt = slots[run].contiguous()
    res["dep_stream"] = cs.device_ms(torch, integrate.dep_stream, lambda: (
        pts, slot_pt, dataclasses.replace(
            grid, cyl_stats=grid.cyl_stats.clone()), cfg), reps=10)
    del pipe, grid, world, ids, sid, order, pts
    # T1
    tcfg = cs.tsdf_config(FusionConfig, tsdf.TsdfConfig)
    tp = tsdf.TsdfPipeline(tcfg, dev)
    skey, vals = tsdf.tsdf_lanes(*batch(tp, 2), rays, tcfg)
    sid, order = torch.sort(skey, stable=True)
    svals = vals[:, order].contiguous()
    starts = scatter.segment_starts(sid, sid != tsdf.BIG)
    del skey, vals, order
    res["segscan"] = cs.device_ms(torch, scatter.segment_reduce,
                                  lambda: (svals, starts, "add"), reps=10)
    del svals, starts, sid
    torch.cuda.empty_cache()
    # the replays
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        _, dt, _ = cs.replay(torch, cfg, frames, rays_np, "cuda", tmp + "/f")
        res["fusion_mpts"] = cs.FRAMES * cs.WIDTH * cs.HEIGHT / dt / 1e6
        _, dt, _ = cs.replay(torch, tcfg.base, frames, rays_np, "cuda",
                             tmp + "/t", model="tsdf",
                             model_params=cs.TSDF_PARAMS)
        res["tsdf_mpts"] = cs.FRAMES * cs.WIDTH * cs.HEIGHT / dt / 1e6
    return res


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing run", file=sys.stderr)
        return 1
    a, b = argv[1], argv[2]
    runs = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--child", root], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            raise RuntimeError(f"run {label} ({root}) failed")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        r["label"] = label
        runs.append(r)
        print(f"{label}: segscan {r['segscan']:.4f} ms, dep_stream "
              f"{r['dep_stream']:.4f} ms, fusion {r['fusion_mpts']:.3f} "
              f"Mpts/s, tsdf {r['tsdf_mpts']:.3f} Mpts/s ({root})",
              flush=True)
    print(json.dumps({"runs": runs, "card": smoke().nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
