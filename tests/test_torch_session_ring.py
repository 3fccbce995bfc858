"""The session's staging rings (``runtime/staging.py``): each pushed frame
copied into a row at push time, each dispatch filled from its rows.

On the CPU (plain host rows), for the depth wire and the record wire,
single-stepped (K=1) and K-batched (K=8), and K-batched on the paths that
took no row before every queued frame was a row (clouds a TSDF session or
a routed sharded session decodes on the host, a replicated sharded depth
session, depth frames of a second width):

* the caller's arrays and buffers may change the moment ``push_*``
  returns: the grid is the one the pipeline's own steps give on the
  frames as pushed;
* a full queue drops its oldest frame, counts it in
  ``frames_dropped_backpressure`` and releases its row, so pushing three
  queues' worth of frames past a stalled worker finds a row for every
  frame and never deadlocks;
* ``reset()`` releases the queued frames' rows at once and ``drain()`` the
  last dispatch's; the ring survives ``reset(full=True)`` and the next
  scan through it gives the direct calls' grid;
* a TSDF session's clouds and a sharded session's depth frames take rows
  of the session's ring, and frames of another layout than the ring's
  one-row rings of their own, outside ``push.stage``; each integrates as
  the direct calls;
* with every row of the session's ring held, each frame pushed takes a
  one-row ring of its own and integrates as the direct calls;
* a batch is filled by one copy a run of consecutive rows of one ring,
  across rings; the ring hands no row out twice under threads that take
  and release at once.

On the card (marked ``cuda``; run there with ``python -m pytest -m cuda
--noconftest tests/test_torch_session_ring.py``), for the depth and record
wires, a 96-frame K=8 sweep: the batches the pipeline receives are the
direct calls' bit for bit and the grid agrees with theirs
(``checks.grid_problems``: every integer exactly, cylinder sums within
``checks.RTOL``), ``push.stage`` counts every frame, ``device_step`` makes
no synchronizing call (``torch.cuda.set_sync_debug_mode("error")``), also
in a TSDF session's depth scan, and the scan's peak device memory equals
the direct calls'.
"""

import contextlib
import dataclasses
import os
import random
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from hifi_fusion_tpu_torch import checks
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline, refine_due
from hifi_fusion_tpu_torch.models.tsdf import TsdfConfig, TsdfPipeline
from hifi_fusion_tpu_torch.parallel.sharding import (ShardedFusion,
                                                     shard_devices)
from hifi_fusion_tpu_torch.runtime import staging
from hifi_fusion_tpu_torch.runtime.decode import (CloudFrame, decode_frame,
                                                  make_cloud_frame,
                                                  record_fields)
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.runtime.staging import StagingRing
from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                   make_depth_sweep,
                                                   make_sweep)

W, H = 64, 48
N_FRAMES = 16
CFG = small_test_config(max_points=W * H, z_clip=(0.05, 3.0),
                        refine_every=8, max_batch_frames=8)
RAYS = camera_rays(W, H, fx=60.0, fy=60.0)
DEPTH = make_depth_sweep(CFG, N_FRAMES, width=W, height=H, srays=RAYS,
                         seed=3, camera_height=0.3)
CLOUDS = [(make_cloud_frame(f.points_cam, f.rgb), f.pose)
          for f in make_sweep(CFG, N_FRAMES, 600, seed=5)]
TSDF = {"truncation": 0.03, "n_samples": 5, "min_weight": 1.0}
CASES = [(w, k) for w in ("depth", "records") for k in (1, 8)]
IDS = [f"{w}-K{k}" for w, k in CASES]
# each path: the session's keywords and the wire it pushes
PATHS = {
    "depth": ({}, "depth"),
    "records": ({}, "records"),
    "tsdf-clouds": ({"model": "tsdf", "model_params": TSDF}, "records"),
    "sharded-depth": ({"n_devices": 2}, "depth"),
    "routed-clouds": ({"n_devices": 2, "route": True}, "records"),
    "other-width": ({}, "depth"),
}
REUSE = CASES + [(p, 8) for p in ("tsdf-clouds", "sharded-depth",
                                  "routed-clouds", "other-width")]


def _session(k, **kw):
    return FusionSession(CFG, "cpu", batch_fill_wait=5.0 if k > 1 else 0.0,
                         **kw)


def _push(s, wire, i, scribble=False, rays=RAYS, depth=DEPTH,
          clouds=CLOUDS):
    """Push frame ``i`` of the wire's sweep; with ``scribble``, from
    copies of its arrays that are overwritten once the push returns."""
    if wire == "depth":
        f = depth[i % len(depth)]
        d, r, p = f.depth_q.copy(), f.rgb565.copy(), f.pose.copy()
        assert s.push_depth_frame(d, r, p, rays=rays)
        if scribble:
            d[:] = 0x7FFF
            r[:] = 0xFFFF
            p[:] = 0.0
        return
    frame, pose = clouds[i % len(clouds)]
    data, p = bytearray(frame.data), pose.copy()
    assert s.push_frame(CloudFrame(data, frame.point_step, frame.width,
                                   frame.height, frame.fields), p)
    if scribble:
        data[:] = b"\xff" * len(data)
        p[:] = 0.0


def _direct(pipe, wire, k, depth=DEPTH, clouds=CLOUDS, rays=None,
            grid=None, inputs=None):
    """The sweep into ``grid`` (default: a new one) through the
    pipeline's own steps, K frames a call and a refine where a mark falls
    in a batch, as a session dispatches it, each batch freed before the
    next is made; the grid.  ``rays``: the ray table on the device
    (default: ``RAYS``); ``inputs`` collects each call's batch."""
    cfg = pipe.config
    g = pipe.init() if grid is None else grid
    rays = pipe.put(RAYS) if rays is None else rays
    frames = depth if wire == "depth" else clouds
    for i in range(0, len(frames), k):
        fs = frames[i:i + k]
        if wire == "depth":
            n = fs[0].depth_q.shape[0]
            batch = (pipe.put(np.stack([f.depth_q for f in fs])),
                     pipe.put(np.stack([f.rgb565 for f in fs])),
                     pipe.put(np.full((k,), n, np.int32)),
                     pipe.put(np.stack([f.pose for f in fs])))
        else:
            step = fs[0][0].point_step
            rec = np.zeros((k, cfg.max_points * step), np.uint8)
            table = np.zeros((k, 6), np.int32)
            for j, (frame, _) in enumerate(fs):
                n, *layout = record_fields(frame)
                rec[j, :n * step] = np.frombuffer(frame.data, np.uint8)
                table[j] = [n, *layout]
            batch = (pipe.put(rec), None, pipe.put(table),
                     pipe.put(np.stack([p for _, p in fs])))
        if inputs is not None:
            inputs.append([None if t is None else t.cpu() for t in batch])
        data, rgb, counts, poses = batch
        del batch
        if wire == "depth" and k == 1:
            g = pipe.step_depth(g, data[0], rgb[0], counts[0], poses[0],
                                rays)
        elif wire == "depth":
            g = pipe.step_batch_depth(g, data, rgb, counts, poses, rays)
        elif k == 1:
            g = pipe.step(g, data[0], None, counts[0], poses[0])
        else:
            g = pipe.step_batch(g, data, None, counts, poses)
        del data, rgb, counts, poses
        if k > 1 and refine_due(i + k, k, cfg):
            g = pipe.refine(g)
    return g


def _equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _cut(f, n):
    """A depth frame's first ``n`` pixels."""
    return dataclasses.replace(f, depth_q=f.depth_q[:n].copy(),
                               rgb565=f.rgb565[:n].copy(), count=n)


def _sweep(path):
    """The frames a path pushes: "other-width" pushes its last eight at
    half the width of the first eight, which make the session's ring."""
    if path == "other-width":
        return DEPTH[:8] + [_cut(f, W * H // 2) for f in DEPTH[8:]]
    return DEPTH if PATHS[path][1] == "depth" else CLOUDS


def _planar_direct(pipe):
    """The clouds host-decoded into the planar wire, 8 frames a
    ``step_batch`` of ``pipe`` and a refine where a mark falls."""
    g = pipe.init()
    N = CFG.max_points
    for i in range(0, N_FRAMES, 8):
        pts = np.zeros((8, 3, N), np.float32)
        rgb = np.zeros((8, 3, N), np.float32)
        counts = np.zeros((8,), np.int32)
        for j, (frame, _) in enumerate(CLOUDS[i:i + 8]):
            xyz, col = decode_frame(frame)
            n = xyz.shape[0]
            pts[j, :, :n], rgb[j, :, :n], counts[j] = xyz.T, col.T, n
        poses = np.stack([p for _, p in CLOUDS[i:i + 8]])
        g = pipe.step_batch(g, *map(pipe.put, (pts, rgb, counts, poses)))
        if refine_due(i + 8, 8, CFG):
            g = pipe.refine(g)
    return g


def _reference(path, k):
    """The grid of the direct calls that a session on ``path`` makes."""
    kw, wire = PATHS[path]
    if path == "tsdf-clouds":
        pipe = TsdfPipeline(TsdfConfig(base=CFG, **TSDF), "cpu")
    elif "n_devices" in kw:
        pipe = ShardedFusion(CFG, shard_devices("cpu", kw["n_devices"]),
                             route=kw.get("route", False))
    else:
        pipe = FusionPipeline(CFG, "cpu")
    if wire == "records" and path != "records":
        g = _planar_direct(pipe)
    elif path == "other-width":
        frames = _sweep(path)
        g = _direct(pipe, wire, k, frames[:8])
        g = _direct(pipe, wire, k, frames[8:], grid=g,
                    rays=pipe.put(RAYS[:, :W * H // 2]))
    else:
        g = _direct(pipe, wire, k)
    return pipe.host_state(g)


@pytest.fixture(scope="module")
def direct():
    """``direct(path, k)``: the direct calls' grid, made once a module."""
    made = {}

    def get(path, k):
        if (path, k) not in made:
            made[path, k] = _reference(path, k)
        return made[path, k]

    return get


def _scan(path, k, scribble=False):
    """The path's 16 frames through a session: its grid, its metrics, its
    ring and each dispatch's ``(ring, row)`` pairs."""
    kw, wire = PATHS[path]
    frames = _sweep(path)
    rows = []
    with _session(k, **kw) as s:
        dispatch = s._dispatch

        def spy(items):
            rows.append([(f.ring, f.slot) for f in items])
            return dispatch(items)

        s._dispatch = spy
        s.start()
        for i in range(N_FRAMES):
            _push(s, wire, i, scribble, depth=frames, clouds=frames)
        assert s.drain(300)
        m = s.metrics()
        got = s.pipeline.host_state(s._grid)
        ring = s._ring
    return got, m, ring, rows


@pytest.mark.parametrize("wire,k", REUSE, ids=[f"{p}-K{k}" for p, k in REUSE])
def test_caller_may_reuse_its_buffers(direct, wire, k):
    got, m, _, _ = _scan(wire, k, scribble=True)
    assert m["frames_integrated"] == N_FRAMES and m["dispatch_errors"] == 0
    _equal(got, direct(wire, k))
    assert m["spans"]["push.stage"]["count"] == \
        (8 if wire == "other-width" else N_FRAMES)


@pytest.mark.parametrize("wire,k", CASES, ids=IDS)
def test_session_equals_direct_steps(direct, wire, k):
    with _session(k) as s:
        s.start()
        for i in range(N_FRAMES):
            _push(s, wire, i)
        assert s.drain(300)
        m = s.metrics()
        got = s.pipeline.host_state(s._grid)
        ring = s._ring
    assert ring.key[0] == wire and ring.rows == 100 + 2 * k + 1
    assert m["stage_timers"]["device_step"]["count"] == N_FRAMES // k
    assert m["spans"]["device_step.upload"]["count"] == N_FRAMES // k
    _equal(got, direct(wire, k))


def _stage_count(s):
    return s.timers.report().get("push.stage", {}).get("count", 0)


@pytest.mark.parametrize("wire,k", CASES, ids=IDS)
def test_full_queue_drops_oldest_and_releases_its_row(wire, k):
    q = 2 * k + 2
    with _session(k, queue_depth=q) as s:
        s.start()
        with s._glock:              # the worker stalls in its first launch
            for i in range(3 * q):
                _push(s, wire, i)
            ring = s._ring
            # a row for every frame: the dropped frames' rows came back
            assert _stage_count(s) == 3 * q
            assert ring.rows == q + 2 * k + 1
            assert ring.in_use() <= q + k
        assert s.drain(120)
        m = s.metrics()
    assert m["dispatch_errors"] == 0
    assert m["frames_integrated"] + m["frames_dropped_backpressure"] \
        == 3 * q
    assert m["frames_dropped_backpressure"] >= 2 * q - k
    assert ring.in_use() == 0


@pytest.mark.parametrize("wire,k", CASES, ids=IDS)
def test_reset_releases_rows_and_keeps_the_ring(direct, wire, k):
    with _session(k) as s:
        s.start()
        with s._glock:
            for i in range(N_FRAMES):
                _push(s, wire, i)
            ring = s._ring
            s.reset()
            # the queued frames' rows at once; the stalled batch's stay
            assert ring.in_use() <= k
        assert s.drain(120)
        assert ring.in_use() == 0
        s.start()
        for i in range(N_FRAMES // 2):
            _push(s, wire, i)
        s.reset(full=True)
        assert s._ring is ring and ring.in_use() == 0
        s.start()
        for i in range(N_FRAMES):
            _push(s, wire, i)
        assert s.drain(300)
        assert s._ring is ring and ring.in_use() == 0
        got = s.pipeline.host_state(s._grid)
    _equal(got, direct(wire, k))


@pytest.mark.parametrize("path", ["tsdf-clouds", "sharded-depth",
                                  "other-width"])
def test_paths_without_a_row_are_unchanged(direct, path):
    """The paths that took no row before every queued frame was a row: a
    TSDF session's clouds (decoded on the host) and a sharded session's
    depth frames now take rows of the session's ring; depth frames of
    another width than the ring's one-row rings of their own, which
    ``push.stage`` does not count.  Each grid is the direct calls'."""
    got, m, ring, rows = _scan(path, 8)
    assert m["frames_integrated"] == N_FRAMES and m["dispatch_errors"] == 0
    _equal(got, direct(path, 8))
    assert ring.rows == 100 + 2 * 8 + 1
    assert [len(b) for b in rows] == [8, 8]
    if path == "other-width":
        assert ring.key == ("depth", W * H)
        assert all(r is ring for r, _ in rows[0])
        own = [r for r, _ in rows[1]]
        assert len({id(r) for r in own}) == 8
        assert all(r.rows == 1 and r.key == ("depth", W * H // 2)
                   for r in own)
    else:
        assert all(r is ring for b in rows for r, _ in b)
        assert ring.key == (("depth", W * H) if path == "sharded-depth"
                            else ("records", CFG.max_points * 16))
    assert m["spans"]["push.stage"]["count"] == \
        (8 if path == "other-width" else N_FRAMES)
    if path == "tsdf-clouds":
        assert m["cloud_frames_host_decoded"] == N_FRAMES


def test_frames_pushed_while_every_row_is_held(direct):
    """Every row of the session's ring held by hand, as pushers on other
    threads would hold them: each frame pushed takes a one-row ring of its
    own outside ``push.stage``, may be overwritten once pushed, and
    integrates as the direct calls."""
    with _session(8) as s:
        s.start()
        with s._glock:              # the worker stalls in its first launch
            _push(s, "depth", 0)
            ring = s._ring
            held = []
            while (slot := ring.take()) is not None:
                held.append(slot)
            for i in range(1, N_FRAMES):
                _push(s, "depth", i, scribble=True)
        assert s.drain(300)
        assert ring.in_use() == len(held) == ring.rows - 1
        ring.release(held)
        m = s.metrics()
        got = s.pipeline.host_state(s._grid)
    assert m["frames_integrated"] == N_FRAMES and m["dispatch_errors"] == 0
    assert m["spans"]["push.stage"]["count"] == 1
    _equal(got, direct("depth", 8))


def test_ring_runs():
    a = StagingRing(("t",), {"x": ((2,), torch.int32)}, 12, pin=False)
    b = StagingRing(("t",), {"x": ((2,), torch.int32)}, 1, pin=False)
    assert staging.runs([(a, s) for s in (5, 6, 7, 8)]) == [(0, a, 5, 4)]
    assert staging.runs([(a, s) for s in (9, 10, 0, 1)]) == \
        [(0, a, 9, 2), (2, a, 0, 2)]
    assert staging.runs([(a, 3), (a, 1)]) == [(0, a, 3, 1), (1, a, 1, 1)]
    # a run never spans two rings; one batch takes rows of both
    rows = [(a, 4), (b, 0), (a, 5), (a, 6)]
    runs = staging.runs(rows)
    assert runs == [(0, a, 4, 1), (1, b, 0, 1), (2, a, 5, 2)]
    a.arrays["x"].copy_(torch.arange(24).view(12, 2))
    b.arrays["x"].fill_(-1)
    got = staging.batch(runs, 4, "cpu")["x"]
    assert got.tolist() == [[8, 9], [-1, -1], [10, 11], [12, 13]]


def test_ring_hands_no_row_out_twice():
    """Threads (more than the cores) take and release rows at once, the
    interpreter switching threads as often as it can: no row is held by
    two of them, and every row comes back."""
    ring = StagingRing(("t",), {"x": ((4,), torch.uint8)}, 9, pin=False)
    held, lock, bad = set(), threading.Lock(), []

    def worker(seed):
        rng = random.Random(seed)
        mine = []
        for _ in range(2000):
            if mine and (rng.random() < 0.5 or len(mine) > 2):
                s = mine.pop(rng.randrange(len(mine)))
                with lock:
                    held.discard(s)
                ring.release([s])
            else:
                s = ring.take()
                if s is None:
                    continue
                with lock:
                    if s in held:
                        bad.append(s)
                    held.add(s)
                mine.append(s)
        for s in mine:
            with lock:
                held.discard(s)
            ring.release([s])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and not held and ring.in_use() == 0


# -- on the card ------------------------------------------------------------

CW, CH = 160, 120
CCFG = small_test_config(max_points=CW * CH, z_clip=(0.05, 3.0),
                         refine_every=8, max_batch_frames=8,
                         capacity_log2=17, buffer_capacity_log2=17,
                         max_unique_per_frame=CW * CH,
                         max_refine_candidates=1 << 15)
CRAYS = camera_rays(CW, CH, fx=150.0, fy=150.0)


def _card_sweeps():
    depth = make_depth_sweep(CCFG, 96, width=CW, height=CH, srays=CRAYS,
                             seed=11, camera_height=0.3)
    clouds = [(make_cloud_frame(f.points_cam, f.rgb), f.pose)
              for f in make_sweep(CCFG, 96, CW * CH, seed=12)]
    return {"depth": depth, "clouds": clouds}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _card_sweeps()


def _fresh_peak():
    """Zero the peak count with the allocator's cached blocks released:
    the bytes a block counts depend on the free blocks it was cut from,
    so two equal sequences of allocations count equal peaks only from
    the same start."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _card_scan(card, wire, patch=None, model="fusion"):
    """A 96-frame K=8 sweep through a session of ``model`` on the card:
    the grid, the metrics, each batch the pipeline received and the scan's
    peak device memory above its start."""
    inputs = []
    with FusionSession(CCFG, "cuda", batch_fill_wait=5.0, model=model,
                       model_params=TSDF if model == "tsdf" else None) as s:
        s.warm(rays=CRAYS if wire == "depth" else None,
               depth=wire == "depth", planar=wire != "depth")
        name = "step_batch_depth" if wire == "depth" else "step_batch"
        step = getattr(s.pipeline, name)

        def spy(grid, data, rgb, counts, poses, *rest):
            inputs.append([None if t is None else t.clone()
                           for t in (data, rgb, counts, poses)])
            return step(grid, data, rgb, counts, poses, *rest)

        if patch is None:
            setattr(s.pipeline, name, spy)
        else:
            patch(s)
        _fresh_peak()
        base = torch.cuda.memory_allocated()
        s.start()
        for i in range(96):
            _push(s, wire, i, rays=CRAYS, depth=card["depth"],
                  clouds=card["clouds"])
        assert s.drain(300)
        peak = torch.cuda.max_memory_allocated() - base
        m = s.metrics()
        grid = s.pipeline.host_state(s._grid)
    return grid, m, [[None if t is None else t.cpu() for t in b]
                     for b in inputs], peak


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["depth", "records"])
def test_card_session_equals_direct_steps(card, wire):
    grid, m, inputs, _ = _card_scan(card, wire)
    assert m["dispatch_errors"] == 0 and m["frames_integrated"] == 96
    assert m["spans"]["push.stage"]["count"] == 96
    want = []
    pipe = FusionPipeline(CCFG, "cuda")
    ref = pipe.host_state(_direct(pipe, wire, 8, card["depth"],
                                  card["clouds"], pipe.put(CRAYS),
                                  inputs=want))
    assert len(inputs) == len(want) == 12
    for got_b, want_b in zip(inputs, want):
        for name, a, b in zip(("data", "rgb", "counts", "poses"), got_b,
                              want_b):
            if b is None:
                assert a is None
                continue
            if wire == "records" and name == "data":
                # the bytes past a frame's records are never read
                n = (want_b[2][:, 0] * want_b[2][:, 1]).tolist()
                for j in range(a.shape[0]):
                    assert torch.equal(a[j, :n[j]], b[j, :n[j]])
                continue
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert checks.grid_problems(grid, ref, CCFG, normal_tol=1e-5) == []


def _no_sync_in_device_step(s):
    """Run every ``device_step`` of session ``s`` under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing call
    fails its dispatch."""
    outer = s.timers.stage

    @contextlib.contextmanager
    def stage(name):
        with outer(name):
            if name != "device_step":
                yield
                return
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)

    s.timers.stage = stage


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["depth", "records"])
def test_card_device_step_makes_no_sync(card, wire):
    _, m, _, _ = _card_scan(card, wire, patch=_no_sync_in_device_step)
    assert m["dispatch_errors"] == 0 and m["frames_integrated"] == 96
    assert m["spans"]["push.stage"]["count"] == 96


@pytest.mark.cuda
def test_card_tsdf_device_step_makes_no_sync(card):
    """A K=8 TSDF depth scan: every dispatch, the batch sort (kernel T5,
    which finds its pass count on the card) with it, makes no
    synchronizing call."""
    _, m, _, _ = _card_scan(card, "depth", patch=_no_sync_in_device_step,
                            model="tsdf")
    assert m["dispatch_errors"] == 0 and m["frames_integrated"] == 96
    assert m["spans"]["push.stage"]["count"] == 96
    # the session grid's sorts alone: the scan's 12 batches (warm() sorts
    # into a grid of its own), each with the passes its distinct ids need
    from hifi_fusion_tpu_torch import bounds
    from hifi_fusion_tpu_torch.models import tsdf
    tcfg = TsdfConfig(base=CCFG, **TSDF)
    pipe = TsdfPipeline(tcfg, "cuda")
    passes = 0
    for b in range(0, 96, 8):
        fs = card["depth"][b:b + 8]
        skey = tsdf.tsdf_lanes(
            pipe.put(np.stack([f.depth_q for f in fs])),
            pipe.put(np.stack([f.rgb565 for f in fs])),
            pipe.put(np.full((8,), fs[0].depth_q.size, np.int32)),
            pipe.put(np.stack([f.pose for f in fs])), pipe.put(CRAYS),
            tcfg)[0]
        D = int(torch.unique(skey[skey != tsdf.BIG]).numel())
        passes += bounds.tsdf_sort_passes(D)
    assert (m["sort_batches"], m["sort_passes"],
            m["sort_lanes_out_of_range"]) == (12, passes, 0)


def _peak(side, wire):
    """The peak device memory of the card sweep above its start, through a
    session (``side`` "session") or direct pipeline calls ("direct")."""
    card = _card_sweeps()
    if side == "session":
        _, m, _, peak = _card_scan(card, wire, patch=lambda s: None)
        assert m["dispatch_errors"] == 0
        return peak
    pipe = FusionPipeline(CCFG, "cuda")
    grid, rays = pipe.init(), pipe.put(CRAYS)
    _fresh_peak()
    base = torch.cuda.memory_allocated()
    grid = _direct(pipe, wire, 8, card["depth"], card["clouds"], rays,
                   grid)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["depth", "records"])
def test_card_peak_memory_equals_direct_steps(card, wire):
    """Each side in a process of its own, as the benchmark counts a peak:
    in a process with a history the allocator cuts blocks from other free
    blocks, and equal allocations count unequal bytes."""
    root = str(Path(__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": root}
    peaks = {side: int(subprocess.run(
        [sys.executable, __file__, side, wire], cwd=root, env=env,
        capture_output=True, text=True, timeout=600,
        check=True).stdout.split()[-1]) for side in ("session", "direct")}
    assert peaks["session"] == peaks["direct"], peaks


if __name__ == "__main__":
    print(_peak(sys.argv[1], sys.argv[2]))
