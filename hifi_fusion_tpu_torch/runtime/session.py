"""FusionSession: the port's host runtime, for point clouds and depth frames.

A lean counterpart of ``hifi_fusion_tpu/runtime/session.py`` with the same
contract:

* ``start()`` / ``stop()`` gate frame ingestion (queued frames still drain);
* ``reset(full=False)`` stops and drops the input queue, keeping the grid
  (``full=True`` also clears the grid and the failed dispatches counted
  against it);
* ``warm(rays=None, extract=False, depth=False, planar=True)`` builds the
  CUDA kernels and the host library and runs zero inputs through every
  step the session will dispatch on a throwaway grid, so the first frame
  meets no build and no first-call set-up; it returns its wall seconds;
* ``push_frame(frame, pose=None)`` queues one PointCloud2-style
  ``runtime/decode.CloudFrame`` (the subscriber callback).  Without a pose
  it asks ``pose_provider(frame)``; a lookup that raises drops the frame
  and counts it in ``pose_failures``.  The worker decodes it on the host
  (``decode.decode_frame``), cuts it to ``max_points`` (counted in
  ``frames_truncated`` / ``points_truncated``) and integrates it through
  the planar frontend, kernel K5 (the TSDF family: its planar sample map,
  kernel T2p);
* ``run_source(source)`` pushes every ``(frame, pose)`` of a
  ``runtime/sources.Source`` and drains;
* ``push_depth_frame(depth_q, rgb565, pose, rays)`` queues one frame
  (u16 z-depth, rgb565, camera pose; the (3,N) ray table on first use);
  a frame wider than ``max_points`` is cut and counted the same way;
* ``drain()`` waits until the queue is empty and the device is idle;
* ``process(cloud_name, meta_name, ascii_mode, drain_timeout, variants,
  extra_fields)`` drains, runs the final refine, extracts, writes the
  cloud (PCD, or PLY when ``cloud_name`` ends in ``.ply``) and the
  metadata CSV to ``output_dir`` (the CSV formatted on a thread while the
  cloud is written; both native writers run with the GIL released),
  writes the ``variants`` (``hq``, ``classified``, ``xyzrgb``,
  ``normals``: the reference's ``download*`` views) next to the cloud,
  then clears the grid.  Its ``host`` entry holds the extract's lanes
  (those named in ``extra_fields``, or all);
* ``save_state(path)`` / ``load_state(path)`` checkpoint the grid as an
  npz in the JAX package's layout, which either package's ``load_state``
  takes;
* ``metrics()`` adds the session's counters, ``stage_timers`` (the JAX
  package's stage names, ``STAGES``) and ``spans`` (every other span) to
  the grid's; the command line's ``metrics`` control verb returns them.

Each stage and span is one ``utils/profiling`` span: host seconds, count
and mean in ``metrics()`` (``{total_s, count, mean_ms}``) and, while
``torch.profiler`` records, a range of the same name on the trace
(``device_step``'s range is ``step``).  The spans split the stages:

* ``batch_wait``: the worker asleep waiting for a K-batch to fill;
* ``decode.native`` / ``decode.pack`` (in ``decode``), once a frame: the
  native decode, and the cut to ``max_points`` and copy into the padded
  batch; ``decode.pack`` once more a batch, the zeroed batch's
  allocation;
* ``device_step.stage`` / ``.upload`` / ``.launch`` (in ``device_step``),
  once a dispatch: the host's stacking of the batch, its copies to the
  device, the pipeline's step call;
* ``refine.read`` (in ``refine``, or in ``device_step`` when a single
  step refines), once a pass of a single grid: the pass's one read of
  the device, which waits for the work queued before it;
* ``drain``: a whole ``drain()`` call, on the caller's thread;
* ``csv_write``: the metadata CSV on its thread inside ``process()``.

``model`` picks the device-side model family: ``"fusion"`` (the
cylinder-filtered pipeline, ``FusionPipeline``) or ``"tsdf"`` (the
TSDF-weighted family, ``models/tsdf.TsdfPipeline``; ``model_params`` feeds
its ``TsdfConfig``: truncation, n_samples, min_weight, surface_band,
batch_unique).  The TSDF family has no refine phase (its ``refine`` is a
no-op); its export maps the surface onto the same PCD and CSV columns
(tsdf.py:380-410).  Both families take point clouds (``push_frame``; the
TSDF family through its planar step, kernel T2p) and depth frames.

One worker thread pops frames from a bounded drop-oldest queue.  With
``batch_fill_wait > 0`` (replay sources that outrun the device) it waits
up to that long for a full K-batch and integrates K frames at once; K is
the largest value <= ``max_batch_frames`` that divides both
``refine_every`` and ``refine_first``, so a batch never spans a refine
mark and batched and single-stepped sessions refine at the same frames.
With ``live_batching`` (a live source, after ``warm()``) a K-batch is
popped only when the queue already holds one at a K-aligned frame
number, with no wait: a backlog drains at the batched rate and a frame is
never delayed.  A batch holds frames of one kind (clouds, or depth frames
of one width).  With neither, every frame is stepped alone.  Before a
dispatch the worker waits for the previous one's device work
(``device_wait``), so the host runs at most one step ahead of the card.

``n_devices > 1`` runs the slab-sharded pipeline
(``parallel/sharding.ShardedFusion``) behind the same contract, shard
``j`` on ``cuda:(j % device_count)`` for a CUDA ``device`` and on
``device`` itself otherwise, so shards may share a card; ``route=True``
routes points to their owner slabs (kernel B12) instead of replicating
frames, over the send-budget tier ladder ``route_betas`` (default
``(2, n_devices)``, lossless by construction).  The global config is then
validated per shard only: sharding exists for extents a single grid
cannot address.  The TSDF family is single-device (JAX session.py:64-95).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import FusionConfig
from ..io import downloads, pcd, ply
from ..models.pipeline import FusionPipeline, refine_due
from ..models.tsdf import TsdfConfig, TsdfPipeline
from ..parallel.sharding import ShardedFusion, shard_devices
from ..utils.profiling import StageTimers
from . import native
from .decode import CloudFrame, decode_frame
from .sources import Source

log = logging.getLogger("hifi_fusion_tpu_torch")

# the JAX session's stage names: ``metrics()["stage_timers"]``; every other
# span is under ``metrics()["spans"]``
STAGES = frozenset({"decode", "device_step", "device_wait", "refine",
                    "process_refine", "process_extract", "process_export",
                    "process_csv_wait", "process_metrics", "process_clear"})


def batch_frames(config: FusionConfig) -> int:
    """The session's K: the largest K <= max_batch_frames dividing both
    refine marks' spacing and the first mark."""
    kb = max(int(config.max_batch_frames), 1)
    e = config.refine_every
    if e > 0:
        f0 = config.refine_first
        while e % kb or (f0 > 0 and f0 % kb):
            kb -= 1
    return kb


class FusionSession:
    def __init__(self, config: FusionConfig, device,
                 output_dir: str = ".", queue_depth: int = 100,
                 final_refine: bool = True, batch_fill_wait: float = 0.0,
                 model: str = "fusion", model_params: Dict = None,
                 pose_provider: Optional[Callable] = None,
                 live_batching: bool = False, n_devices: int = 1,
                 route: bool = False, route_betas=None):
        if model not in ("fusion", "tsdf"):
            raise ValueError(f"unknown model {model!r}")
        self.model = model
        self.pose_provider = pose_provider
        if n_devices > 1:
            if model != "fusion":
                raise NotImplementedError(
                    "sharded sessions support the flagship fusion model "
                    "only; the TSDF variant is single-device")
            self.pipeline = ShardedFusion(
                config, shard_devices(device, n_devices), route=route,
                route_betas=route_betas)
            self.config = config             # per-shard validation inside
        elif model == "tsdf":
            self.config = config.validate()
            self.pipeline = TsdfPipeline(
                TsdfConfig(base=config, **(model_params or {})), device)
        else:
            self.config = config.validate()
            self.pipeline = FusionPipeline(config, device)
        self.output_dir = output_dir
        self.final_refine = final_refine
        self._kb = (batch_frames(config)
                    if batch_fill_wait > 0 or live_batching else 1)
        self._batch_fill_wait = float(batch_fill_wait)

        self._queue = collections.deque(maxlen=queue_depth)
        self._qlock = threading.Lock()
        self._glock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._started = False
        self._busy = False
        self._errors = []          # failed dispatches into the current grid
        self._last_step = []       # CUDA events after the last dispatch
        self._cuda = [d for d in dict.fromkeys(
            getattr(self.pipeline, "devices", [self.pipeline.device]))
            if d.type == "cuda"]

        self._grid = self.pipeline.init()
        self._rays = None
        self._frames_in = 0
        self._frames_integrated = 0
        self._frames_dropped = 0
        self._pose_failures = 0
        self._frames_truncated = 0   # frames cut to max_points
        self._points_truncated = 0   # points cut from them
        self.timers = StageTimers()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="fusion-worker")
        self._worker.start()

    # -- control plane ---------------------------------------------------
    def start(self) -> None:
        self._started = True

    def stop(self) -> None:
        self._started = False

    def reset(self, full: bool = False) -> None:
        self._started = False
        with self._qlock:
            self._queue.clear()
        if full:
            self.drain()
            with self._glock:
                self._grid = None       # freed before the new grid is made
                self._grid = self.pipeline.init()
                self._errors.clear()

    def warm(self, rays: Optional[np.ndarray] = None,
             extract: bool = False, depth: bool = False,
             planar: bool = True) -> float:
        """Build the CUDA kernels (on a CUDA device) and the host library,
        then run zero inputs through every step the session will dispatch,
        single and K-batched, planar (``planar``) and depth (``rays``, or
        ``depth`` with a zero ray table), and a refine, on a throwaway
        grid; ``extract=True`` also runs the extract and the grid metrics.
        ``rays`` is pinned as the session's ray table, as
        ``push_depth_frame`` would.  The session grid is untouched, and the
        launches are counted in ``kernels.LAUNCHES`` as any other.
        Returns the wall seconds spent (JAX session.py:210-279)."""
        t0 = time.monotonic()
        pipe = self.pipeline
        dev = pipe.device
        if self._cuda:
            kernels.library()
        native.library()
        N = self.config.max_points
        K = self._kb
        poses = pipe.put(np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)))
        pose = poses[0]
        g = pipe.init()
        if rays is not None and self._rays is None:
            self._rays = pipe.put(np.asarray(rays, np.float32))
        zc = torch.zeros((K,), dtype=torch.int32, device=dev)
        if planar:
            zp = torch.zeros((K, 3, N), dtype=torch.float32, device=dev)
            g = pipe.step(g, zp[0], zp[0], zc[0], pose)
            if K > 1:
                g = pipe.step_batch(g, zp, zp, zc, poses)
        zrays = self._rays
        if zrays is None and depth:
            zrays = torch.zeros((3, N), dtype=torch.float32, device=dev)
        if zrays is not None:
            zd = torch.zeros((K, N), dtype=torch.uint16, device=dev)
            g = pipe.step_depth(g, zd[0], zd[0], zc[0], pose, zrays)
            if K > 1:
                g = pipe.step_batch_depth(g, zd, zd, zc, poses, zrays)
        if self.config.refine_every > 0:
            g = pipe.refine(g)
        if extract:
            pipe.extract_host(g)
            pipe.grid_metrics(g)
        for d in self._cuda:
            torch.cuda.synchronize(d)
        dt = time.monotonic() - t0
        log.info("WARM: kernels built and steps run in %.1fs", dt)
        return dt

    def process(self, cloud_name: str = "test_cloud.pcd",
                meta_name: str = "meta.csv", ascii_mode: bool = True,
                drain_timeout: float = 300.0,
                variants: Tuple[str, ...] = (),
                extra_fields: Tuple[str, ...] = ()) -> Dict:
        """Drain, export the fused cloud, its metadata and ``variants``,
        clear the grid (JAX session.py:302-445).  Raises if the queue does
        not drain or a frame failed to integrate: exporting such a grid
        would break the snapshot contract."""
        was_started = self._started
        self._started = False
        try:
            if not self.drain(timeout=drain_timeout):
                raise TimeoutError(f"process(): input queue failed to "
                                   f"drain within {drain_timeout}s")
            if self._errors:
                raise RuntimeError(f"process(): {len(self._errors)} "
                                   f"dispatch(es) failed") \
                    from self._errors[0]
            os.makedirs(self.output_dir, exist_ok=True)
            cloud_path = os.path.join(self.output_dir, cloud_name)
            meta_path = os.path.join(self.output_dir, meta_name)
            stage = self.timers.stage
            with self._glock:
                grid = self._grid
                if self.final_refine and self._needs_final_refine():
                    with stage("process_refine"):
                        grid = self.pipeline.refine(grid)
                with stage("process_extract"):
                    host = self.pipeline.extract_host(grid)
                csv_err = []

                def write_csv():
                    try:
                        with stage("csv_write"):
                            pcd.write_metadata_csv(
                                meta_path, host["sd"], host["mean_dist"],
                                host["sd_dist"], host["count"])
                    except Exception as e:      # re-raised after join
                        csv_err.append(e)

                csv_thread = threading.Thread(target=write_csv,
                                              name="csv-export")
                csv_thread.start()
                try:
                    with stage("process_export"):
                        if cloud_path.endswith(".ply"):
                            ply.write_ply(cloud_path, host["centroid"],
                                          host["rgb"], host["normal"],
                                          ascii_mode=ascii_mode)
                        else:
                            pcd.write_pcd_xyzrgbnormal(
                                cloud_path, host["centroid"], host["rgb"],
                                host["normal"], ascii_mode=ascii_mode)
                        variant_paths = self._write_variants(
                            host, cloud_path, variants, ascii_mode)
                finally:
                    with stage("process_csv_wait"):
                        csv_thread.join()
                if csv_err:
                    raise csv_err[0]
                with stage("process_metrics"):
                    metrics = self.pipeline.grid_metrics(grid)
                with stage("process_clear"):
                    # the old grid is freed before the new one is made, so
                    # the device never holds two
                    self._grid = grid = None
                    self._grid = self.pipeline.init()
                    self._errors.clear()
        finally:
            self._started = was_started
        n = int(host["cell"].shape[0])
        log.info("PROCESS: %d voxels -> %s", n, cloud_path)
        if extra_fields:
            host = {f: host[f] for f in extra_fields}
        return {"cloud": cloud_path, "metadata": meta_path, "n_points": n,
                "variants": variant_paths, "grid_metrics": metrics,
                "host": host}

    def _write_variants(self, host, cloud_path: str, variants,
                        ascii_mode: bool) -> Dict[str, str]:
        """Write the reference's extra download* views next to the main
        cloud (OccupancyGrid.hpp:491-601; JAX session.py:447-481)."""
        stem = cloud_path.rsplit(".", 1)[0]
        out: Dict[str, str] = {}
        for v in variants:
            path = f"{stem}_{v}.pcd"
            if v == "hq":
                d = downloads.download_hq(host, self.config)
                pcd.write_pcd_xyzrgbnormal(path, d["xyz"], d["rgb"],
                                           d["normal"],
                                           ascii_mode=ascii_mode)
            elif v == "classified":
                d = downloads.download_classified(host, self.config)
                pcd.write_pcd_xyzrgb(path, d["xyz"], d["rgb"],
                                     ascii_mode=ascii_mode)
            elif v == "xyzrgb":
                d = downloads.download_xyz(host)
                pcd.write_pcd_xyzrgb(path, d["xyz"], d["rgb"],
                                     ascii_mode=ascii_mode)
            elif v == "normals":
                d = downloads.download_with_normals(host)
                pcd.write_pcd_xyzrgbnormal(path, d["xyz"], d["rgb"],
                                           d["normal"],
                                           ascii_mode=ascii_mode)
            else:
                raise ValueError(f"unknown export variant {v!r} (expected "
                                 f"hq/classified/xyzrgb/normals)")
            out[v] = path
        return out

    # -- ingestion --------------------------------------------------------
    def push_frame(self, frame: CloudFrame,
                   pose: Optional[np.ndarray] = None) -> bool:
        """Queue one point cloud with its (4,4) camera pose, or the pose
        ``pose_provider(frame)`` gives.  Returns False when ingestion is
        gated or the pose lookup failed (the frame is dropped and counted
        in ``pose_failures``, as the reference drops it with a warning,
        FUSION.cpp:340-344)."""
        self._frames_in += 1
        if not self._started:
            return False
        if pose is None:
            if self.pose_provider is None:
                raise ValueError("no pose given and no pose_provider set")
            try:
                pose = self.pose_provider(frame)
            except Exception as e:
                self._pose_failures += 1
                log.warning("pose lookup failed, dropping frame: %s", e)
                return False
        self._enqueue(("cloud", frame, np.asarray(pose, np.float32)))
        return True

    def push_depth_frame(self, depth_q: np.ndarray, rgb565: np.ndarray,
                         pose: np.ndarray, rays: np.ndarray = None) -> bool:
        """Queue one u16 z-depth image + rgb565 + (4,4) camera pose.
        ``rays`` ((3,N) f32, utils/synthetic.camera_rays) is uploaded on
        first use and stays fixed for the session.  Returns False when
        ingestion is gated."""
        self._frames_in += 1
        if not self._started:
            return False
        if self._rays is None:
            if rays is None:
                raise ValueError("push_depth_frame needs rays on first call")
            self._rays = self.pipeline.put(np.asarray(rays, np.float32))
        self._enqueue(("depth", np.asarray(depth_q, np.uint16),
                       np.asarray(rgb565, np.uint16),
                       np.asarray(pose, np.float32)))
        return True

    def run_source(self, source: Source, auto_start: bool = True) -> None:
        """Feed an entire source through the session (replay mode)."""
        if auto_start:
            self.start()
        for frame, pose in source:
            self.push_frame(frame, pose)
        self.drain()

    def _enqueue(self, item) -> None:
        with self._qlock:
            if len(self._queue) == self._queue.maxlen:
                self._frames_dropped += 1
            self._queue.append(item)
        self._wake.set()

    # -- worker -----------------------------------------------------------
    @staticmethod
    def _shape(item):
        """Frames batch together only when their shapes agree: a cloud is
        padded to ``max_points`` on decode, a depth frame keeps its
        width."""
        return ("cloud",) if item[0] == "cloud" else ("depth",
                                                      item[1].shape)

    def _pop_items(self):
        """One frame, or a K-batch of frames of one kind and shape when it
        starts at a K-aligned frame.  With ``batch_fill_wait`` the worker
        first waits that long for a K-batch to fill; with
        ``live_batching`` alone it takes a batch only when one is already
        queued."""
        kb = self._kb
        if (kb > 1 and self._batch_fill_wait > 0
                and not self._batch_ready(kb)):
            with self.timers.stage("batch_wait"):
                deadline = time.monotonic() + self._batch_fill_wait
                while not self._shutdown and time.monotonic() < deadline:
                    time.sleep(0.001)
                    if self._batch_ready(kb):
                        break
        with self._qlock:
            if not self._queue:
                return []
            self._busy = True
            if (kb > 1 and len(self._queue) >= kb
                    and self._frames_integrated % kb == 0
                    and len({self._shape(f) for f in
                             list(self._queue)[:kb]}) == 1):
                return [self._queue.popleft() for _ in range(kb)]
            return [self._queue.popleft()]

    def _batch_ready(self, kb: int) -> bool:
        """Nothing to wait for: the queue is empty, holds a K-batch, or
        the next frame is not K-aligned."""
        with self._qlock:
            return (not self._queue or len(self._queue) >= kb
                    or self._frames_integrated % kb != 0)

    def _needs_final_refine(self) -> bool:
        """False iff the cadence already refined at exactly the current
        frame count."""
        f = self._frames_integrated
        if f == 0:
            return False
        if self.config.refine_every <= 0:
            return True
        return not refine_due(f, 1, self.config)

    def _truncate(self, n: int, k: int, what: str) -> int:
        """The lanes kept of ``k`` frames of ``n`` points; frames wider than
        ``max_points`` are cut and counted (JAX session.py:606-648)."""
        cap = self.config.max_points
        if n > cap:
            self._frames_truncated += k
            self._points_truncated += (n - cap) * k
            log.warning("%s has %d points > max_points=%d; truncating "
                        "(%d dropped x %d frames)", what, n, cap, n - cap, k)
        return min(n, cap)

    def _decode_planar(self, items):
        """Host decode of K cloud frames into the planar wire: (K,3,N) f32
        points and rgb padded to N = ``max_points`` and (K,) i32 count
        prefixes (the ``decode`` stage: a frame's library decode,
        ``decode.native``, and its repack into the padded batch,
        ``decode.pack``; the zeroed batch is allocated first, in a
        ``decode.pack`` of its own)."""
        N = self.config.max_points
        k = len(items)
        stage = self.timers.stage
        with stage("decode.pack"):
            pts = np.zeros((k, 3, N), np.float32)
            rgb = np.zeros((k, 3, N), np.float32)
            counts = np.zeros((k,), np.int32)
        for i, (_, frame, _) in enumerate(items):
            with stage("decode.native"):
                xyz, col = decode_frame(
                    frame, blue_shift_bug=self.config.bug_compat_blue_shift)
            with stage("decode.pack"):
                n = self._truncate(xyz.shape[0], 1, "frame")
                pts[i, :, :n] = xyz[:n].T
                rgb[i, :, :n] = col[:n].T
                counts[i] = n
        return pts, rgb, counts

    def _await_device(self) -> None:
        """Wait until the card has finished the previous dispatch, so the
        host runs at most one step ahead (on the CPU every op has finished
        when it returns, and there is nothing to wait for)."""
        with self.timers.stage("device_wait"):
            for event in self._last_step:
                event.synchronize()

    def _dispatch(self, items) -> None:
        cfg = self.config
        k = len(items)
        put = self.pipeline.put
        stage = self.timers.stage
        cloud = items[0][0] == "cloud"
        if cloud:
            with stage("decode"):
                host = self._decode_planar(items)
        else:
            n = self._truncate(items[0][1].shape[-1], k, "depth frame")
        self._await_device()
        with stage("device_step"):
            # the host's work first, then every copy, then the launch
            with stage("device_step.stage"):
                poses = np.stack([f[-1] for f in items])
                if not cloud:
                    host = (np.stack([f[1][:n] for f in items]),
                            np.stack([f[2][:n] for f in items]),
                            np.full((k,), n, np.int32))
            with stage("device_step.upload"):
                poses = put(poses)
                data, rgb, counts = map(put, host)
            with stage("device_step.launch"), self._glock:
                if cloud and k == 1:
                    self._grid = self.pipeline.step(
                        self._grid, data[0], rgb[0], counts[0], poses[0])
                elif cloud:
                    self._grid = self.pipeline.step_batch(
                        self._grid, data, rgb, counts, poses)
                else:
                    rays = self._rays[:, :n].contiguous()
                    if k == 1:
                        self._grid = self.pipeline.step_depth(
                            self._grid, data[0], rgb[0], counts[0],
                            poses[0], rays)
                    else:
                        self._grid = self.pipeline.step_batch_depth(
                            self._grid, data, rgb, counts, poses, rays)
        if k > 1 and cfg.refine_every > 0 and refine_due(
                self._frames_integrated + k, k, cfg):
            with stage("refine"), self._glock:
                self._grid = self.pipeline.refine(self._grid)
        self._last_step = []
        for dev in self._cuda:
            with torch.cuda.device(dev):
                self._last_step.append(torch.cuda.Event())
                self._last_step[-1].record()
        self._frames_integrated += k

    def _run(self) -> None:
        while not self._shutdown:
            items = self._pop_items()
            if not items:
                self._busy = False
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self._dispatch(items)
            except Exception as e:          # the worker must keep running
                log.exception("frame integration failed; %d frame(s) "
                              "dropped", len(items))
                self._errors.append(e)
            finally:
                self._busy = False

    def drain(self, timeout: float = 300.0) -> bool:
        """Block until the queue is empty, the worker idle and the device
        done with every dispatched step (the span ``drain``)."""
        with self.timers.stage("drain"):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._qlock:
                    empty = not self._queue
                if empty and not self._busy:
                    for dev in self._cuda:
                        torch.cuda.synchronize(dev)
                    return True
                time.sleep(0.002)
            return False

    # -- observability ------------------------------------------------------
    def metrics(self) -> Dict:
        with self._glock:
            m = self.pipeline.grid_metrics(self._grid)
        timers = self.timers.report()
        m.update({
            "frames_received": self._frames_in,
            "frames_integrated": self._frames_integrated,
            "frames_dropped_backpressure": self._frames_dropped,
            "dispatch_errors": len(self._errors),
            "pose_failures": self._pose_failures,
            "frames_truncated": self._frames_truncated,
            "points_truncated": self._points_truncated,
            "decode_s": timers.get("decode", {}).get("total_s", 0.0),
            "stage_timers": {k: v for k, v in timers.items()
                             if k in STAGES},
            "spans": {k: v for k, v in timers.items() if k not in STAGES},
        })
        return m

    def save_state(self, path: str) -> None:
        """Checkpoint the grid as an npz of its fields in the JAX package's
        layout (JAX session.py:789-796), after draining."""
        self.drain()
        with self._glock:
            arrays = self.pipeline.host_state(self._grid)
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str) -> None:
        """Replace the grid by a checkpoint written by either package's
        ``save_state`` (JAX session.py:798-804)."""
        with np.load(path) as z:
            fields = {f: z[f] for f in z.files}
        with self._glock:
            self._grid = self.pipeline.put_state(fields)
            self._errors.clear()

    def close(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
