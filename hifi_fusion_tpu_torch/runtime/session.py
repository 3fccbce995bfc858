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
  and counts it in ``pose_failures``.  Its record layout is checked
  (``decode.record_fields``) and its first ``max_points`` records are
  copied as they arrived into a staging row; the worker cuts it to
  ``max_points`` (counted in ``frames_truncated`` /
  ``points_truncated``) and fills the device batch from the rows.  A
  single fusion grid integrates them through the planar frontend's record
  wire, kernel K5, which decodes them on the card
  (``cloud_frames_card_decoded``); the TSDF family and sharded sessions
  decode each row's records on the host (``native.decode_xyzrgb``) into
  the planar f32 wire (``cloud_frames_host_decoded``): kernel T2p, or
  routing and K5;
* ``run_source(source)`` pushes every ``(frame, pose)`` of a
  ``runtime/sources.Source`` and drains;
* ``push_depth_frame(depth_q, rgb565, pose, rays)`` queues one frame
  (u16 z-depth, rgb565, camera pose; the (3,N) ray table on first use),
  copied into a staging row; a frame wider than ``max_points`` is cut and
  counted the same way;
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
  the grid's, and for the TSDF family the batch sort's counts over the
  session grid's sorts (``sort_batches``, ``sort_passes``,
  ``sort_lanes_out_of_range``: ``TsdfPipeline.sort_metrics``); the
  command line's ``metrics`` control verb returns them.

Each stage and span is one ``utils/profiling`` span: host seconds, count
and mean in ``metrics()`` (``{total_s, count, mean_ms}``) and, while
``torch.profiler`` records, a range of the same name on the trace
(``device_step``'s range is ``step``).  The spans split the stages:

* ``batch_wait``: the worker asleep waiting for a K-batch to fill;
* ``decode``, once a cloud dispatch: on the record wire the count of the
  cut to ``max_points`` alone (the layout was checked at push time); on
  the host decode it holds ``decode.native`` / ``decode.pack``, once a
  frame: the native decode of its row's records, and the cut counted and
  their copy into the padded batch; ``decode.pack`` once more a batch,
  the zeroed batch's allocation;
* ``push.stage``, once a frame that takes a row of the session's ring, on
  the pushing thread: the frame's bytes copied into its row;
* ``device_step.stage`` / ``.upload`` / ``.launch`` (in ``device_step``),
  once a dispatch: the host's staging of the batch (its rows grouped into
  runs), its copies to the device (from the rows, non-blocking; on the
  host decode the poses so, the decoded batch by ``put``), the
  pipeline's step call;
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
never delayed.  A batch holds frames of one kind and row layout (clouds
of one point step, or depth frames of one width).  With neither, every
frame is stepped alone.  Before a dispatch the worker waits for the
previous one's device work (``device_wait``), so the host runs at most
one step ahead of the card.

Every queued frame is a staging row (``runtime/staging.py``), copied
before ``push_*`` returns, so the caller may reuse its buffers at once.
The session's ring is allocated at the first well-formed pushed frame,
sharded sessions included, and keeps that frame's layout for the
session's life, across ``reset()``: depth frames of that width, or
records of that point step.  Its rows are pinned on a CUDA device where
they are copied to the card (depth, and a single fusion grid's records)
and plain host memory otherwise; there are ``queue_depth`` + 2 K + 1 of
them (the queue, the frame being pushed while a full queue still holds
the frame it drops, and the two dispatches in flight), so a frame pushed
from one thread always finds one.  A frame of another layout, or one
pushed while every row is held (by concurrent pushers), takes the one
unpinned row of a ring of its own, outside ``push.stage``.  A frame that
fails the push's checks (its record layout, a pose that is not (4,4),
depth that is not 1-D or whose colour has another shape) takes no row:
it is queued with its ValueError, which its dispatch raises.

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
from typing import Callable, Dict, NamedTuple, Optional, Tuple

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
from . import staging
from .decode import CloudFrame, record_fields
from .sources import Source
from .staging import StagingRing

log = logging.getLogger("hifi_fusion_tpu_torch")

# the JAX session's stage names: ``metrics()["stage_timers"]``; every other
# span is under ``metrics()["spans"]``
STAGES = frozenset({"decode", "device_step", "device_wait", "refine",
                    "process_refine", "process_extract", "process_export",
                    "process_csv_wait", "process_metrics", "process_clear"})


class _Frame(NamedTuple):
    """A queued frame: ``kind`` "cloud" or "depth"; ``n``, the points it
    was pushed with; the row ``slot`` of ``ring`` it was copied into, or,
    where the push's checks refused it, no ring and the ``error`` its
    dispatch raises."""
    kind: str
    n: int
    ring: Optional[StagingRing]
    slot: int = -1
    error: Optional[ValueError] = None


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
        # the CUDA events after the last dispatch and the frames whose
        # rows it holds until they have fired
        self._held = ([], [])
        # a single fusion grid decodes clouds on the card (K5's record
        # wire); the TSDF family and the shards take the host decode
        self._card_decode = isinstance(self.pipeline, FusionPipeline)
        # the staging ring, made at the first well-formed frame
        self._ring = None
        self._ring_lock = threading.Lock()
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
        self._cloud_card = 0         # cloud frames decoded by K5
        self._cloud_host = 0         # cloud frames decoded on the host
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
            queued = list(self._queue)
            self._queue.clear()
        self._release(queued)
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
        if planar and self._card_decode:
            # rows of 16-byte records; counts of 0, so nothing is read
            zr = torch.zeros((K, 16 * N), dtype=torch.uint8, device=dev)
            zt = torch.zeros((K, 6), dtype=torch.int32, device=dev)
            g = pipe.step(g, zr[0], None, zt[0], pose)
            if K > 1:
                g = pipe.step_batch(g, zr, None, zt, poses)
        elif planar:
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
        self._enqueue(self._stage_records(frame,
                                          np.asarray(pose, np.float32)))
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
        self._enqueue(self._stage_depth(np.asarray(depth_q, np.uint16),
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

    def _enqueue(self, item: _Frame) -> None:
        """Queue ``item``; a full queue drops its oldest frame, whose row
        is released."""
        gone = None
        with self._qlock:
            if len(self._queue) == self._queue.maxlen:
                self._frames_dropped += 1
                gone = self._queue[0] if self._queue else item
            self._queue.append(item)
        if gone is not None:
            self._release([gone])
        self._wake.set()

    # -- staging ------------------------------------------------------------
    def _stage(self, kind: str, n: int, key: tuple,
               fields: Dict[str, tuple], fill: Callable) -> _Frame:
        """The queued frame of ``kind`` and ``n`` points that ``fill(ring,
        slot)`` copied into a row of layout ``key``: a row of the
        session's ring (the span ``push.stage``) where it holds that
        layout and a row is free, else the one row of a ring of the
        frame's own, unpinned.  The first frame makes the session's ring,
        with the rows ``fields`` gives, pinned on a CUDA device where the
        rows are copied to the card: depth, and records K5 decodes (rows
        the host decodes are never copied)."""
        if self._ring is None:
            with self._ring_lock:
                if self._ring is None:
                    pin = self.pipeline.device.type == "cuda" and (
                        key[0] == "depth" or self._card_decode)
                    self._ring = StagingRing(
                        key, fields, self._queue.maxlen + 2 * self._kb + 1,
                        pin=pin)
                    log.info("staging ring: %d rows of %s, %.3f GB of host "
                             "memory", self._ring.rows, key,
                             self._ring.nbytes / 1e9)
        ring = self._ring
        slot = ring.take() if ring.key == key else None
        if slot is None:
            ring = StagingRing(key, fields, 1, pin=False)
            slot = ring.take()
            fill(ring, slot)
        else:
            try:
                with self.timers.stage("push.stage"):
                    fill(ring, slot)
            except BaseException:
                ring.release([slot])
                raise
        return _Frame(kind, n, ring, slot)

    def _stage_depth(self, depth_q, rgb565, pose) -> _Frame:
        """Stage a depth frame, cut to ``max_points``: its u16 depth,
        rgb565 and pose.  A frame that is not a 1-D image with its colour
        alike and a (4,4) pose is queued with the ValueError its dispatch
        raises."""
        if depth_q.ndim != 1 or rgb565.shape != depth_q.shape \
                or pose.shape != (4, 4):
            return _Frame("depth", depth_q.size, None, error=ValueError(
                f"a depth frame needs a 1-D image, its colour alike and a "
                f"(4, 4) pose; got {depth_q.shape}, {rgb565.shape} and "
                f"{pose.shape}"))
        n = min(depth_q.shape[0], self.config.max_points)

        def fill(ring, slot):
            ring.write(slot, "depth", np.ascontiguousarray(depth_q[:n]),
                       2 * n)
            ring.write(slot, "rgb", np.ascontiguousarray(rgb565[:n]), 2 * n)
            ring.write(slot, "pose", np.ascontiguousarray(pose), 64)

        return self._stage("depth", depth_q.shape[0], ("depth", n),
                           {"depth": ((n,), torch.uint16),
                            "rgb": ((n,), torch.uint16),
                            "pose": ((4, 4), torch.float32)}, fill)

    def _stage_records(self, frame: CloudFrame, pose) -> _Frame:
        """Stage a cloud: its first ``max_points`` records, read in place
        from its message, its row of the record wire's frame table
        (``[kept, step, off_x, off_y, off_z, off_rgb]``) and its pose.  A
        frame whose layout check fails, or with another pose shape, is
        queued with the ValueError its dispatch raises."""
        try:
            n, step, *layout = record_fields(frame)
            if pose.shape != (4, 4):
                raise ValueError(f"a cloud's pose must be (4, 4), not "
                                 f"{pose.shape}")
        except ValueError as e:
            return _Frame("cloud", frame.n_points, None, error=e)
        cap = self.config.max_points
        kept = min(n, cap)
        table = np.array([kept, step, *layout], np.int32)

        def fill(ring, slot):
            ring.write(slot, "records", frame.data, kept * step)
            ring.write(slot, "table", table, 24)
            ring.write(slot, "pose", np.ascontiguousarray(pose), 64)

        return self._stage("cloud", n, ("records", cap * step),
                           {"records": ((cap * step,), torch.uint8),
                            "table": ((6,), torch.int32),
                            "pose": ((4, 4), torch.float32)}, fill)

    @staticmethod
    def _release(frames) -> None:
        """Release the rows of ``frames``."""
        for f in frames:
            if f.ring is not None:
                f.ring.release([f.slot])

    # -- worker -----------------------------------------------------------
    @staticmethod
    def _shape(item: _Frame):
        """Frames batch together only when their rows share a layout: a
        cloud's record width, a depth frame's (cut) width.  A frame the
        push refused batches with nothing."""
        return (item.kind,
                item.error if item.ring is None else item.ring.key)

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
        """Host decode of K cloud frames' rows into the planar wire:
        (K,3,N) f32 points and rgb padded to N = ``max_points`` and (K,)
        i32 count prefixes (the ``decode`` stage: a frame's library decode
        of its row's kept records, ``decode.native``, and their repack
        into the padded batch, ``decode.pack``; the zeroed batch is
        allocated first, in a ``decode.pack`` of its own).  The decode is
        per record, so the kept records decode as the whole message's
        first ``max_points`` would."""
        N = self.config.max_points
        k = len(items)
        stage = self.timers.stage
        with stage("decode.pack"):
            pts = np.zeros((k, 3, N), np.float32)
            rgb = np.zeros((k, 3, N), np.float32)
            counts = np.zeros((k,), np.int32)
        for i, f in enumerate(items):
            kept, *layout = f.ring.arrays["table"][f.slot].tolist()
            with stage("decode.native"):
                xyz, col = native.decode_xyzrgb(
                    f.ring.arrays["records"][f.slot].numpy(), kept, *layout,
                    self.config.bug_compat_blue_shift)
            with stage("decode.pack"):
                self._truncate(f.n, 1, "frame")
                pts[i, :, :kept] = xyz.T
                rgb[i, :, :kept] = col.T
                counts[i] = kept
        return pts, rgb, counts

    def _await_device(self) -> None:
        """Wait until the card has finished the previous dispatch, so the
        host runs at most one step ahead (on the CPU every op has finished
        when it returns, and there is nothing to wait for), then release
        the rows it held."""
        with self._qlock:
            events, frames = self._held
            self._held = ([], [])
        with self.timers.stage("device_wait"):
            for event in events:
                event.synchronize()
        self._release(frames)

    def _dispatch(self, items) -> None:
        if items[0].error is not None:
            raise items[0].error
        cfg = self.config
        k = len(items)
        dev = self.pipeline.device
        stage = self.timers.stage
        cloud = items[0].kind == "cloud"
        records = cloud and self._card_decode
        if records:
            with stage("decode"):
                # the layout was checked and the frame table staged at
                # push time; the cut is counted here
                for f in items:
                    self._truncate(f.n, 1, "frame")
        elif cloud:
            with stage("decode"):
                host = self._decode_planar(items)
        else:
            self._truncate(items[0].n, k, "depth frame")
        self._await_device()
        with stage("device_step"):
            with stage("device_step.stage"):
                runs = staging.runs([(f.ring, f.slot) for f in items])
            with stage("device_step.upload"):
                if records:
                    # the records carry their colour; the frame table
                    # takes the count prefix's place
                    b = staging.batch(runs, k, dev)
                    data, rgb, counts = b["records"], None, b["table"]
                elif cloud:
                    b = staging.batch(runs, k, dev, ("pose",))
                    data, rgb, counts = map(self.pipeline.put, host)
                else:
                    b = staging.batch(runs, k, dev)
                    data, rgb = b["depth"], b["rgb"]
                    counts = torch.full((k,), data.shape[1],
                                        dtype=torch.int32, device=dev)
                poses = b["pose"]
            with stage("device_step.launch"), self._glock:
                if cloud and k == 1:
                    self._grid = self.pipeline.step(
                        self._grid, data[0], rgb if rgb is None else rgb[0],
                        counts[0], poses[0])
                elif cloud:
                    self._grid = self.pipeline.step_batch(
                        self._grid, data, rgb, counts, poses)
                else:
                    rays = self._rays[:, :data.shape[1]].contiguous()
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
        self._frames_integrated += k
        if records:
            self._cloud_card += k
        elif cloud:
            self._cloud_host += k

    def _hold(self, items) -> None:
        """After a dispatch, failed or not: record the events that follow
        its copies and launches, and hold its rows until they have fired
        (with the previous dispatch's, where a failure came before the
        wait for them)."""
        events = []
        for dev in self._cuda:
            with torch.cuda.device(dev):
                events.append(torch.cuda.Event())
                events[-1].record()
        with self._qlock:
            self._held = (events, self._held[1] + list(items))

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
                self._hold(items)
                self._busy = False

    def drain(self, timeout: float = 300.0) -> bool:
        """Block until the queue is empty, the worker idle and the device
        done with every dispatched step (the span ``drain``)."""
        with self.timers.stage("drain"):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._qlock:
                    idle = not self._queue and not self._busy
                    if idle:
                        # the last dispatch's rows, released once the
                        # device is done with it
                        events, frames = self._held
                        self._held = (events, [])
                if idle:
                    for dev in self._cuda:
                        torch.cuda.synchronize(dev)
                    self._release(frames)
                    return True
                time.sleep(0.002)
            return False

    # -- observability ------------------------------------------------------
    def metrics(self) -> Dict:
        with self._glock:
            m = self.pipeline.grid_metrics(self._grid)
            if self.model == "tsdf":
                m.update(self.pipeline.sort_metrics(self._grid))
        timers = self.timers.report()
        m.update({
            "frames_received": self._frames_in,
            "frames_integrated": self._frames_integrated,
            "frames_dropped_backpressure": self._frames_dropped,
            "dispatch_errors": len(self._errors),
            "pose_failures": self._pose_failures,
            "frames_truncated": self._frames_truncated,
            "points_truncated": self._points_truncated,
            "cloud_frames_card_decoded": self._cloud_card,
            "cloud_frames_host_decoded": self._cloud_host,
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
