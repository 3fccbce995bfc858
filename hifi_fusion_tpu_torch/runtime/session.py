"""FusionSession: the port's host runtime, for sensor-native depth frames.

A lean counterpart of ``hifi_fusion_tpu/runtime/session.py`` with the same
contract:

* ``start()`` / ``stop()`` gate frame ingestion (queued frames still drain);
* ``reset(full=False)`` stops and drops the input queue, keeping the grid
  (``full=True`` also clears the grid);
* ``push_depth_frame(depth_q, rgb565, pose, rays)`` queues one frame
  (u16 z-depth, rgb565, camera pose; the (3,N) ray table on first use);
* ``drain()`` waits until the queue is empty and the device is idle;
* ``process()`` drains, runs the final refine, extracts, writes
  ``test_cloud.pcd`` and ``meta.csv`` to ``output_dir``, then clears the
  grid.

One worker thread pops frames from a bounded drop-oldest queue.  With
``batch_fill_wait > 0`` (replay sources that outrun the device) it waits
up to that long for a full K-batch and integrates K frames at once; K is
the largest value <= ``max_batch_frames`` that divides both
``refine_every`` and ``refine_first``, so a batch never spans a refine
mark and batched and single-stepped sessions refine at the same frames.
With 0 (live sources) every frame is stepped alone.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Dict

import numpy as np
import torch

from ..config import FusionConfig
from ..io import pcd
from ..models.pipeline import FusionPipeline, refine_due

log = logging.getLogger("hifi_fusion_tpu_torch")


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
                 final_refine: bool = True, batch_fill_wait: float = 0.0):
        self.config = config.validate()
        self.pipeline = FusionPipeline(config, device)
        self.output_dir = output_dir
        self.final_refine = final_refine
        self._kb = batch_frames(config) if batch_fill_wait > 0 else 1
        self._batch_fill_wait = float(batch_fill_wait)

        self._queue = collections.deque(maxlen=queue_depth)
        self._qlock = threading.Lock()
        self._glock = threading.Lock()
        self._wake = threading.Event()
        self._shutdown = False
        self._started = False
        self._busy = False
        self._errors = []

        self._grid = self.pipeline.init()
        self._rays = None
        self._frames_in = 0
        self._frames_integrated = 0
        self._frames_dropped = 0
        self._t_first = None
        self._t_last = None
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
                self._grid = self.pipeline.init()

    def process(self, cloud_name: str = "test_cloud.pcd",
                meta_name: str = "meta.csv", ascii_mode: bool = True,
                drain_timeout: float = 300.0) -> Dict:
        """Drain, export the fused cloud and its metadata, clear the grid.
        Raises if the queue does not drain or a frame failed to integrate:
        exporting such a grid would break the snapshot contract."""
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
            with self._glock:
                grid = self._grid
                if self.final_refine and self._needs_final_refine():
                    grid = self.pipeline.refine(grid)
                host = self.pipeline.extract_host(grid)
                metrics = self.pipeline.grid_metrics(grid)
                pcd.write_pcd_xyzrgbnormal(cloud_path, host["centroid"],
                                           host["rgb"], host["normal"],
                                           ascii_mode=ascii_mode)
                pcd.write_metadata_csv(meta_path, host["sd"],
                                       host["mean_dist"], host["sd_dist"],
                                       host["count"])
                self._grid = self.pipeline.init()
        finally:
            self._started = was_started
        n = int(host["cell"].shape[0])
        log.info("PROCESS: %d voxels -> %s", n, cloud_path)
        return {"cloud": cloud_path, "metadata": meta_path, "n_points": n,
                "grid_metrics": metrics, "host": host}

    # -- ingestion --------------------------------------------------------
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
        with self._qlock:
            if len(self._queue) == self._queue.maxlen:
                self._frames_dropped += 1
            self._queue.append((np.asarray(depth_q, np.uint16),
                                np.asarray(rgb565, np.uint16),
                                np.asarray(pose, np.float32)))
        self._wake.set()
        return True

    # -- worker -----------------------------------------------------------
    def _pop_items(self):
        """One frame, or a K-batch when it starts at a K-aligned frame."""
        kb = self._kb
        if kb > 1:
            deadline = time.monotonic() + self._batch_fill_wait
            while not self._shutdown and time.monotonic() < deadline:
                with self._qlock:
                    if (not self._queue or len(self._queue) >= kb
                            or self._frames_integrated % kb != 0):
                        break
                time.sleep(0.001)
        with self._qlock:
            if not self._queue:
                return []
            self._busy = True
            if (kb > 1 and len(self._queue) >= kb
                    and self._frames_integrated % kb == 0
                    and len({f[0].shape for f in
                             list(self._queue)[:kb]}) == 1):
                return [self._queue.popleft() for _ in range(kb)]
            return [self._queue.popleft()]

    def _needs_final_refine(self) -> bool:
        """False iff the cadence already refined at exactly the current
        frame count."""
        f = self._frames_integrated
        if f == 0:
            return False
        if self.config.refine_every <= 0:
            return True
        return not refine_due(f, 1, self.config)

    def _dispatch(self, items) -> None:
        cfg = self.config
        k = len(items)
        n = min(items[0][0].shape[-1], cfg.max_points)
        put = self.pipeline.put
        depth = put(np.stack([f[0][:n] for f in items]))
        rgb = put(np.stack([f[1][:n] for f in items]))
        counts = put(np.full((k,), n, np.int32))
        poses = put(np.stack([f[2] for f in items]))
        rays = self._rays[:, :n].contiguous()
        with self._glock:
            if k == 1:
                self._grid = self.pipeline.step_depth(
                    self._grid, depth[0], rgb[0], counts[0], poses[0], rays)
            else:
                self._grid = self.pipeline.step_batch_depth(
                    self._grid, depth, rgb, counts, poses, rays)
                if cfg.refine_every > 0 and refine_due(
                        self._frames_integrated + k, k, cfg):
                    self._grid = self.pipeline.refine(self._grid)
        now = time.monotonic()
        if self._t_first is None:
            self._t_first = now
        self._t_last = now
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
        done with every dispatched step."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._qlock:
                empty = not self._queue
            if empty and not self._busy:
                if self.pipeline.device.type == "cuda":
                    torch.cuda.synchronize(self.pipeline.device)
                return True
            time.sleep(0.002)
        return False

    # -- observability ------------------------------------------------------
    def metrics(self) -> Dict:
        with self._glock:
            m = self.pipeline.grid_metrics(self._grid)
        dt = (self._t_last - self._t_first
              if self._t_first is not None and self._t_last is not None
              else 0.0)
        m.update({
            "frames_received": self._frames_in,
            "frames_integrated": self._frames_integrated,
            "frames_dropped_backpressure": self._frames_dropped,
            "dispatch_errors": len(self._errors),
            "frames_per_s": ((self._frames_integrated - 1) / dt
                             if dt > 0 else None),
        })
        return m

    def close(self) -> None:
        self._shutdown = True
        self._wake.set()
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
