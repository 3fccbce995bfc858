"""Capture sources: where frames+poses come from (survey §2 C3 equivalent).

A copy of ``hifi_fusion_tpu/runtime/sources.py`` (numpy only); the files
it writes load in either package.

The reference ingests via a ROS subscriber paired with TF lookups
(onReceivedPointCloud, FUSION.cpp:327-349).  Transport here is an interface:
a source yields ``(CloudFrame, pose)`` pairs; the session drains it (live
push is also supported).  Provided sources:

* ``ReplaySource``    — replays a recorded sweep (the primary offline path;
                        the reference has no recording story at all).
* ``SyntheticSource`` — wraps utils.synthetic sweeps for tests/benchmarks.

``save_sweep``/``load_sweep`` persist sweeps as .npz (poses + interleaved
frames), giving the framework a capture format independent of ROS bags.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import FusionConfig
from ..utils import synthetic
from .decode import CloudFrame, make_cloud_frame


class Source:
    """Iterable of (CloudFrame, pose(4,4) f64) pairs."""

    def __iter__(self) -> Iterator[Tuple[CloudFrame, np.ndarray]]:
        raise NotImplementedError


class ReplaySource(Source):
    def __init__(self, frames: List[CloudFrame], poses: List[np.ndarray]):
        assert len(frames) == len(poses)
        self.frames = frames
        self.poses = poses

    def __len__(self) -> int:
        return len(self.frames)

    def __iter__(self):
        return iter(zip(self.frames, self.poses))


class SyntheticSource(Source):
    def __init__(self, config: FusionConfig, n_frames: int,
                 points_per_frame: int, seed: int = 0, **kw):
        self._sweep = synthetic.make_sweep(config, n_frames,
                                           points_per_frame, seed=seed, **kw)

    def __len__(self) -> int:
        return len(self._sweep)

    def __iter__(self):
        for fr in self._sweep:
            yield (make_cloud_frame(fr.points_cam, fr.rgb), fr.pose)


def save_sweep(path: str, source: Source) -> int:
    """Persist a source's frames to an .npz sweep file."""
    blobs, steps, widths, heights, poses = [], [], [], [], []
    n = 0
    for frame, pose in source:
        blobs.append(np.frombuffer(frame.data, np.uint8))
        steps.append(frame.point_step)
        widths.append(frame.width)
        heights.append(frame.height)
        poses.append(np.asarray(pose, np.float64))
        n += 1
    np.savez_compressed(
        path,
        data=np.concatenate(blobs) if blobs else np.zeros(0, np.uint8),
        sizes=np.asarray([b.size for b in blobs], np.int64),
        point_step=np.asarray(steps, np.int64),
        width=np.asarray(widths, np.int64),
        height=np.asarray(heights, np.int64),
        poses=np.stack(poses) if poses else np.zeros((0, 4, 4)),
    )
    return n


def load_sweep(path: str) -> ReplaySource:
    z = np.load(path)
    sizes = z["sizes"]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    frames, poses = [], []
    for i in range(sizes.shape[0]):
        blob = z["data"][offsets[i]:offsets[i + 1]].tobytes()
        frames.append(CloudFrame(
            data=blob,
            point_step=int(z["point_step"][i]),
            width=int(z["width"][i]),
            height=int(z["height"][i]),
            fields=_default_fields(),
        ))
        poses.append(z["poses"][i])
    return ReplaySource(frames, poses)


def _default_fields():
    from .decode import PointField
    return [PointField("x", 0), PointField("y", 4), PointField("z", 8),
            PointField("rgb", 12)]


# ---------------------------------------------------------------------------
# Sensor-native depth sweeps: the production wire format (u16 z-depth +
# rgb565 + ray table), 4 B/pixel on disk and on the host->device link vs
# 16-25 planar, replayed through ``FusionSession.push_depth_frame``.
# ---------------------------------------------------------------------------

def save_depth_sweep(path: str, frames, rays: np.ndarray) -> int:
    """Persist a list of utils.synthetic.DepthFrame (or any objects with
    .depth_q/.rgb565/.pose) plus the camera ray table."""
    np.savez_compressed(
        path,
        depth_q=np.stack([np.asarray(f.depth_q, np.uint16)
                          for f in frames]),
        rgb565=np.stack([np.asarray(f.rgb565, np.uint16) for f in frames]),
        poses=np.stack([np.asarray(f.pose, np.float64) for f in frames]),
        rays=np.asarray(rays, np.float32),
    )
    return len(frames)


def load_depth_sweep(path: str):
    """-> (list of (depth_q, rgb565, pose), rays) for push_depth_frame."""
    z = np.load(path)
    frames = [(z["depth_q"][i], z["rgb565"][i], z["poses"][i])
              for i in range(z["depth_q"].shape[0])]
    return frames, z["rays"]


def is_depth_sweep(path: str) -> bool:
    try:
        with np.load(path) as z:
            return "depth_q" in z.files
    except Exception:
        return False
