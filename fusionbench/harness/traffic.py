"""The one generator every traffic mix is read by.

A mix (``fusionbench/traffic/<name>.json``) names its wire (``depth``:
u16 z-depth and rgb565 frames through ``push_depth_frame``; ``pc2``: each
frame's PointCloud2 record through ``push_frame``), the frames of a scan,
the pose spacing (``arc_frames``), the step kind a cycle runs
(``steps/<step>.py``) and how many cycles a traced run records
(``trace_cycles``).  The camera (``width``, ``height``, ``fx``,
``noise_sd``) is the configuration's ``sensor``: it belongs to the
deployment.  The sweep is made once a run from ``--seed``
(``frozen/synthetic.py``) and pushed again in every cycle, so every seed
has the same sizes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..frozen import records
from ..frozen.synthetic import DepthSweep, make_depth_sweep


@dataclasses.dataclass
class Inputs:
    traffic: dict
    sweep: DepthSweep
    clouds: list = None        # (CloudFrame, pose) a frame, pc2 wire

    @property
    def frames(self) -> int:
        return self.sweep.n_frames

    @property
    def points_per_cycle(self) -> int:
        """Input points a cycle pushes: pixels of depth frames, points of
        records."""
        if self.clouds is not None:
            return sum(c.width * c.height for c, _ in self.clouds)
        return self.sweep.depth_q.size

    def push(self, session) -> None:
        """Push every frame of the sweep (a frame the session refuses is
        counted as lost by the check)."""
        if self.clouds is not None:
            for frame, pose in self.clouds:
                session.push_frame(frame, pose)
            return
        s = self.sweep
        for f in range(s.n_frames):
            session.push_depth_frame(s.depth_q[f], s.rgb565[f], s.poses[f],
                                     rays=s.srays)

    def reference_frames(self, device):
        """``(pc (n,3) f32, rgb (n,3) f32, pose (4,4) f32)`` tensors on
        ``device`` a frame, worked out from the raw sweep: the valid
        pixels' camera points and their 8-bit colour."""
        s = self.sweep
        for f in range(s.n_frames):
            ok = s.depth_q[f] > 0
            yield (torch.from_numpy(records.camera_points(s.depth_q[f],
                                                          s.srays)).to(device),
                   torch.from_numpy(records.rgb8(s.rgb565[f][ok])).to(device),
                   torch.from_numpy(s.poses[f]).to(device))


def make_inputs(traffic: dict, cfg: dict, seed: int, device) -> Inputs:
    cam = cfg["sensor"]
    sweep = make_depth_sweep(
        cfg["fusion_config"]["bbox"], int(traffic["frames_per_scan"]),
        int(cam["width"]), int(cam["height"]), float(cam["fx"]), seed=seed,
        noise_sd=float(cam["noise_sd"]),
        arc_frames=int(traffic["arc_frames"]), device=device)
    if traffic["wire"] == "depth":
        return Inputs(traffic, sweep)
    if traffic["wire"] == "pc2":
        from hifi_fusion_tpu_torch.runtime.decode import CloudFrame, PointField
        fields = [PointField(n, off) for n, off in records.FIELDS]
        blocks = records.cloud_records(sweep.depth_q, sweep.rgb565,
                                       sweep.srays)
        clouds = [(CloudFrame(data=b, point_step=records.POINT_STEP,
                              width=len(b) // records.POINT_STEP,
                              fields=list(fields)), sweep.poses[f])
                  for f, b in enumerate(blocks)]
        return Inputs(traffic, sweep, clouds)
    raise ValueError(f"unknown wire {traffic['wire']!r}")

