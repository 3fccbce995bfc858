"""The port's command line: ``synth``, ``fuse`` and ``serve``.

The counterpart of ``hifi_fusion_tpu/runtime/cli.py`` with its
subcommands, flags and outputs, on one explicit ``torch.device``:

* ``synth`` writes a synthetic sweep file (.npz): interleaved xyzrgb
  records (``--wire xyzrgb``) or the sensor-native u16 depth + rgb565 wire
  with its ray table (``--wire depth``); either package's ``fuse`` reads
  it;
* ``fuse`` replays a sweep file, a depth sweep or a capture directory
  (PCD / PLY frames and a TUM or CSV trajectory, ``runtime/capture.py``)
  through a ``FusionSession`` in K-batches (``batch_fill_wait=2.0``), runs
  ``process()`` with ``--export-variants`` and prints one JSON line (with
  the session's ``stage_timers`` and ``spans``); ``--trace DIR`` writes a
  ``torch.profiler`` trace of it, the session's spans as its ranges;
* ``serve`` runs a session behind the line-delimited JSON TCP control
  plane (``_ControlHandler``: start, stop, reset, process, metrics, frame,
  rays, depth_frame, shutdown; ``metrics`` returns ``metrics()``, its
  ``spans`` included); ``--warm`` runs every step once before
  the first frame, ``--live-batching`` lets a backlog drain in K-batches.

Config precedence: flags > JSON config file (its ``"tsdf"`` object holds
the TSDF family's parameters) > ``FusionConfig`` defaults.  The port's own
flag is ``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain
versions).  There is no fallback: ``--device cuda`` without a card raises.
``--devices N`` shards the grid over N slabs (``parallel/sharding.py``;
with ``--device cuda`` shard j on card j % cards, so shards may share a
card), ``--route`` routes points to their owner slabs, ``--route-betas``
sets the send-budget tiers; with ``--devices > 1`` the global config is
validated per shard only, as the JAX CLI does.

    python -m hifi_fusion_tpu_torch.runtime.cli synth --wire depth \\
        --frames 16 --points 307200 --output sweep.npz
    python -m hifi_fusion_tpu_torch.runtime.cli fuse --sweep sweep.npz \\
        --output out --device cuda
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socketserver
import sys
from typing import Callable, Optional

import numpy as np

from ..config import FusionConfig


def _model_params(args) -> dict:
    """TSDF knobs: flags > the JSON config file's "tsdf" object."""
    params = dict(getattr(args, "_tsdf_json", None) or {})
    for flag, key in (("tsdf_truncation", "truncation"),
                      ("tsdf_samples", "n_samples"),
                      ("tsdf_min_weight", "min_weight")):
        v = getattr(args, flag, None)
        if v is not None:
            params[key] = v
    return params


def _build_config(args) -> FusionConfig:
    base = {}
    if getattr(args, "config", None):
        with open(args.config) as f:
            base.update(json.load(f))
    args._tsdf_json = base.pop("tsdf", None)   # TsdfConfig parameters
    if getattr(args, "bbox", None):
        base["bbox"] = tuple(args.bbox)
    if getattr(args, "resolution", None):
        base["resolution"] = (args.resolution,) * 3
    # integer flags compare against None: 0 is meaningful (--refine-every 0
    # disables refinement)
    for flag in ("refine_every", "refine_first", "capacity_log2",
                 "max_points"):
        if getattr(args, flag, None) is not None:
            base[flag] = getattr(args, flag)
    if "bbox" in base:
        base["bbox"] = tuple(base["bbox"])
    if "resolution" in base and not isinstance(base["resolution"], tuple):
        r = base["resolution"]
        base["resolution"] = tuple(r) if hasattr(r, "__len__") else (r,) * 3
    if "z_clip" in base:
        base["z_clip"] = tuple(base["z_clip"])
    cfg = FusionConfig(**base)
    if getattr(args, "devices", 1) > 1:
        # a sharded grid may exceed the single-grid caps (that is what
        # sharding is for); each shard's config is validated instead
        return cfg
    return cfg.validate()


def _device(args):
    """The session's ``torch.device``; ``cuda`` without a card raises."""
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is visible (pass "
                           "--device cpu to run the kernels' plain "
                           "versions)")
    return dev


def _session(args, cfg: FusionConfig, **kw):
    from .session import FusionSession
    return FusionSession(cfg, _device(args), output_dir=args.output,
                         n_devices=args.devices, route=args.route,
                         route_betas=args.route_betas, model=args.model,
                         model_params=_model_params(args), **kw)


def cmd_synth(args) -> int:
    cfg = _build_config(args)
    if args.wire == "depth":
        from ..utils.synthetic import camera_rays, make_depth_sweep
        from .sources import save_depth_sweep
        w = args.width
        h = args.points // w
        fx = args.fx if args.fx else 900.0 * w / 640.0
        rays = camera_rays(w, h, fx=fx, fy=fx)
        frames = make_depth_sweep(cfg, args.frames, width=w, height=h,
                                  srays=rays, seed=args.seed,
                                  noise_sd=3e-4, camera_height=0.4)
        n = save_depth_sweep(args.output, frames, rays)
    else:
        from .sources import SyntheticSource, save_sweep
        src = SyntheticSource(cfg, args.frames, args.points, seed=args.seed)
        n = save_sweep(args.output, src)
    print(f"wrote {n} frames to {args.output}")
    return 0


def cmd_fuse(args) -> int:
    from ..utils.profiling import trace
    from .sources import is_depth_sweep, load_depth_sweep, load_sweep
    cfg = _build_config(args)
    depth_replay = None
    if os.path.isdir(args.sweep):
        from .capture import load_capture
        src = load_capture(args.sweep)
    elif is_depth_sweep(args.sweep):
        depth_replay = load_depth_sweep(args.sweep)
    else:
        src = load_sweep(args.sweep)
    variants = tuple(v for v in (args.export_variants or "").split(",")
                     if v)
    ctx = trace(args.trace) if args.trace else contextlib.nullcontext()
    with ctx, _session(args, cfg, batch_fill_wait=2.0) as sess:
        if depth_replay is not None:
            frames, rays = depth_replay
            sess.start()
            for dq, r565, pose in frames:
                sess.push_depth_frame(dq, r565, pose, rays=rays)
            sess.drain()
        else:
            sess.run_source(src)
        result = sess.process(variants=variants)
        m = sess.metrics()
    print(json.dumps({"n_points": result["n_points"],
                      "cloud": result["cloud"],
                      "metadata": result["metadata"],
                      "variants": result["variants"],
                      "frames_integrated": m["frames_integrated"],
                      "stage_timers": m["stage_timers"],
                      "spans": m["spans"]}))
    return 0


class _ControlHandler(socketserver.StreamRequestHandler):
    """Line-delimited JSON verbs + length-prefixed binary frame ingest.

    Verbs: {"cmd": "start"|"stop"|"reset"|"process"|"metrics"|"shutdown"}
    Frames: {"cmd": "frame", "n": N, "pose": [...16 floats...]} followed by
    N*16 bytes of interleaved x,y,z,rgb float32 records.

    Sensor-native depth wire (4 B a pixel on the socket):
      {"cmd": "rays", "n": N}  + 12*N bytes of (3,N) f32 scaled pinhole
        rays (once per connection camera; utils/synthetic.camera_rays);
      {"cmd": "depth_frame", "n": N, "pose": [...]} + 4*N bytes:
        N little-endian u16 z-depth values then N u16 rgb565 values.
    """

    def handle(self):
        sess = self.server.session                      # type: ignore
        for line in self.rfile:
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                self._reply({"ok": False, "error": "bad json"})
                continue
            cmd = msg.get("cmd")
            if cmd in ("start", "stop"):
                getattr(sess, cmd)()
                self._reply({"ok": True})
            elif cmd == "reset":
                sess.reset(full=bool(msg.get("full", False)))
                self._reply({"ok": True})
            elif cmd == "process":
                try:
                    r = sess.process(
                        variants=tuple(msg.get("variants", ())))
                except TimeoutError as e:
                    self._reply({"ok": False, "error": str(e)})
                    continue
                self._reply({"ok": True, "n_points": r["n_points"],
                             "cloud": r["cloud"],
                             "metadata": r["metadata"],
                             "variants": r["variants"]})
            elif cmd == "metrics":
                self._reply({"ok": True, "metrics": sess.metrics()})
            elif cmd == "frame":
                n = int(msg["n"])
                pose = np.asarray(msg["pose"], np.float64).reshape(4, 4)
                blob = self._read_exact(n * 16)
                if blob is None:   # peer hung up mid-frame
                    return
                from .decode import CloudFrame, PointField
                frame = CloudFrame(
                    data=blob, point_step=16, width=n,
                    fields=[PointField("x", 0), PointField("y", 4),
                            PointField("z", 8), PointField("rgb", 12)])
                accepted = sess.push_frame(frame, pose)
                self._reply({"ok": True, "accepted": accepted})
            elif cmd == "rays":
                n = int(msg["n"])
                blob = self._read_exact(n * 12)
                if blob is None:
                    return
                self._rays = np.frombuffer(blob, "<f4").reshape(3, n).copy()
                self._reply({"ok": True})
            elif cmd == "depth_frame":
                n = int(msg["n"])
                pose = np.asarray(msg["pose"], np.float64).reshape(4, 4)
                blob = self._read_exact(n * 4)
                if blob is None:
                    return
                if getattr(self, "_rays", None) is None:
                    self._reply({"ok": False,
                                 "error": "send rays before depth_frame"})
                    continue
                dq = np.frombuffer(blob, "<u2", count=n)
                r565 = np.frombuffer(blob, "<u2", count=n, offset=2 * n)
                accepted = sess.push_depth_frame(dq, r565, pose,
                                                 rays=self._rays)
                self._reply({"ok": True, "accepted": accepted})
            elif cmd == "shutdown":
                self._reply({"ok": True})
                self.server.shutdown()
                return
            else:
                self._reply({"ok": False, "error": f"unknown cmd {cmd}"})

    def _read_exact(self, n: int) -> Optional[bytes]:
        """Read exactly ``n`` bytes.  A single ``rfile.read(n)`` may return
        short on a TCP stream, and one short read mid-frame would desync
        every later line of the protocol; loop to completion and return
        None on EOF."""
        chunks = []
        got = 0
        while got < n:
            chunk = self.rfile.read(n - got)
            if not chunk:
                return None
            chunks.append(chunk)
            got += len(chunk)
        return b"".join(chunks)

    def _reply(self, obj):
        self.wfile.write((json.dumps(obj) + "\n").encode())
        self.wfile.flush()


def cmd_serve(args, ready: Optional[Callable] = None) -> int:
    """Serve until a ``shutdown`` verb (or an interrupt).  ``ready``, when
    given, is called with the bound server before it serves (its
    ``server_address`` holds the port, also for ``--port 0``)."""
    cfg = _build_config(args)
    session = _session(args, cfg, live_batching=args.live_batching)
    try:
        if args.warm:
            # every step a capture dispatches, depth wire included (a zero
            # ray table; the real rays arrive with the first depth frame),
            # before the first frame: no build or first call mid-capture
            print("warming the session's steps...", flush=True)
            dt = session.warm(extract=True, depth=True)
            print(f"warm in {dt:.1f}s", flush=True)
        with socketserver.ThreadingTCPServer(
                (args.host, args.port), _ControlHandler) as server:
            server.daemon_threads = True
            server.session = session                    # type: ignore
            host, port = server.server_address[:2]
            print(f"fusion control plane on {host}:{port}", flush=True)
            if ready is not None:
                ready(server)
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
    finally:
        session.close()
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="hifi_fusion_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def add_cfg(sp):
        sp.add_argument("--config", help="JSON config file")
        sp.add_argument("--device", default="cuda",
                        help="torch device of the session: cuda (the hand "
                             "kernels) or cpu (their plain versions)")
        sp.add_argument("--devices", type=int, default=1,
                        help="shard the grid into this many x slabs, shard "
                             "j on card j %% cards (cuda) or on --device; "
                             "1 = one grid")
        sp.add_argument("--route", action="store_true",
                        help="with --devices > 1: route points to owner "
                             "slabs instead of replicating frames")
        sp.add_argument("--route-betas", type=float, nargs="+",
                        dest="route_betas",
                        help="send-budget tier ladder for --route (beta ~= "
                             "receive lanes per shard / (points/shard)); "
                             "default '2 n_devices' is lossless")
        sp.add_argument("--bbox", type=float, nargs=6,
                        metavar=("XMIN", "XMAX", "YMIN", "YMAX",
                                 "ZMIN", "ZMAX"))
        sp.add_argument("--resolution", type=float)
        sp.add_argument("--refine-every", type=int, dest="refine_every")
        sp.add_argument("--refine-first", type=int, dest="refine_first",
                        help="shift refine marks to FIRST, FIRST+EVERY, "
                             "... (early seed pass + sparse steady "
                             "cadence; 0 = multiples of EVERY)")
        sp.add_argument("--capacity-log2", type=int, dest="capacity_log2")
        sp.add_argument("--max-points", type=int, dest="max_points")
        sp.add_argument("--model", choices=("fusion", "tsdf"),
                        default="fusion",
                        help="device model family: the cylinder-filtered "
                             "fusion pipeline, or the TSDF weighted-average "
                             "variant (models/tsdf.py)")
        sp.add_argument("--tsdf-truncation", type=float,
                        dest="tsdf_truncation",
                        help="TSDF truncation band tau in meters")
        sp.add_argument("--tsdf-samples", type=int, dest="tsdf_samples",
                        help="ray samples inside +-tau")
        sp.add_argument("--tsdf-min-weight", type=float,
                        dest="tsdf_min_weight",
                        help="extraction weight gate")

    sp = sub.add_parser("synth", help="generate a synthetic sweep .npz")
    add_cfg(sp)
    sp.add_argument("--frames", type=int, default=20)
    sp.add_argument("--points", type=int, default=4096)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--wire", choices=("xyzrgb", "depth"),
                    default="xyzrgb",
                    help="sweep format: interleaved float records, or the "
                         "sensor-native u16 depth + rgb565 wire (4 B/px)")
    sp.add_argument("--width", type=int, default=640,
                    help="depth-wire image width (points = width*height)")
    sp.add_argument("--fx", type=float,
                    help="depth-wire focal length in px (default scales "
                         "900 at 640 wide)")
    sp.add_argument("--output", required=True)
    sp.set_defaults(fn=cmd_synth)

    sp = sub.add_parser("fuse", help="replay a sweep and export the cloud")
    add_cfg(sp)
    sp.add_argument("--sweep", required=True,
                    help=".npz sweep file OR a capture directory of "
                         "PCD/PLY frames + poses.tum/poses.csv")
    sp.add_argument("--output", default=".")
    sp.add_argument("--export-variants", dest="export_variants",
                    help="comma list of extra clouds to write: "
                         "hq,classified,xyzrgb,normals")
    sp.add_argument("--trace", help="write a torch.profiler trace to this "
                                    "dir")
    sp.set_defaults(fn=cmd_fuse)

    sp = sub.add_parser("serve", help="run the TCP control plane")
    add_cfg(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=7061)
    sp.add_argument("--output", default=".")
    sp.add_argument("--warm", action="store_true",
                    help="run every step the session dispatches once "
                         "before accepting frames")
    sp.add_argument("--live-batching", dest="live_batching",
                    action="store_true",
                    help="batch K queued frames per dispatch during "
                         "backlogs (never delays a frame); use with "
                         "--warm")
    sp.set_defaults(fn=cmd_serve)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
