"""The port's command line (runtime/cli.py) in process with ``--device cpu``
against the JAX package's CLI:

* ``synth`` writes the JAX CLI's arrays, member for member of the npz
  (the zip headers carry write times);
* ``fuse`` of a depth sweep, an xyzrgb sweep, a capture directory of the
  depth sweep's frames (with ``--export-variants``; the fixture directory
  is ``tests/test_torch_capture.py``'s) and ``--model tsdf`` of an xyzrgb
  sweep write
  PCDs and CSVs holding the JAX CLI's cells and counts (positions and
  normals within 1e-5);
* ``serve``: the control plane's round trip, the depth wire and short
  reads (from ``tests/test_serve.py``), and ``cmd_serve`` itself on a
  thread with ``--warm --live-batching``, whose extract equals a direct
  session's;
* ``fuse --devices 2`` and ``--devices 2 --route``: the sharded grid's
  cells and counts equal the JAX CLI's;
* config precedence, ``--trace``, and the refusal of ``--device cuda``
  without a card.

Every socket has a timeout, and every server thread is joined with one.
"""

import contextlib
import dataclasses
import io
import json
import os
import queue
import socket
import socketserver
import threading
import time
import zipfile

import numpy as np
import pytest
import torch

from hifi_fusion_tpu.io import pcd as jpcd
from hifi_fusion_tpu.runtime import cli as jcli
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.io import pcd
from hifi_fusion_tpu_torch.runtime import cli
from hifi_fusion_tpu_torch.runtime.sources import load_depth_sweep
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

CFG_FLAGS = ["--bbox", "-0.32", "0.32", "-0.32", "0.32", "-0.32", "0.32",
             "--resolution", "0.01", "--capacity-log2", "14",
             "--max-points", "4096", "--refine-every", "2"]
TIMEOUT = 60.0


def _zclip(tmp_path, **extra) -> str:
    p = str(tmp_path / "cfg.json")
    with open(p, "w") as f:
        json.dump({"z_clip": [0.05, 10.0], **extra}, f)
    return p


def _run(main, argv):
    """``main(argv)`` with stdout captured; its last line as JSON when it
    parses, else the text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    last = buf.getvalue().strip().splitlines()[-1]
    try:
        return json.loads(last)
    except json.JSONDecodeError:
        return last


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("wire", ["xyzrgb", "depth"])
def test_synth_writes_the_jax_clis_arrays(tmp_path, wire):
    argv = ["synth", "--frames", "3", "--points", "2048", "--seed", "5",
            "--wire", wire, "--width", "64"] + CFG_FLAGS
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert _run(cli.main, argv + ["--output", a]) == f"wrote 3 frames to {a}"
    _run(jcli.main, argv + ["--output", b])
    ma, mb = _members(a), _members(b)
    assert list(ma) == list(mb) and len(ma) >= 3
    for name in ma:
        assert ma[name] == mb[name], name


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """An xyzrgb and a depth sweep written by the JAX CLI, and a capture
    directory of the depth sweep's frames (binary PCDs and a CSV
    trajectory)."""
    tmp = tmp_path_factory.mktemp("sweeps")
    out = {}
    for wire, pts in (("xyzrgb", "1500"), ("depth", "4096")):
        out[wire] = str(tmp / f"{wire}.npz")
        _run(jcli.main, ["synth", "--frames", "4", "--points", pts,
                         "--seed", "3", "--wire", wire, "--width", "64",
                         "--output", out[wire]] + CFG_FLAGS)
    out["capture"] = str(tmp / "capture")
    frames, rays = load_depth_sweep(out["depth"])
    _write_capture(out["capture"], frames, rays)
    return out


def _write_capture(directory, frames, rays) -> None:
    os.makedirs(directory)
    rows = []
    for i, (dq, r565, pose) in enumerate(frames):
        keep = dq > 0
        xyz = np.ascontiguousarray((dq.astype(np.float32) * rays)[:, keep].T)
        v = r565[keep].astype(np.uint32)
        rgb = np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                        (v & 0x1F) * 8], axis=1).astype(np.float32)
        pcd.write_pcd_xyzrgb(os.path.join(directory, f"frame_{i:04d}.pcd"),
                             xyz, rgb, ascii_mode=False)
        rows.append(",".join(repr(float(x)) for x in pose.reshape(-1)))
    with open(os.path.join(directory, "poses.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")


FUSE_CASES = {
    "depth": ([], None),
    "xyzrgb": ([], None),
    "capture": (["--export-variants", "hq,classified"], None),
    "tsdf": (["--model", "tsdf", "--tsdf-min-weight", "2"],
             {"truncation": 0.02, "n_samples": 5, "min_weight": 9.0}),
}


@pytest.mark.parametrize("case", sorted(FUSE_CASES))
def test_fuse_holds_the_jax_clis_cells_and_counts(tmp_path, sweeps, case):
    flags, tsdf = FUSE_CASES[case]
    src = sweeps.get(case, sweeps["xyzrgb"])
    conf = _zclip(tmp_path, **({"tsdf": tsdf} if tsdf else {}))
    argv = ["fuse", "--sweep", src, "--config", conf] + CFG_FLAGS + flags
    got = _run(cli.main, argv + ["--output", str(tmp_path / "port"),
                                 "--device", "cpu"])
    want = _run(jcli.main, argv + ["--output", str(tmp_path / "jax")])
    assert got["n_points"] == want["n_points"] > 20
    assert got["frames_integrated"] == want["frames_integrated"] > 0
    assert set(got["stage_timers"]) >= {"device_step", "process_export"}
    a, n = jpcd.read_pcd(got["cloud"])
    b, _ = jpcd.read_pcd(want["cloud"])
    assert n == got["n_points"] and list(a) == list(b)
    for f in a:
        if f == "rgb":
            np.testing.assert_array_equal(a[f], b[f])
        else:
            np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)
    ma, mb = (jpcd.read_metadata_csv(r["metadata"]) for r in (got, want))
    np.testing.assert_array_equal(ma["count"], mb["count"])
    assert got["variants"].keys() == want["variants"].keys()
    for v, path in got["variants"].items():
        (va, na), (vb, nb) = (jpcd.read_pcd(p) for p in (
            path, want["variants"][v]))
        assert na == nb and os.path.basename(path) == os.path.basename(
            want["variants"][v])
        np.testing.assert_allclose(va["x"], vb["x"], atol=1e-5)


def test_build_config_precedence(tmp_path):
    """Flags > the JSON file > defaults; the file's "tsdf" object and the
    TSDF flags make the model parameters, flags first."""
    conf = _zclip(tmp_path, resolution=0.02, refine_every=3,
                  tsdf={"truncation": 0.02, "n_samples": 7})
    args = cli.parse_args(["fuse", "--sweep", "x", "--config", conf,
                           "--refine-every", "0", "--tsdf-samples", "5"])
    cfg = cli._build_config(args)
    assert cfg.resolution == (0.02, 0.02, 0.02) and cfg.refine_every == 0
    assert cfg.z_clip == (0.05, 10.0)
    assert cli._model_params(args) == {"truncation": 0.02, "n_samples": 5}
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jcli._build_config(args))
    assert args.device == "cuda"


def test_trace_writes_a_profile(tmp_path, sweeps):
    trace_dir = str(tmp_path / "trace")
    _run(cli.main, ["fuse", "--sweep", sweeps["depth"], "--output",
                    str(tmp_path / "out"), "--device", "cpu", "--trace",
                    trace_dir, "--config", _zclip(tmp_path)] + CFG_FLAGS)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.parametrize("flags", [["--devices", "2"],
                                   ["--devices", "2", "--route"]])
def test_sharding_flags_raise(tmp_path, sweeps, flags):
    """``fuse --devices 2`` (replicated) and ``--devices 2 --route`` shard
    the grid and write the JAX CLI's cells and counts (positions within
    1e-5); the sharded session reports its two devices."""
    argv = ["fuse", "--sweep", sweeps["depth"], "--config",
            _zclip(tmp_path)] + CFG_FLAGS + flags
    got = _run(cli.main, argv + ["--output", str(tmp_path / "port"),
                                 "--device", "cpu"])
    want = _run(jcli.main, argv + ["--output", str(tmp_path / "jax")])
    assert got["n_points"] == want["n_points"] > 20
    assert got["frames_integrated"] == want["frames_integrated"] == 4
    a, n = jpcd.read_pcd(got["cloud"])
    b, _ = jpcd.read_pcd(want["cloud"])
    assert n == got["n_points"] and list(a) == list(b)
    for f in a:
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)
    ma, mb = (jpcd.read_metadata_csv(r["metadata"]) for r in (got, want))
    np.testing.assert_array_equal(ma["count"], mb["count"])
    with FusionSession(small_test_config(), "cpu", n_devices=2,
                       route="--route" in flags,
                       output_dir=str(tmp_path)) as s:
        assert s.metrics()["devices"] == 2


def test_device_cuda_without_a_card_raises(tmp_path, sweeps):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["fuse", "--sweep", sweeps["depth"], "--output",
                  str(tmp_path)] + CFG_FLAGS)


# -- serve ------------------------------------------------------------------

def _send(s, obj):
    s.sendall((json.dumps(obj) + "\n").encode())


def _recv(rf):
    return json.loads(rf.readline())


@contextlib.contextmanager
def _server(session):
    """The control plane on 127.0.0.1:0 on a thread; yields its port."""
    server = socketserver.ThreadingTCPServer(("127.0.0.1", 0),
                                             cli._ControlHandler)
    server.daemon_threads = True
    server.session = session
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=TIMEOUT)
        session.close()
        assert not t.is_alive()


def _connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    return s, s.makefile("rb")


def test_serve_roundtrip(tmp_path):
    cfg = small_test_config(refine_every=1)
    with _server(FusionSession(cfg, "cpu", output_dir=str(tmp_path))) as p:
        s, rf = _connect(p)
        with s, rf:
            _send(s, {"cmd": "start"})
            assert _recv(rf)["ok"]
            rng = np.random.default_rng(0)
            n = 500
            rec = np.zeros((n, 4), np.float32)
            rec[:, 0:2] = rng.uniform(-0.25, 0.25, (n, 2))
            rec[:, 2] = 0.1
            _send(s, {"cmd": "frame", "n": n,
                      "pose": np.eye(4).reshape(-1).tolist()})
            s.sendall(rec.tobytes())
            r = _recv(rf)
            assert r["ok"] and r["accepted"]
            _send(s, {"cmd": "metrics"})
            assert _recv(rf)["metrics"]["frames_received"] == 1
            _send(s, {"cmd": "process", "variants": ["classified"]})
            r = _recv(rf)
            assert r["ok"] and r["n_points"] >= 0
            assert "classified" in r["variants"]
            _send(s, {"cmd": "stop"})
            assert _recv(rf)["ok"]
            _send(s, {"cmd": "reset", "full": True})
            assert _recv(rf)["ok"]
            s.sendall(b"not json\n")
            assert not _recv(rf)["ok"]
            _send(s, {"cmd": "nonsense"})
            assert not _recv(rf)["ok"]
            _send(s, {"cmd": "shutdown"})
            assert _recv(rf)["ok"]


def test_serve_short_reads_keep_stream_synced(tmp_path):
    cfg = small_test_config(refine_every=1)
    with _server(FusionSession(cfg, "cpu", output_dir=str(tmp_path))) as p:
        s, rf = _connect(p)
        with s, rf:
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send(s, {"cmd": "start"})
            assert _recv(rf)["ok"]
            n = 400
            rec = np.zeros((n, 4), np.float32)
            rec[:, 2] = 0.1
            blob = rec.tobytes()
            _send(s, {"cmd": "frame", "n": n,
                      "pose": np.eye(4).reshape(-1).tolist()})
            for i in range(0, len(blob), 1000):
                s.sendall(blob[i:i + 1000])
                time.sleep(0.01)
            r = _recv(rf)
            assert r["ok"] and r["accepted"]
            _send(s, {"cmd": "metrics"})
            assert _recv(rf)["metrics"]["frames_received"] == 1
            _send(s, {"cmd": "shutdown"})
            assert _recv(rf)["ok"]


def test_cmd_serve_depth_wire_equals_a_direct_session(tmp_path):
    """``cmd_serve`` on a thread (``--port 0 --warm --live-batching``):
    depth frames before the rays are refused with the stream in sync, then
    rays, six depth frames, metrics, process and shutdown; the cloud holds
    a direct session's cells and counts."""
    cfg = small_test_config(refine_every=2, z_clip=(0.05, 10.0))
    rays = camera_rays(64, 64, fx=80.0, fy=80.0)
    frames = make_depth_sweep(cfg, 6, width=64, height=64, srays=rays,
                              seed=5, noise_sd=1e-4, camera_height=0.4)
    args = cli.parse_args(
        ["serve", "--port", "0", "--device", "cpu", "--warm",
         "--live-batching", "--output", str(tmp_path / "serve"),
         "--config", _zclip(tmp_path)] + CFG_FLAGS)
    ready = queue.Queue()
    with contextlib.redirect_stdout(io.StringIO()):
        t = threading.Thread(target=cli.cmd_serve, args=(args, ready.put),
                             daemon=True)
        t.start()
        server = ready.get(timeout=TIMEOUT)
    n = rays.shape[1]
    try:
        s, rf = _connect(server.server_address[1])
        with s, rf:
            _send(s, {"cmd": "start"})
            assert _recv(rf)["ok"]
            f = frames[0]
            _send(s, {"cmd": "depth_frame", "n": n,
                      "pose": f.pose.reshape(-1).tolist()})
            s.sendall(f.depth_q.astype("<u2").tobytes()
                      + f.rgb565.astype("<u2").tobytes())
            assert not _recv(rf)["ok"]
            _send(s, {"cmd": "rays", "n": n})
            s.sendall(rays.astype("<f4").tobytes())
            assert _recv(rf)["ok"]
            for f in frames:
                _send(s, {"cmd": "depth_frame", "n": n,
                          "pose": f.pose.reshape(-1).tolist()})
                s.sendall(f.depth_q.astype("<u2").tobytes()
                          + f.rgb565.astype("<u2").tobytes())
                r = _recv(rf)
                assert r["ok"] and r["accepted"]
            _send(s, {"cmd": "metrics"})
            m = _recv(rf)["metrics"]
            assert m["frames_received"] == len(frames)
            _send(s, {"cmd": "process"})
            r = _recv(rf)
            assert r["ok"] and r["n_points"] > 50
            _send(s, {"cmd": "shutdown"})
            assert _recv(rf)["ok"]
    finally:
        server.shutdown()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    with FusionSession(cfg, "cpu", output_dir=str(tmp_path / "direct")) \
            as d:
        d.start()
        for f in frames:
            d.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=rays)
        assert d.drain(TIMEOUT)
        want = d.process()
    assert r["n_points"] == want["n_points"]
    np.testing.assert_array_equal(
        jpcd.read_metadata_csv(r["metadata"])["count"],
        jpcd.read_metadata_csv(want["metadata"])["count"])
    a, _ = jpcd.read_pcd(r["cloud"])
    b, _ = jpcd.read_pcd(want["cloud"])
    for k in ("x", "y", "z"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-6)
