"""The PointCloud2 ingest path of the port against the JAX package's.

Both packages get the same numpy inputs (one seeded ``make_sweep``).  The
planar frontend is compared bit for bit (world, id, validity, colour);
``integrate_batch`` and ``step`` by cell id after two batches with a
refine between them, and after eight single frames with the cadenced
refines:

* n_pts, normal_found, viewpoint, occupancy bits, dependants, buffer and
  every counter: exact;
* normals: 1e-5 (``checks.py``: the refine's eigen solve rounds
  differently in the two packages);
* rgb_sum: rtol 1e-6 (integer-valued sums, so in fact exact);
* cylinder statistics: hits exact, sums under ``checks.cyl_stats_error``.

The q16 wire (u16 points, packed u32 colour, a count prefix) is held to
the JAX package fed the same frames' dequantized f32 points, which
``pack_frame_q16`` makes exactly what the device reconstructs.
``decode_frame`` is held to the JAX package's on the same records, and
the session's ``push_frame`` replay of a depth sweep's points to its
``push_depth_frame`` replay.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu import grid as jgrid
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import pipeline as jpipe
from hifi_fusion_tpu.ops import integrate as jint
from hifi_fusion_tpu.ops.refine import refine_pass as jax_refine
from hifi_fusion_tpu.runtime import decode as jdecode
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import integrate
from hifi_fusion_tpu_torch.runtime import decode
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                   make_depth_sweep,
                                                   make_sweep,
                                                   pack_frame_q16, pad_frame)

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0),
          max_points=1024)
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
N = CFG.max_points
FRAMES = make_sweep(CFG, 8, 900, seed=5)
PADDED = [pad_frame(f, N) for f in FRAMES]
PACKED = [pack_frame_q16(f, N) for f in FRAMES]
EXACT = ("cell", "n_pts", "normal_found", "dep_count", "dep", "viewpoint",
         "occ_bits", "buffer")
COUNTERS = ("buf_count", "overflow_probe", "overflow_buf", "overflow_dep",
            "overflow_refine", "overflow_active", "frames")


def _wire(wire, idx):
    """The port's inputs for frames ``idx``: ``(points, rgb, mask, poses,
    quant)`` numpy arrays, and the JAX reference's f32 ``(points, rgb,
    mask, poses)``."""
    poses = np.stack([FRAMES[i].pose for i in idx])
    if wire == "f32":
        pts = np.stack([PADDED[i].points_cam for i in idx])
        rgb = np.stack([PADDED[i].rgb for i in idx])
        mask = np.stack([PADDED[i].mask for i in idx])
        return (pts, rgb, mask, poses, None), (pts, rgb, mask, poses)
    pk = [PACKED[i] for i in idx]
    port = (np.stack([p.points_q for p in pk]),
            np.stack([p.rgb_u32 for p in pk]),
            np.asarray([p.count for p in pk], np.int32), poses,
            np.stack([p.quant for p in pk]))
    ref = (np.stack([p.points_f32 for p in pk]),
           np.stack([PADDED[i].rgb for i in idx]),
           np.stack([PADDED[i].mask for i in idx]), poses)
    return port, ref


def _t(arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


def _assert_same_grid(port_grid, jax_grid):
    got = checks.by_cell(convert.grid_to_numpy(port_grid), CFG)
    want = checks.by_cell({f: np.asarray(getattr(jax_grid, f))
                           for f in jax_grid._fields}, CFG)
    assert got["cell"].size > 100
    for f in EXACT:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in COUNTERS:
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["rgb_sum"], want["rgb_sum"], rtol=1e-6)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
    ok, err = checks.cyl_stats_error(got["cyl_stats"], want["cyl_stats"],
                                     CFG.cylinder_radius)
    assert ok, err
    assert want["cyl_stats"][:, 4].sum() > 0


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's grids: two K=4 ``integrate_batch`` calls with a
    refine after the first, and eight ``fusion_step`` calls, for the f32
    points and for the q16 frames' dequantized points."""
    out = {}
    for wire in ("f32", "q16"):
        g = jgrid.make_grid(JCFG)
        for b in range(2):
            _, ref = _wire(wire, range(4 * b, 4 * b + 4))
            g = jpipe.integrate_batch(g, *map(jnp.asarray, ref),
                                      config=JCFG)
            if b == 0:
                g = jax_refine(g, config=JCFG)
        out["batch", wire] = g
        g = jgrid.make_grid(JCFG)
        for i in range(8):
            _, ref = _wire(wire, [i])
            g = jpipe.fusion_step(g, *(jnp.asarray(a[0]) for a in ref),
                                  config=JCFG)
        out["step", wire] = g
    return out


@pytest.mark.parametrize("wire", ["f32", "q16"])
def test_integrate_batch_vs_jax(jax_runs, wire):
    pipe = FusionPipeline(CFG, "cpu")
    g = pipe.init()
    for b in range(2):
        port, _ = _wire(wire, range(4 * b, 4 * b + 4))
        pts, rgb, mask, poses, quant = _t(port)
        pipe.step_batch(g, pts, rgb, mask, poses, quant=quant)
        if b == 0:
            pipe.refine(g)
    _assert_same_grid(g, jax_runs["batch", wire])


@pytest.mark.parametrize("wire", ["f32", "q16"])
def test_step_vs_jax_fusion_step(jax_runs, wire):
    """Eight single frames; ``step`` refines at frames 4 and 8 as
    ``fusion_step`` does."""
    pipe = FusionPipeline(CFG, "cpu")
    g = pipe.init()
    for i in range(8):
        port, _ = _wire(wire, [i])
        pts, rgb, mask, poses, quant = _t(port)
        pipe.step(g, pts[0], rgb[0], mask[0], poses[0],
                  quant=None if quant is None else quant[0])
    assert int(g.normal_found.sum()) > 0
    _assert_same_grid(g, jax_runs["step", wire])


def _face_points(seed=0, n=1500):
    """Camera points whose world images (under a look-down pose with an
    exact translation) sit on cell faces, in cell interiors, just outside
    the bbox and outside the z clip."""
    rng = np.random.default_rng(seed)
    cfg = CFG
    res = np.float32(cfg.resolution[0])
    c = rng.integers(-2, max(cfg.dims) + 2, (3, n))
    w = (np.asarray(cfg.origin, np.float32)[:, None]
         + c.astype(np.float32) * res).astype(np.float32)
    w[:, ::3] += (rng.random((3, w[:, ::3].shape[1])) * res).astype(
        np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[1, 1] = pose[2, 2] = -1.0
    pose[2, 3] = 0.5
    cam = np.stack([w[0], -w[1], np.float32(0.5) - w[2]]).astype(np.float32)
    cam[2, ::17] = 20.0                                 # beyond the z clip
    return cam, pose


@pytest.mark.parametrize("wire", ["f32-f32-bool", "f32-565-count",
                                  "q16-u32-count", "q16-f32-bool"])
def test_planar_frontend_vs_jax(wire):
    """``planar_frontend_plain`` (through the wrapper on CPU tensors)
    against the JAX package's frontend, composed from its own functions
    under ``jit``, on two frames of face points."""
    pw, cw, mw = wire.split("-")
    rng = np.random.default_rng(len(wire))
    cams, poses = zip(*(_face_points(s) for s in (1, 2)))
    pts = np.stack(cams)                                 # (2,3,n)
    poses = np.stack(poses)
    K, _, n = pts.shape
    quant = None
    if pw == "q16":
        packed = [pack_frame_q16(dataclasses.replace(
            FRAMES[0], points_cam=np.ascontiguousarray(p.T),
            rgb=np.zeros((n, 3), np.float32)), n) for p in pts]
        pts = np.stack([p.points_q for p in packed])
        quant = np.stack([p.quant for p in packed])
    rgb8 = rng.integers(0, 256, (K, 3, n)).astype(np.float32)
    if cw == "f32":
        rgb = rgb8
    elif cw == "u32":
        r = rgb8.astype(np.uint32)
        rgb = (r[:, 0] << 16) | (r[:, 1] << 8) | r[:, 2]
    else:
        rgb = rng.integers(0, 1 << 16, (K, n)).astype(np.uint16)
    if mw == "bool":
        mask = rng.random((K, n)) < 0.9
    else:
        mask = np.asarray([n, n - 300], np.int32)

    world, ids, trgb = integrate.planar_frontend(
        *_t((pts, rgb, mask, poses)), CFG,
        quant=None if quant is None else torch.from_numpy(quant))

    front = jax.jit(lambda p, m, t: jint._frontend(p, m, t, JCFG))
    jw, ji, jv = [], [], []
    for k in range(K):
        # the JAX package's single-frame wires (integrate.py:110-175)
        pc, jrgb, jm = jint._unpack_inputs(
            jnp.asarray(pts[k]), jnp.asarray(rgb[k]),
            jnp.asarray(mask[k]), None if quant is None
            else jnp.asarray(quant[k]))
        w_, i_, v_ = front(pc, jm, jnp.asarray(poses[k]))
        jw.append(np.asarray(w_))
        ji.append(np.asarray(i_))
        jv.append(np.asarray(v_))
        np.testing.assert_array_equal(
            trgb.numpy()[:, k * n:(k + 1) * n], np.asarray(jrgb))
    jw = np.concatenate(jw, axis=1)
    ji, jv = np.concatenate(ji), np.concatenate(jv)
    ids = ids.numpy()
    assert 0 < jv.sum() < jv.size
    np.testing.assert_array_equal(ids != np.iinfo(np.int32).max, jv)
    np.testing.assert_array_equal(ids[jv], ji[jv])
    np.testing.assert_array_equal(world.numpy(), jw)


def _cloud(seed, n, point_step, height=1):
    """A CloudFrame of ``n`` records of ``point_step`` bytes with x, y, z
    and rgb at scattered offsets and random filler between them."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, point_step), dtype=np.uint8)
    offs = {16: {"x": 0, "y": 4, "z": 8, "rgb": 12},
            32: {"x": 4, "y": 12, "z": 20, "rgb": 28},
            18: {"x": 1, "y": 5, "z": 9, "rgb": 14}}[point_step]
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    for a, name in enumerate("xyz"):
        raw[:, offs[name]:offs[name] + 4] = xyz[:, a:a + 1].view(np.uint8)
    fields = [decode.PointField(k, o) for k, o in offs.items()]
    jfields = [jdecode.PointField(k, o) for k, o in offs.items()]
    return (decode.CloudFrame(raw.tobytes(), point_step, n // height,
                              height, fields),
            jdecode.CloudFrame(raw.tobytes(), point_step, n // height,
                               height, jfields))


@pytest.mark.parametrize("point_step,height,bug", [
    (16, 1, False), (32, 1, False), (32, 4, False), (16, 3, True),
    (18, 2, True)])
def test_decode_frame_vs_jax(point_step, height, bug):
    """Aligned layouts (16- and 32-byte steps, word views) and an
    unaligned one (an 18-byte step, byte copies), organized clouds and
    the blue-shift bug."""
    frame, jframe = _cloud(point_step + height, 240, point_step, height)
    xyz, rgb = decode.decode_frame(frame, blue_shift_bug=bug)
    jxyz, jrgb = jdecode.decode_frame(jframe, blue_shift_bug=bug)
    assert xyz.shape == (240, 3) and xyz.dtype == np.float32
    np.testing.assert_array_equal(xyz, jxyz)
    np.testing.assert_array_equal(rgb, jrgb)
    m = decode.make_cloud_frame(xyz, rgb)
    jm = jdecode.make_cloud_frame(jxyz, jrgb)
    assert m.data == jm.data and m.point_step == jm.point_step == 16
    np.testing.assert_array_equal(decode.decode_frame(m)[0], xyz)


# the session replay: one depth sweep, pushed as depth frames and as the
# PointCloud2 records of its valid pixels
SKW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
SCFG = small_test_config(**SKW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
DEPTH = make_depth_sweep(SCFG, 8, width=64, height=64, srays=RAYS, seed=2,
                         noise_sd=3e-4, camera_height=0.4)


def _rgb8(rgb565):
    v = rgb565.astype(np.uint32)
    return np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                     (v & 0x1F) * 8], axis=1).astype(np.float32)


def _session_replay(kind, tmp, **kw):
    with FusionSession(SCFG, "cpu", output_dir=tmp, batch_fill_wait=2.0,
                       **kw) as s:
        s.start()
        for f in DEPTH:
            if kind == "depth":
                assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                          rays=RAYS)
            else:
                keep = f.depth_q > 0
                assert s.push_frame(decode.make_cloud_frame(
                    f.points_f32[:, keep].T, _rgb8(f.rgb565[keep])),
                    f.pose)
        assert s.drain(600)
        return s.metrics(), s.process()


def test_push_frame_replay_equals_depth_replay(tmp_path):
    md, rd = _session_replay("depth", str(tmp_path / "d"))
    mc, rc = _session_replay("cloud", str(tmp_path / "c"))
    for m in (md, mc):
        assert m["frames_integrated"] == 8 and m["dispatch_errors"] == 0
        assert m["pose_failures"] == m["frames_truncated"] == 0
        assert m["points_truncated"] == 0
    assert mc["decode_s"] > 0 and md["decode_s"] == 0
    a, b = rc["host"], rd["host"]
    assert rc["n_points"] == rd["n_points"] > 100
    for f in ("cell", "count", "n_pts", "rgb"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("centroid", "normal", "mean_dist"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)
    assert rc["grid_metrics"] == rd["grid_metrics"]


def test_push_frame_pose_provider_and_gates():
    calls = []

    def provider(frame):
        calls.append(frame.stamp)
        if frame.stamp == 1.0:
            raise LookupError("no transform at that stamp")
        return DEPTH[0].pose

    f = DEPTH[0]
    xyz = f.points_f32[:, f.depth_q > 0].T
    with FusionSession(SCFG, "cpu", pose_provider=provider) as s:
        assert not s.push_frame(decode.make_cloud_frame(xyz))  # not started
        s.start()
        assert s.push_frame(decode.make_cloud_frame(xyz, stamp=0.0))
        assert not s.push_frame(decode.make_cloud_frame(xyz, stamp=1.0))
        assert s.push_frame(decode.make_cloud_frame(xyz, stamp=2.0),
                            pose=f.pose)
        assert s.drain(600)
        m = s.metrics()
    assert calls == [0.0, 1.0]
    assert m["pose_failures"] == 1 and m["frames_received"] == 4
    assert m["frames_integrated"] == 2 and m["dispatch_errors"] == 0
    with FusionSession(SCFG, "cpu") as s:
        s.start()
        with pytest.raises(ValueError):
            s.push_frame(decode.make_cloud_frame(xyz))
    # the TSDF family takes clouds through its planar step (A8b)
    with FusionSession(SCFG, "cpu", model="tsdf") as s:
        s.start()
        assert s.push_frame(decode.make_cloud_frame(xyz), f.pose)
        assert s.drain(600)
        m = s.metrics()
    assert m["frames_integrated"] == 1 and m["dispatch_errors"] == 0


def test_push_frame_truncates_and_counts():
    """A cloud wider than ``max_points`` is cut and counted, as the JAX
    session's ``_decode_planar`` counts it; the cut frame integrates as
    its first ``max_points`` points."""
    from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
    f = DEPTH[0]
    keep = f.depth_q > 0
    xyz = f.points_f32[:, keep].T
    cfg = dataclasses.replace(SCFG, max_points=3000).validate()
    jcfg = jax_config(**SKW, max_points=3000)
    assert xyz.shape[0] > 3000
    frame = decode.make_cloud_frame(xyz, _rgb8(f.rgb565[keep]))
    with FusionSession(cfg, "cpu") as s:
        s.start()
        assert s.push_frame(frame, f.pose)
        assert s.drain(600)
        m = s.metrics()
        got = convert.grid_to_numpy(s._grid)
    js = JaxSession(jcfg)
    js.close()
    jframe = jdecode.CloudFrame(frame.data, 16, frame.width, 1,
                                [jdecode.PointField(p.name, p.offset)
                                 for p in frame.fields])
    js._decode_planar(jframe, jcfg)
    jm = {k: getattr(js, "_" + k) for k in ("frames_truncated",
                                            "points_truncated")}
    assert m["frames_truncated"] == jm["frames_truncated"] == 1
    assert m["points_truncated"] == jm["points_truncated"] \
        == xyz.shape[0] - 3000
    g = FusionPipeline(cfg, "cpu").init()
    pts, rgb, pose = _t((xyz[:3000].T, _rgb8(f.rgb565[keep])[:3000].T,
                         f.pose))
    integrate.integrate(g, pts, rgb, torch.tensor(3000, dtype=torch.int32),
                        pose, cfg)
    want = convert.grid_to_numpy(g)
    for k in ("key", "n_pts", "rgb_sum"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _clouds():
    """The depth sweep's frames as PointCloud2 records of their valid
    pixels, for the port and for the JAX package."""
    out = []
    for f in DEPTH:
        keep = f.depth_q > 0
        frame = decode.make_cloud_frame(f.points_f32[:, keep].T,
                                        _rgb8(f.rgb565[keep]))
        jframe = jdecode.CloudFrame(frame.data, 16, frame.width, 1,
                                    [jdecode.PointField(p.name, p.offset)
                                     for p in frame.fields])
        out.append((frame, jframe, f.pose))
    return out


def _cloud_session(session, clouds, **kw):
    with session(output_dir=kw.pop("output_dir"), **kw) as s:
        s.start()
        for c in clouds:
            assert s.push_frame(*c)
        assert s.drain(600)
        m = s.metrics() if isinstance(s, FusionSession) else None
        return m, s.process(extra_fields=("cell", "count", "n_pts", "rgb",
                                          "centroid", "normal",
                                          "mean_dist"))


@pytest.mark.parametrize("fill_wait", [2.0, 0.0], ids=["k4", "k1"])
def test_push_frame_records_vs_jax_session(tmp_path, fill_wait):
    """A fusion session decodes its clouds on the card's record wire; its
    extract is the JAX session's, which decodes them on the host, whether
    the frames come as K=4 batches or one by one."""
    from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
    clouds = _clouds()
    m, got = _cloud_session(
        lambda **kw: FusionSession(SCFG, "cpu", **kw),
        [(f, p) for f, _, p in clouds], output_dir=str(tmp_path / "port"),
        batch_fill_wait=fill_wait)
    _, want = _cloud_session(
        lambda **kw: JaxSession(jax_config(**SKW), **kw),
        [(j, p) for _, j, p in clouds], output_dir=str(tmp_path / "jax"),
        batch_fill_wait=2.0)
    assert m["frames_integrated"] == 8 and m["dispatch_errors"] == 0
    assert m["cloud_frames_card_decoded"] == 8
    assert m["cloud_frames_host_decoded"] == 0
    assert "decode.native" not in m["spans"]
    a, b = got["host"], want["host"]
    assert got["n_points"] == want["n_points"] > 100
    for f in ("cell", "count", "n_pts", "rgb"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for f in ("centroid", "normal", "mean_dist"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)


@pytest.mark.parametrize("kind", ["tsdf", "sharded"])
def test_host_decode_sessions_count_it(kind):
    """The TSDF family and a sharded session keep the host decode: the
    counters and the host decode's spans say so."""
    kw = ({"model": "tsdf"} if kind == "tsdf"
          else {"n_devices": 2, "route": True})
    with FusionSession(SCFG, "cpu", batch_fill_wait=2.0, **kw) as s:
        s.start()
        for f, _, pose in _clouds():
            assert s.push_frame(f, pose)
        assert s.drain(600)
        m = s.metrics()
    assert m["frames_integrated"] == 8 and m["dispatch_errors"] == 0
    assert m["cloud_frames_host_decoded"] == 8
    assert m["cloud_frames_card_decoded"] == 0
    st, sp = m["stage_timers"], m["spans"]
    assert st["decode"]["count"] == 2
    assert sp["decode.native"]["count"] == 8
    # a frame's copy, and the batch's allocation before the first
    assert sp["decode.pack"]["count"] == 8 + 2
    assert (sp["decode.native"]["total_s"] + sp["decode.pack"]["total_s"]
            <= st["decode"]["total_s"] + 1e-5)


def test_malformed_clouds_raise_and_drop():
    """A cloud without z, one whose buffer is short and one with a field
    past its record fail their dispatch with the decode's ValueError and
    are dropped; the session goes on with the next frame."""
    f, _, pose = _clouds()[0]
    bad = [dataclasses.replace(f, fields=[p for p in f.fields
                                          if p.name != "z"]),
           dataclasses.replace(f, data=f.data[:-16]),
           dataclasses.replace(f, fields=f.fields[:3]
                               + [decode.PointField("rgb", 14)])]
    with FusionSession(SCFG, "cpu") as s:
        s.start()
        for b in bad + [f]:
            assert s.push_frame(b, pose)
        assert s.drain(600)
        m = s.metrics()
        errors = list(s._errors)
    assert m["dispatch_errors"] == 3
    assert all(isinstance(e, ValueError) for e in errors)
    assert m["frames_integrated"] == m["cloud_frames_card_decoded"] == 1


def test_malformed_depth_raises_and_drops():
    """A depth frame whose colour is shorter, and one whose colour is
    longer, than its image fail their dispatch with the push's ValueError
    and are dropped; the session goes on with the next frame."""
    f = DEPTH[0]
    bad = [f.rgb565[:-8], np.concatenate([f.rgb565, f.rgb565[:8]])]
    with FusionSession(SCFG, "cpu") as s:
        s.start()
        for rgb in bad + [f.rgb565]:
            assert s.push_depth_frame(f.depth_q, rgb, f.pose, rays=RAYS)
        assert s.drain(600)
        m = s.metrics()
        errors = list(s._errors)
    assert m["dispatch_errors"] == 2
    assert all(isinstance(e, ValueError) for e in errors)
    assert m["frames_integrated"] == 1
