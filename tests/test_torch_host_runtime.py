"""The port's host runtime against the JAX package's and its own format
oracles.

* The two C++ sources are copies of the JAX package's, byte for byte.
* The native decode (``runtime/native``, built here with ``g++``) gives
  the bits of ``_decode_numpy`` and of the JAX package's ``decode_frame``
  on aligned, unaligned and organized records, with and without colour
  and the blue-shift bug.
* The writers give the JAX package's bytes: ASCII PCD tables and the
  metadata CSV through the library, binary PCDs and PLYs through NumPy
  (the JAX package's own library is not built here, so it writes through
  its NumPy formats, which are also the port's format oracles).  The
  readers and the ``download_*`` views give the JAX package's arrays.
* ``NativeOracle`` equals the JAX package's Python ``OracleGrid`` (as
  tests/test_native_oracle.py holds the JAX package's wrapper), and
  ``NativeTsdfOracle`` its Python ``TsdfOracle``: the same cells, counts
  and weights, centroids within 1e-5 m and the TSDF within 1e-6.
* A failed build raises, and the library's key follows its flags.
* ``StageTimers`` reports its stages and loses no update under threads.
"""

import filecmp
import os
from pathlib import Path

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io import downloads as jdownloads
from hifi_fusion_tpu.io import pcd as jpcd
from hifi_fusion_tpu.io import ply as jply
from hifi_fusion_tpu.models.tsdf import TsdfConfig as JaxTsdfConfig
from hifi_fusion_tpu.oracle import OracleGrid
from hifi_fusion_tpu.oracle.tsdf_oracle import TsdfOracle
from hifi_fusion_tpu.runtime import decode as jdecode
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.io import downloads, pcd, ply
from hifi_fusion_tpu_torch.models.tsdf import TsdfConfig
from hifi_fusion_tpu_torch.oracle import native as oracle_native
from hifi_fusion_tpu_torch.runtime import decode, native
from hifi_fusion_tpu_torch.utils.profiling import StageTimers
from hifi_fusion_tpu_torch.utils.synthetic import make_sweep

ROOT = Path(__file__).resolve().parent.parent
CFG = small_test_config()
JCFG = jax_config()


@pytest.mark.parametrize("port,jax", [
    ("hifi_fusion_tpu_torch/runtime/native/fusion_native.cpp",
     "hifi_fusion_tpu/runtime/native/fusion_native.cpp"),
    ("hifi_fusion_tpu_torch/oracle/oracle_native.cpp",
     "hifi_fusion_tpu/oracle/oracle_native.cpp")])
def test_cpp_sources_are_copies(port, jax):
    assert filecmp.cmp(ROOT / port, ROOT / jax, shallow=False)


def _records(seed, n, point_step, height, with_rgb):
    """Port and JAX CloudFrames of ``n`` random records with x, y, z (and
    rgb) at scattered offsets, random filler bytes between them."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (n, point_step), dtype=np.uint8)
    offs = {16: {"x": 0, "y": 4, "z": 8, "rgb": 12},
            32: {"x": 4, "y": 12, "z": 20, "rgb": 28},
            18: {"x": 1, "y": 5, "z": 9, "rgb": 14}}[point_step]
    if not with_rgb:
        offs = {k: v for k, v in offs.items() if k != "rgb"}
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    for a, name in enumerate("xyz"):
        raw[:, offs[name]:offs[name] + 4] = xyz[:, a:a + 1].view(np.uint8)
    frames = [mod.CloudFrame(raw.tobytes(), point_step, n // height, height,
                             [mod.PointField(k, o) for k, o in offs.items()])
              for mod in (decode, jdecode)]
    return frames, xyz, offs


@pytest.mark.parametrize("point_step,height,with_rgb,bug", [
    (16, 1, True, False), (16, 1, True, True), (32, 4, True, False),
    (32, 1, False, False), (18, 3, True, True), (18, 1, False, True)])
def test_native_decode_bits(point_step, height, with_rgb, bug):
    (frame, jframe), xyz_in, offs = _records(point_step + height, 600,
                                             point_step, height, with_rgb)
    xyz, rgb = decode.decode_frame(frame, blue_shift_bug=bug)
    ref = decode._decode_numpy(frame, offs["x"], offs["y"], offs["z"],
                               offs.get("rgb"), bug)
    jxyz, jrgb = jdecode.decode_frame(jframe, blue_shift_bug=bug)
    assert xyz.shape == rgb.shape == (600, 3)
    for got, want in ((xyz, ref[0]), (rgb, ref[1]), (xyz, jxyz),
                      (rgb, jrgb)):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.ascontiguousarray(want)
                                      .view(np.uint32))
    np.testing.assert_array_equal(xyz, xyz_in)
    if not with_rgb:
        assert not rgb.any()


def test_native_decode_rejects_short_buffer():
    (frame, _), _, _ = _records(1, 64, 16, 1, True)
    with pytest.raises(ValueError):
        native.decode_xyzrgb(frame.data[:-1], 64, 16, 0, 4, 8, 12)


def test_zclip_compact():
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, (500, 3)).astype(np.float32)
    got = native.zclip_compact(xyz, rgb, -0.25, 0.5)
    keep = (xyz[:, 2] > np.float32(-0.25)) & (xyz[:, 2] < np.float32(0.5))
    np.testing.assert_array_equal(got[0], xyz[keep])
    np.testing.assert_array_equal(got[1], rgb[keep])


@pytest.fixture(scope="module")
def host():
    """An extract-like host dict with awkward values: negative zeros,
    tiny and large magnitudes, colours outside 0-255, zero counts."""
    rng = np.random.default_rng(7)
    n = 300
    centroid = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    centroid[:5] = [[0.0, -0.0, 1e-30], [1e7, -3.5e-8, 2.0],
                    [0.1, 0.2, 0.3], [-1.0, 1.0, 0.5], [0.0, 0.0, 0.0]]
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    return {
        "cell": np.arange(n, dtype=np.int32) * 7,
        "centroid": centroid, "normal": normal,
        "rgb": rng.uniform(-20, 300, (n, 3)).astype(np.float32),
        "sd": rng.exponential(1e-7, (n, 3)).astype(np.float32),
        "mean_dist": rng.normal(scale=1e-4, size=n).astype(np.float32),
        "sd_dist": rng.exponential(1e-8, n).astype(np.float32),
        "count": rng.integers(0, 250, n).astype(np.int32),
    }


def _same_bytes(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("ascii_mode", [True, False])
def test_pcd_writers_match_jax(tmp_path, host, ascii_mode):
    p, j = tmp_path / "p.pcd", tmp_path / "j.pcd"
    pcd.write_pcd_xyzrgbnormal(str(p), host["centroid"], host["rgb"],
                               host["normal"], ascii_mode=ascii_mode)
    jpcd.write_pcd_xyzrgbnormal(str(j), host["centroid"], host["rgb"],
                                host["normal"], ascii_mode=ascii_mode)
    _same_bytes(p, j)
    pcd.write_pcd_xyzrgb(str(p), host["centroid"], host["rgb"],
                         ascii_mode=ascii_mode)
    jpcd.write_pcd_xyzrgb(str(j), host["centroid"], host["rgb"],
                          ascii_mode=ascii_mode)
    _same_bytes(p, j)
    got, n = pcd.read_pcd(str(p))
    want, jn = jpcd.read_pcd(str(j))
    assert n == jn == host["cell"].size and list(got) == list(want)
    for f in got:
        np.testing.assert_array_equal(got[f].view(np.uint32),
                                      want[f].view(np.uint32))


def test_native_ascii_table_matches_numpy_format(tmp_path, host):
    """The library against the port's own NumPy format oracle, on every
    column width the writers use, and an empty table."""
    for k in (4, 8):
        cols = np.concatenate([host["centroid"], host["normal"],
                               host["rgb"]], axis=1)[:, :k]
        for rows in (cols, cols[:0]):
            hdr = f"HEADER {k}\n"
            native.write_pcd_ascii(str(tmp_path / "n.txt"), hdr, rows)
            pcd._write_pcd_ascii_numpy(str(tmp_path / "p.txt"), hdr, rows)
            _same_bytes(tmp_path / "n.txt", tmp_path / "p.txt")


def test_metadata_csv_matches_jax(tmp_path, host):
    args = (host["sd"], host["mean_dist"], host["sd_dist"], host["count"])
    pcd.write_metadata_csv(str(tmp_path / "p.csv"), *args)
    pcd._write_metadata_csv_numpy(str(tmp_path / "n.csv"), *args)
    jpcd.write_metadata_csv(str(tmp_path / "j.csv"), *args)
    _same_bytes(tmp_path / "p.csv", tmp_path / "n.csv")
    _same_bytes(tmp_path / "p.csv", tmp_path / "j.csv")
    got = pcd.read_metadata_csv(str(tmp_path / "p.csv"))
    want = jpcd.read_metadata_csv(str(tmp_path / "j.csv"))
    assert set(got) == set(want)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f])


@pytest.mark.parametrize("ascii_mode", [True, False])
@pytest.mark.parametrize("with_rgb,with_normal", [
    (True, True), (True, False), (False, True), (False, False)])
def test_ply_matches_jax(tmp_path, host, ascii_mode, with_rgb, with_normal):
    rgb = host["rgb"] if with_rgb else None
    nrm = host["normal"] if with_normal else None
    p, j = str(tmp_path / "p.ply"), str(tmp_path / "j.ply")
    ply.write_ply(p, host["centroid"], rgb, nrm, ascii_mode=ascii_mode)
    jply.write_ply(j, host["centroid"], rgb, nrm, ascii_mode=ascii_mode)
    _same_bytes(p, j)
    got, want = ply.read_ply(p), jply.read_ply(j)
    assert set(got) == set(want)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f])


def test_download_views_match_jax(tmp_path, host):
    for name, args in (("download_xyz", ()),
                       ("download_with_normals", ()),
                       ("download_hq", (CFG,)),
                       ("download_classified", (CFG,))):
        got = getattr(downloads, name)(host, *args)
        want = getattr(jdownloads, name)(host, *[JCFG] * len(args))
        assert set(got) == set(want), name
        for f in got:
            np.testing.assert_array_equal(got[f], want[f])
    got = downloads.download_hq(host, CFG, threshold=50)
    want = jdownloads.download_hq(host, JCFG, threshold=50)
    np.testing.assert_array_equal(got["xyz"], want["xyz"])
    assert 0 < got["xyz"].shape[0] < host["cell"].size
    n = downloads.download_data(host, str(tmp_path / "p.pcd"),
                                str(tmp_path / "p.csv"))
    jn = jdownloads.download_data(host, str(tmp_path / "j.pcd"),
                                  str(tmp_path / "j.csv"))
    assert n == jn == host["cell"].size
    _same_bytes(tmp_path / "p.pcd", tmp_path / "j.pcd")
    _same_bytes(tmp_path / "p.csv", tmp_path / "j.csv")


@pytest.fixture(scope="module")
def sweep():
    return make_sweep(CFG, 5, 600, seed=11)


def test_native_oracle_matches_python_oracle(sweep):
    py = OracleGrid(JCFG)
    cc = oracle_native.NativeOracle(CFG)
    for i, fr in enumerate(sweep):
        py.integrate_frame(fr.points_cam, fr.rgb, fr.pose)
        cc.integrate_frame(fr.points_cam, fr.rgb, fr.pose)
        if (i + 1) % 2 == 0:
            py.refine()
            cc.refine()
    py.refine()
    cc.refine()
    a = py.extract()
    b = cc.extract()
    assert b["cell"].size > 100 and cc.n_voxels() >= b["cell"].size
    np.testing.assert_array_equal(a["cell"], b["cell"])
    np.testing.assert_array_equal(a["count"], b["count"])
    dots = np.sum(a["normal"] * b["normal"], axis=1)
    assert (dots > 0.99999).all()
    np.testing.assert_allclose(a["centroid"], b["centroid"], atol=1e-5)
    np.testing.assert_allclose(a["sd"], b["sd"], atol=1e-12)
    np.testing.assert_allclose(a["mean_dist"], b["mean_dist"], atol=1e-7)


def test_native_tsdf_oracle_matches_python_oracle(sweep):
    kw = dict(truncation=0.011, n_samples=5, min_weight=2.0)
    py = TsdfOracle(JaxTsdfConfig(base=JCFG, **kw))
    cc = oracle_native.NativeTsdfOracle(TsdfConfig(base=CFG, **kw))
    for fr in sweep:
        py.integrate_frame(fr.points_cam, fr.rgb, fr.pose)
        cc.integrate_frame(fr.points_cam, fr.pose)
    a = py.extract()
    b = cc.extract()
    assert b["cell"].size > 100 and cc.n_cells() > b["cell"].size
    np.testing.assert_array_equal(a["cell"], b["cell"])
    np.testing.assert_array_equal(a["weight"], b["weight"])
    np.testing.assert_allclose(a["tsdf"], b["tsdf"], atol=1e-6)


def test_oracle_rejects_bad_shapes(sweep):
    cc = oracle_native.NativeOracle(CFG)
    with pytest.raises(ValueError):
        cc.integrate_frame(sweep[0].points_cam.T, None, sweep[0].pose)
    with pytest.raises(ValueError):
        cc.integrate_frame(sweep[0].points_cam, None, np.eye(3))


def test_failed_build_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(bad, f"libbroken{os.getpid()}", native.FLAGS)
    assert not native.library_path(bad, f"libbroken{os.getpid()}",
                                   native.FLAGS).exists()


def test_library_key_follows_source_and_flags(tmp_path):
    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    a = native.library_path(src, "liba", native.FLAGS)
    assert a == native.library_path(src, "liba", native.FLAGS)
    assert a != native.library_path(src, "liba", native.FLAGS + ("-g",))
    src.write_text("int f() { return 2; }\n")
    assert a != native.library_path(src, "liba", native.FLAGS)
    assert a.parent == native.BUILD_DIR


def test_stage_timers():
    t = StageTimers()
    for _ in range(3):
        with t.stage("decode"):
            pass
    with pytest.raises(KeyError):
        with t.stage("device_step"):
            raise KeyError("x")
    r = t.report()
    assert list(r) == ["decode", "device_step"]
    assert r["decode"]["count"] == 3 and r["device_step"]["count"] == 1
    assert set(r["decode"]) == {"total_s", "count", "mean_ms"}
    t.reset()
    assert t.report() == {}


def test_stage_timers_under_threads():
    """Many threads add to the timers while one reports: no update is lost
    and no report fails."""
    import sys
    import threading
    t = StageTimers()
    errors = []

    def add(i):
        for _ in range(500):
            with t.stage(f"s{i % 5}"):
                pass

    def report():
        try:
            for _ in range(200):
                t.report()
        except RuntimeError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add, args=(i,))
                   for i in range(16)] + [threading.Thread(target=report)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert sum(v["count"] for v in t.report().values()) == 16 * 500
