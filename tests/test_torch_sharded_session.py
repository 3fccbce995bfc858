"""The sharded session behind the user's entry points, against the JAX
package's: ``FusionSession(n_devices=4, route=True)`` on one seeded 8-frame
64x64 depth sweep (``small_test_config(refine_every=4,
max_batch_frames=4, z_clip=(0.05, 10.0))``, K=4 batches), every shard on
the CPU here and on the conftest's virtual devices for JAX:

* ``process()`` writes a PCD and a CSV holding the JAX session's cells
  and counts (positions and normals within 1e-5), and ``metrics()``
  reports the JAX session's sharded counters;
* ``save_state`` / ``load_state`` across the packages in both directions:
  the sharded npz layout is the JAX package's, a checkpoint loaded into
  the other package saves back to the same grid shard by shard (by cell
  id, every field exactly: a load copies), and its ``process()`` exports
  the saving session's cells and counts;
* ``cli fuse --devices 4 --route`` equals a direct sharded session;
* the TSDF family refuses ``n_devices > 1`` as the JAX session does.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io.pcd import read_metadata_csv, read_pcd
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch import checks
from hifi_fusion_tpu_torch.config import FusionConfig, small_test_config
from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
from hifi_fusion_tpu_torch.runtime import cli
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.runtime.sources import save_depth_sweep
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=64, height=64, srays=RAYS, seed=4,
                          noise_sd=3e-4, camera_height=0.4)
N_DEV = 4
FIELDS = ("cell", "count", "centroid", "normal", "mean_dist")


def _session(pkg, out):
    kw = dict(output_dir=out, batch_fill_wait=2.0, n_devices=N_DEV,
              route=True)
    if pkg == "port":
        return FusionSession(CFG, "cpu", **kw)
    return JaxSession(JCFG, **kw)


def _replay(pkg, tmp, state):
    """Replay the sweep, save the grid to ``state``, then process():
    (process result, metrics before it)."""
    with _session(pkg, str(tmp / pkg)) as s:
        s.start()
        for f in FRAMES:
            assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                      rays=RAYS)
        assert s.drain(600)
        m = s.metrics()
        s.save_state(state)
        return s.process(extra_fields=FIELDS), m


def _load(pkg, tmp, state, again):
    """Load ``state`` into a fresh session, save it to ``again``, then
    process()."""
    with _session(pkg, str(tmp / f"{pkg}_loaded")) as s:
        s.load_state(state)
        s.save_state(again)
        return s.process(extra_fields=FIELDS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    out = {}
    for pkg in ("port", "jax"):
        out[pkg] = _replay(pkg, tmp, str(tmp / f"{pkg}.npz"))
    for pkg, src in (("jax", "port"), ("port", "jax")):
        out[f"{pkg}<{src}"] = _load(pkg, tmp, str(tmp / f"{src}.npz"),
                                    str(tmp / f"{pkg}<{src}.npz"))
    return tmp, out


def _same_export(a, b):
    """Two process() results: same cells and counts, positions and
    normals within 1e-5, PCD rows and CSV counts as the extract."""
    assert a["n_points"] == b["n_points"] > 300
    np.testing.assert_array_equal(a["host"]["cell"], b["host"]["cell"])
    np.testing.assert_array_equal(a["host"]["count"], b["host"]["count"])
    ca, n = read_pcd(a["cloud"])
    cb, _ = read_pcd(b["cloud"])
    assert n == a["n_points"] and list(ca) == list(cb)
    for f in ca:
        np.testing.assert_allclose(ca[f], cb[f], atol=1e-5, err_msg=f)
    ma, mb = read_metadata_csv(a["metadata"]), read_metadata_csv(
        b["metadata"])
    np.testing.assert_array_equal(ma["count"], mb["count"])
    np.testing.assert_allclose(ma["mean_dist"], mb["mean_dist"], atol=1e-5)


def test_sharded_session_exports_what_jax_exports(runs):
    _, out = runs
    (port, pm), (ref, jm) = out["port"], out["jax"]
    _same_export(port, ref)
    assert pm["devices"] == jm["devices"] == N_DEV
    for k in jm:
        if k not in ("stage_timers", "frames_per_s"):
            assert pm[k] == jm[k], k
    assert port["grid_metrics"] == ref["grid_metrics"]
    assert pm["frames_integrated"] == len(FRAMES)


def _npz(path):
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def _shard_fields(fields, j):
    out = {}
    for f, a in fields.items():
        if a.ndim == 1 and a.size == N_DEV:
            out[f] = a[j]
        else:
            out[f] = np.split(a, N_DEV, axis=1 if f == "buf_pts" else 0)[j]
    return out


@pytest.mark.parametrize("loader,saver", [("jax", "port"), ("port", "jax")])
def test_checkpoints_carry_across_packages(runs, loader, saver):
    tmp, out = runs
    want = _npz(str(tmp / f"{saver}.npz"))
    got = _npz(str(tmp / f"{loader}<{saver}.npz"))
    assert set(got) == set(want)
    for f in want:
        assert got[f].shape == want[f].shape and got[f].dtype == \
            want[f].dtype, f
    cfg = ShardedFusion(CFG, ["cpu"] * N_DEV, route=True).config
    for j in range(N_DEV):
        a = checks.by_cell(_shard_fields(got, j), cfg)
        b = checks.by_cell(_shard_fields(want, j), cfg)
        assert b["cell"].size > 100
        for f in b:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{j} {f}")
    _same_export(out[f"{loader}<{saver}"], out[saver][0])


def test_cli_fuse_sharded_equals_a_direct_session(tmp_path):
    sweep = str(tmp_path / "sweep.npz")
    save_depth_sweep(sweep, FRAMES, RAYS)
    conf = str(tmp_path / "cfg.json")
    default = FusionConfig()
    with open(conf, "w") as f:      # CFG's fields that are not defaults
        json.dump({k: v for k, v in dataclasses.asdict(CFG).items()
                   if v != getattr(default, k)}, f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main([
            "fuse", "--sweep", sweep, "--config", conf, "--device", "cpu",
            "--devices", str(N_DEV), "--route", "--output",
            str(tmp_path / "cli")]) == 0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert got["frames_integrated"] == len(FRAMES)
    with _session("port", str(tmp_path / "direct")) as s:
        s.start()
        for f in FRAMES:
            s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=RAYS)
        want = s.process()
    assert got["n_points"] == want["n_points"] > 300
    ca, _ = read_pcd(got["cloud"])
    cb, _ = read_pcd(want["cloud"])
    for f in cb:
        np.testing.assert_array_equal(ca[f], cb[f], err_msg=f)
    np.testing.assert_array_equal(read_metadata_csv(got["metadata"])["count"],
                                  read_metadata_csv(want["metadata"])["count"])


def test_tsdf_refuses_sharding_as_jax_does(tmp_path):
    with pytest.raises(NotImplementedError) as port:
        FusionSession(CFG, "cpu", output_dir=str(tmp_path), model="tsdf",
                      n_devices=2)
    with pytest.raises(NotImplementedError) as ref:
        JaxSession(JCFG, output_dir=str(tmp_path), model="tsdf",
                   n_devices=2)
    assert str(port.value) == str(ref.value)
