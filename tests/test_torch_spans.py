"""The session's spans (``utils/profiling``) on the CPU.

* a depth and a planar session, single-stepped and K-batched, record
  every span with counts tied to the work: ``device_step.stage`` /
  ``.upload`` / ``.launch`` once a dispatch, ``refine.read`` once a refine
  pass, ``decode`` once a cloud dispatch (a fusion session decodes its
  clouds on the card: no ``decode.native`` or ``decode.pack``; the host
  decode's spans are counted in ``tests/test_torch_planar.py``),
  ``csv_write``
  and each ``process_*`` once a ``process()``, ``drain`` once a call,
  ``batch_wait`` only while a K-batch fills;
* the children's totals are no larger than their parent's;
* ``metrics()["stage_timers"]`` keeps the JAX session's names and every
  other span is under ``metrics()["spans"]``;
* under ``torch.profiler`` with all threads the worker's
  ``device_step.upload`` range lies inside its ``step`` range; with no
  profiler recording no range is opened;
* two sessions in one process, and ``span`` calls on several threads,
  keep their totals apart;
* a TSDF session's steps open ``tsdf.lanes``, ``tsdf.sort`` and
  ``tsdf.reduce`` once a dispatch, inside ``device_step.launch``; under
  the profiler each is a range inside the worker's ``step``; with no
  profiler recording they open none.
"""

import json
import threading
import time

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import refine_due
from hifi_fusion_tpu_torch.runtime.decode import make_cloud_frame
from hifi_fusion_tpu_torch.runtime.session import STAGES, FusionSession
from hifi_fusion_tpu_torch.utils.profiling import StageTimers, span
from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                   make_depth_sweep,
                                                   make_sweep)

W, H = 64, 48
N_FRAMES = 8
CFG = small_test_config(max_points=W * H, z_clip=(0.05, 3.0),
                        refine_every=4, max_batch_frames=4)
RAYS = camera_rays(W, H, fx=60.0, fy=60.0)
DEPTH = make_depth_sweep(CFG, N_FRAMES, width=W, height=H, srays=RAYS,
                         seed=3, camera_height=0.3)
CLOUDS = [(make_cloud_frame(f.points_cam, f.rgb), f.pose)
          for f in make_sweep(CFG, N_FRAMES, 600, seed=5)]
# the refine passes of a sweep: its marks, whatever the batching
PASSES = sum(bool(refine_due(f, 1, CFG)) for f in range(1, N_FRAMES + 1))
CHILDREN = ("device_step.stage", "device_step.upload", "device_step.launch")
TSDF = {"truncation": 0.03, "n_samples": 5, "min_weight": 1.0}
TSDF_SPANS = ("tsdf.lanes", "tsdf.sort", "tsdf.reduce")


def _push(s, wire, frames):
    for f in frames:
        if wire == "depth":
            assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                      rays=RAYS)
        else:
            assert s.push_frame(*f)


def _scan(tmp, wire, batched, model="fusion"):
    """A scan: one frame, a pause (a K-batch fills), the rest, a drain
    and a ``process()``; the metrics after it, with the ``process()``
    call's wall seconds."""
    frames = DEPTH if wire == "depth" else CLOUDS
    with FusionSession(CFG, "cpu", output_dir=str(tmp),
                       batch_fill_wait=5.0 if batched else 0.0, model=model,
                       model_params=TSDF if model == "tsdf" else None) as s:
        s.start()
        _push(s, wire, frames[:1])
        time.sleep(0.2)
        _push(s, wire, frames[1:])
        assert s.drain(300)
        t0 = time.monotonic()
        s.process()
        wall = time.monotonic() - t0
        return {**s.metrics(), "process_wall_s": wall}


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    return {(w, b): _scan(tmp / f"{w}{b}", w, b)
            for w in ("depth", "planar") for b in (False, True)}


CASES = [(w, b) for w in ("depth", "planar") for b in (False, True)]
IDS = [f"{w}-{'batched' if b else 'single'}" for w, b in CASES]


@pytest.mark.parametrize("wire,batched", CASES, ids=IDS)
def test_spans_count_the_work(scans, wire, batched):
    m = scans[wire, batched]
    st, sp = m["stage_timers"], m["spans"]
    assert m["frames_integrated"] == N_FRAMES and m["dispatch_errors"] == 0
    assert set(st) <= STAGES and not set(sp) & STAGES
    dispatches = N_FRAMES // 4 if batched else N_FRAMES
    assert st["device_step"]["count"] == dispatches
    for c in CHILDREN:
        assert sp[c]["count"] == dispatches, c
    # a K-batched session refines in its own stage; a single step refines
    # inside the pipeline's step call
    assert st.get("refine", {}).get("count", 0) == (PASSES if batched
                                                    else 0)
    final = st.get("process_refine", {}).get("count", 0)
    assert sp["refine.read"]["count"] == PASSES + final
    if wire == "planar":
        # the record wire: the layout check alone, no host decode
        assert st["decode"]["count"] == dispatches
        assert "decode.native" not in sp and "decode.pack" not in sp
        assert m["cloud_frames_card_decoded"] == N_FRAMES
        assert m["cloud_frames_host_decoded"] == 0
    else:
        assert "decode" not in st and "decode.native" not in sp
    for name in ("process_extract", "process_export", "process_csv_wait",
                 "process_metrics", "process_clear"):
        assert st[name]["count"] == 1, name
    assert sp["csv_write"]["count"] == 1
    assert sp["drain"]["count"] == 2            # ours and process()'s
    # only a K-batched session waits for a batch to fill: after the
    # first frame, while the pause lasts
    if batched:
        assert sp["batch_wait"]["count"] >= 1
        assert sp["batch_wait"]["total_s"] >= 0.1
    else:
        assert "batch_wait" not in sp
    for t in list(st.values()) + list(sp.values()):
        assert set(t) == {"total_s", "count", "mean_ms"}


@pytest.mark.parametrize("wire,batched", CASES, ids=IDS)
def test_children_within_their_parent(scans, wire, batched):
    m = scans[wire, batched]
    st, sp = m["stage_timers"], m["spans"]
    tot = {k: v["total_s"] for k, v in {**st, **sp}.items()}
    eps = 1e-5                                  # the report's rounding
    assert sum(tot[c] for c in CHILDREN) <= tot["device_step"] + eps
    outer = tot.get("refine", 0.0) + tot.get("process_refine", 0.0)
    if not batched:
        outer += tot["device_step.launch"]
    assert tot["refine.read"] <= outer + eps
    # the CSV's thread starts after the extract and is joined before the
    # metrics: its span lies in process() but outside those stages
    serial = sum(tot.get(k, 0.0) for k in (
        "process_refine", "process_extract", "process_metrics",
        "process_clear"))
    assert tot["csv_write"] <= m["process_wall_s"] - serial + eps


def _ranges(path):
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return [e for e in ev if e.get("cat") == "user_annotation"
            and "dur" in e]


def test_upload_range_nested_in_step_on_the_worker(tmp_path):
    """Under the profiler (all threads) the worker's spans are ranges; a
    ``device_step.upload`` lies inside a ``step`` of its thread."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                       batch_fill_wait=5.0) as s:
        s.start()
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            _push(s, "depth", DEPTH)
            assert s.drain(300)
        spans = s.metrics()["spans"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    rs = _ranges(path)
    steps = [r for r in rs if r["name"] == "step"]
    uploads = [r for r in rs if r["name"] == "device_step.upload"]
    assert len(steps) == len(uploads) == N_FRAMES // 4
    assert not [r for r in rs if r["name"] == "device_step"]
    for u in uploads:
        assert any(st["tid"] == u["tid"] and st["ts"] <= u["ts"]
                   and u["ts"] + u["dur"] <= st["ts"] + st["dur"]
                   for st in steps)
    names = {r["name"] for r in rs}
    assert {"refine", "refine.read", "device_wait", "drain",
            "device_step.stage", "device_step.launch"} <= names
    assert "drain" in spans
    drains = [r for r in rs if r["name"] == "drain"]
    assert {r["tid"] for r in drains}.isdisjoint(
        {r["tid"] for r in steps})               # on the caller's thread


def test_no_range_without_a_profiler(tmp_path, monkeypatch):
    """With no profiler recording a span opens no ``record_function``;
    under one, every span opens one."""
    calls = []
    real = autograd_profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(autograd_profiler, "record_function", counted)
    assert not autograd_profiler._is_profiler_enabled
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                       batch_fill_wait=5.0) as s:
        s.start()
        _push(s, "depth", DEPTH)
        assert s.drain(300)
        s.process()
        assert s.metrics()["spans"]["device_step.upload"]["count"] == 2
    assert calls == []
    t = StageTimers()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with t.stage("device_step"):
            with span("device_step.upload"):
                pass
        with span("outside"):
            pass
    assert calls == ["step", "device_step.upload", "outside"]
    assert set(t.report()) == {"device_step", "device_step.upload"}


def test_two_sessions_keep_their_own_totals(tmp_path):
    """Two sessions fusing at once in one process: each counts its own
    dispatches and refine reads."""
    out = {}

    def run(name, frames):
        with FusionSession(CFG, "cpu", output_dir=str(tmp_path / name),
                           batch_fill_wait=5.0) as s:
            s.start()
            _push(s, "depth", frames)
            assert s.drain(300)
            out[name] = s.metrics()

    threads = [threading.Thread(target=run, args=("a", DEPTH)),
               threading.Thread(target=run, args=("b", DEPTH[:4]))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    a, b = out["a"], out["b"]
    assert a["spans"]["device_step.upload"]["count"] == 2
    assert b["spans"]["device_step.upload"]["count"] == 1
    assert a["spans"]["refine.read"]["count"] == 2
    assert b["spans"]["refine.read"]["count"] == 1


def test_span_goes_to_the_innermost_stage_of_its_thread():
    """``span`` records into the timers whose stage is open on the
    calling thread, never into another thread's; outside any stage it
    records nothing."""
    timers = [StageTimers() for _ in range(8)]
    barrier = threading.Barrier(len(timers))

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(200 + i):
            with timers[i].stage("outer"):
                with span("inner"):
                    pass
        with span("inner"):
            pass

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(timers))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    for i, t in enumerate(timers):
        r = t.report()
        assert r["outer"]["count"] == r["inner"]["count"] == 200 + i
    with span("nowhere"):
        pass
    assert all("nowhere" not in t.report() for t in timers)


@pytest.fixture(scope="module")
def tsdf_scans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tsdf_spans")
    return {(w, b): _scan(tmp / f"{w}{b}", w, b, model="tsdf")
            for w in ("depth", "planar") for b in (False, True)}


@pytest.mark.parametrize("wire,batched", CASES, ids=IDS)
def test_tsdf_spans_once_a_dispatch(tsdf_scans, wire, batched):
    """A TSDF step opens each of its three spans once a dispatch, single
    frame or K-batch, depth or planar, inside the session's launch."""
    m = tsdf_scans[wire, batched]
    st, sp = m["stage_timers"], m["spans"]
    assert m["frames_integrated"] == N_FRAMES and m["dispatch_errors"] == 0
    dispatches = N_FRAMES // 4 if batched else N_FRAMES
    assert st["device_step"]["count"] == dispatches
    for name in TSDF_SPANS:
        assert sp[name]["count"] == dispatches, name
        assert set(sp[name]) == {"total_s", "count", "mean_ms"}
    assert not set(TSDF_SPANS) & STAGES
    eps = 1e-5                                  # the report's rounding
    assert sum(sp[n]["total_s"] for n in TSDF_SPANS) \
        <= sp["device_step.launch"]["total_s"] + eps


def test_tsdf_ranges_nested_in_step_on_the_worker(tmp_path):
    """Under the profiler (all threads) each TSDF span is a range of its
    own name, once a dispatch, inside a ``step`` of the worker's thread."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                       batch_fill_wait=5.0, model="tsdf",
                       model_params=TSDF) as s:
        s.start()
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            _push(s, "depth", DEPTH)
            assert s.drain(300)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    rs = _ranges(path)
    steps = [r for r in rs if r["name"] == "step"]
    assert len(steps) == N_FRAMES // 4
    for name in TSDF_SPANS:
        inner = [r for r in rs if r["name"] == name]
        assert len(inner) == len(steps), name
        for r in inner:
            assert any(st["tid"] == r["tid"] and st["ts"] <= r["ts"]
                       and r["ts"] + r["dur"] <= st["ts"] + st["dur"]
                       for st in steps), name


def test_tsdf_no_range_without_a_profiler(tmp_path, monkeypatch):
    """With no profiler recording a TSDF session's spans are counted and
    open no ``record_function``."""
    calls = []
    real = autograd_profiler.record_function

    def counted(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(autograd_profiler, "record_function", counted)
    assert not autograd_profiler._is_profiler_enabled
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                       batch_fill_wait=5.0, model="tsdf",
                       model_params=TSDF) as s:
        s.start()
        _push(s, "depth", DEPTH)
        assert s.drain(300)
        spans = s.metrics()["spans"]
    assert all(spans[n]["count"] == N_FRAMES // 4 for n in TSDF_SPANS)
    assert calls == []
