"""The TSDF cell's parts: its four per-layer readers on a hand-made trace
(kernels matched by their whole name), the frozen byte counts against
the program's ``bounds.py``, the judge on planted faults at the judge's
own level, and the registry finding the configuration, judge and
limits."""

import copy

import numpy as np
import pytest
import torch

from fusionbench import control
from fusionbench.frozen import tsdf_bytes
from fusionbench.frozen.kernel_names import base_name
from fusionbench.harness import registry
from fusionbench.harness.trace import Trace
from fusionbench.judge import common
from fusionbench.judge import tsdf as judge
from fusionbench.reference import tsdf as plain
from fusionbench.tests import tiny

CELL = "tsdf512.depth_scans"
NEW = ("tsdf.sort_ms", "tsdf.reduce_ms", "kernel.tsdf_lanes_roofline",
       "kernel.tsdf_reduce_roofline")


def ev(cat, ts, dur, name="k", tid=None, **args):
    e = {"cat": cat, "ts": ts, "dur": dur, "name": name, "args": args}
    if tid is not None:
        e["tid"] = tid
    return e


# device kernels launched in each range: (name, duration in us); the
# last two of the reduce are not T4's, though their names hold its words
LANES = [("tsdf_lanes_kernel(unsigned short const*, float*)", 20)]
SORT = [("void cub::DeviceRadixSortOnesweepKernel<int, long>(int*)", 30),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", 2)]
REDUCE = [("void t4_runs_kernel<16>(int const*, long long const*)", 50),
          ("t4_carry_kernel(int, int, int const*)", 5),
          ("hash_insert_kernel(int*, int const*, int)", 10),
          ("t4_scatter_kernel(int, int const*)", 8),
          ("void my_tsdf_reduce_helper<2>(float*)", 100),
          ("tsdf_lanes_planar_kernel(float const*, float*)", 40)]


def trace(with_spans=True):
    """A window [0, 1000): two dispatches on the worker (tid 7), each a
    ``step`` holding ``tsdf.lanes``, ``tsdf.sort`` and ``tsdf.reduce``,
    and each range's launches joined to their kernels by correlation."""
    out = [ev("user_annotation", 0, 1000, "fb.window")]
    corr = 0
    for d in range(2):
        t0 = 10 + 450 * d
        out.append(ev("user_annotation", t0, 400, "step", 7))
        t = t0 + 5
        for name, kernels in (("tsdf.lanes", LANES), ("tsdf.sort", SORT),
                              ("tsdf.reduce", REDUCE)):
            if with_spans:
                out.append(ev("user_annotation", t, 100, name, 7))
            for i, (kname, dur) in enumerate(kernels):
                corr += 1
                out.append(ev("cuda_runtime", t + 1 + i, 1,
                              "cudaLaunchKernel", 7, correlation=corr))
                out.append(ev("kernel", t + 2 + i, dur, kname,
                              correlation=corr))
            t += 110
    return {"traceEvents": out, "all_threads": True}


CFG = {"model": "tsdf", "model_params": {"n_samples": 3}}
REF = {"batch_cells": [300, 320], "batch_new": [300, 40]}


def ctx(tr, **kw):
    c = {"trace": tr, "config": CFG, "ref": REF, "batch": 2, "pixels": 1000,
         "traffic": {"frames_per_scan": 4}, "trace_cycles": 1}
    c.update(kw)
    return c


def read(name, c):
    return registry.module("metrics", name).read(c)


def test_base_name_is_the_whole_function_name():
    assert base_name(REDUCE[0][0]) == "t4_runs_kernel"
    assert base_name(LANES[0][0]) == "tsdf_lanes_kernel"
    assert base_name(REDUCE[4][0]) == "my_tsdf_reduce_helper"
    assert base_name("void (anonymous namespace)::t4_carry_kernel(int)") \
        == "t4_carry_kernel"


def test_sort_and_reduce_ms():
    t = Trace(trace())
    # two ranges each; device us a range: sort 32, reduce 213
    assert read("tsdf.sort_ms", ctx(t)) == pytest.approx(32e-3)
    assert read("tsdf.reduce_ms", ctx(t)) == pytest.approx(213e-3)


def test_rooflines_match_whole_names():
    t = Trace(trace())
    # T2: 2 batches of K=2 frames, N=1000, S=3 over 2 x 20 us
    want = 100 * 2 * tsdf_bytes.tsdf_lanes(2, 1000, 3) / 3.35e12 / 40e-6
    assert read("kernel.tsdf_lanes_roofline", ctx(t)) == pytest.approx(want)
    # T4: runs, carries, K2 and scatter, 2 x 73 us; neither the helper nor
    # the planar lanes kernel is counted
    M = 2 * 3 * 1000
    nbytes = (tsdf_bytes.tsdf_reduce(M, 300, 300, 300)
              + tsdf_bytes.tsdf_reduce(M, 320, 40, 320))
    want = 100 * nbytes / 3.35e12 / 146e-6
    assert read("kernel.tsdf_reduce_roofline", ctx(t)) == pytest.approx(want)


def test_readers_read_nothing_where_nothing_is():
    """No trace, a trace without the spans (the parent program), no
    reference counts, no kernel of the names: nothing, and no raise."""
    bare = Trace(trace(with_spans=False))
    for name in NEW:
        assert read(name, ctx(None)) is None
    assert read("tsdf.sort_ms", ctx(bare)) is None
    assert read("tsdf.reduce_ms", ctx(bare)) is None
    # the rooflines match kernels, not ranges: they read the parent too
    assert read("kernel.tsdf_lanes_roofline", ctx(bare)) is not None
    assert read("kernel.tsdf_reduce_roofline", ctx(bare, ref={})) is None
    empty = Trace({"traceEvents": [ev("user_annotation", 0, 10,
                                      "fb.window")]})
    for name in NEW:
        assert read(name, ctx(empty)) is None


@pytest.mark.parametrize("shape", [(8, 307200, 15, 60000, 9000),
                                   (4, 12288, 5, 700, 700)])
def test_frozen_bytes_are_the_bounds(shape):
    from hifi_fusion_tpu_torch import bounds
    K, N, S, u, new = shape
    assert tsdf_bytes.tsdf_lanes(K, N, S) == bounds.tsdf_lanes(K, N, S)[
        "bytes"]
    M = K * S * N
    assert tsdf_bytes.tsdf_reduce(M, u, new, u) == bounds.tsdf_reduce(
        M, u, new, u)["bytes"]
    assert tsdf_bytes.HBM_BYTES_PER_S == bounds.HBM_BYTES_PER_S


def test_registry_finds_the_cell():
    bench = registry.benchmark()
    w = registry.workload(bench, CELL)
    cfg = registry.config(bench, w["config"])
    assert cfg["name"] == "tsdf512-open3d-recon" and cfg["model"] == "tsdf"
    assert cfg["reduced"] == [] and cfg["departures"] and cfg["assumed"]
    found = registry.module("judge", cfg["model"])
    assert found.numbers.__doc__ == judge.numbers.__doc__
    assert found.__file__ == judge.__file__
    lim = registry.limits(CELL)["numbers"]
    assert lim["unique_rel"]["limit"] == 0
    for k in ("frames_lost", "dispatch_errors", "overflow"):
        assert lim[k]["limit"] == 0
    names = {m["name"] for m in
             registry.metrics_for(bench, "per_layer", CELL)}
    assert set(NEW) <= names
    assert {"pipeline.step_device_ms", "device.idle_share"} <= names
    e2e = {m["name"] for m in registry.metrics_for(bench, "end_to_end",
                                                   CELL)}
    assert e2e == {"fuse_mpts_s", "peak_device_gb", "setup_s"}


# -- the judge on planted faults, at a size the CPU holds ------------------

def _small():
    _, _, cfg, tr, lim = tiny.cell(CELL)
    cfg = copy.deepcopy(cfg)
    cfg["sensor"].update(width=64, height=48, fx=90.0)
    cfg["fusion_config"].update(max_points=64 * 48,
                                max_active_points=64 * 48)
    from fusionbench.harness.traffic import make_inputs
    return cfg, make_inputs(tr, cfg, 2 ** 33 + 5, "cpu"), lim["numbers"]


@pytest.fixture(scope="module")
def small():
    cfg, inputs, lim = _small()
    return cfg, inputs, lim, judge.reference(cfg, inputs, "cpu")


def as_program(ext, unique=None):
    gm = {"overflow_probe": 0, "overflow_unique": 0,
          "unique_cells": ext["unique_cells"] if unique is None else unique}
    return {"host": {k: v for k, v in ext.items() if k != "unique_cells"},
            "grid_metrics": gm}


def verdict(out, ref, lim):
    nums = judge.numbers(out, ref, {"frames_lost": 0, "dispatch_errors": 0})
    return common.verdict(nums, lim)


def test_judge_passes_the_reference(small):
    _, _, lim, ref = small
    ok, checks = verdict(as_program(ref), ref, lim)
    assert ok, checks


def test_judge_catches_an_unchanged_grid(small):
    cfg, _, lim, ref = small
    empty = plain.TsdfReference(cfg, "cpu").extract()
    ok, checks = verdict(as_program(empty), ref, lim)
    assert not ok and checks["cells_symdiff"]["value"] == 1.0


def test_judge_catches_half_of_each_batch(small):
    cfg, inputs, lim, ref = small
    K = plain.batch_frames(cfg["fusion_config"])
    frames = list(inputs.reference_frames("cpu"))
    half = plain.TsdfReference(cfg, "cpu")
    for b in range(0, len(frames), K):
        half.integrate(frames[b:b + max(K // 2, 1)])
    ok, checks = verdict(as_program(half.extract()), ref, lim)
    assert not ok, checks


def test_judge_catches_a_moved_centroid(small):
    _, _, lim, ref = small
    moved = dict(ref, centroid=np.array(ref["centroid"], copy=True))
    moved["centroid"][ref["cell"].size // 2, 0] += 2e-3
    ok, checks = verdict(as_program(moved), ref, lim)
    assert not ok and checks["centroid_gap_um"]["value"] > 1900


def test_judge_catches_a_miscount(small):
    _, _, lim, ref = small
    ok, checks = verdict(as_program(ref, unique=ref["unique_cells"] + 1),
                         ref, lim)
    assert not ok and checks["unique_rel"]["value"] > 0


def test_judge_refuses_a_program_without_the_counter(small):
    _, _, _, ref = small
    out = as_program(ref)
    del out["grid_metrics"]["unique_cells"]
    with pytest.raises(KeyError):
        judge.numbers(out, ref, {"frames_lost": 0, "dispatch_errors": 0})


def test_control_reads_its_own_count(small):
    """The control puts a reference in the program's place: its count of
    distinct cells comes with its extract."""
    cfg, inputs, lim, ref = small
    low = judge.reference(cfg, inputs, "cpu", ftype=torch.bfloat16,
                          acc=torch.bfloat16)
    nums = judge.numbers(control.as_program(low), ref,
                         {"frames_lost": 0, "dispatch_errors": 0})
    assert nums["unique_rel"] >= 0
    ok, _ = common.verdict(nums, lim)
    assert not ok
