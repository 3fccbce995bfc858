"""The busy-interval union, the idle share, the gaps and the step join on
a hand-made chrome trace."""

import pytest

from fusionbench.frozen.busy import busy_intervals, clip, gaps
from fusionbench.harness.trace import Trace


def ev(cat, ts, dur, name="k", **args):
    return {"cat": cat, "ts": ts, "dur": dur, "name": name, "args": args}


def test_union():
    tr = {"traceEvents": [ev("kernel", 0, 10), ev("gpu_memcpy", 5, 10),
                          ev("kernel", 30, 5), ev("gpu_memset", 35, 5),
                          ev("cpu_op", 0, 100), {"cat": "kernel", "ts": 1}]}
    assert busy_intervals(tr) == [[0, 15], [30, 40]]
    assert clip([[0, 15], [30, 40]], 10, 35) == [[10, 15], [30, 35]]
    assert gaps([[10, 15], [30, 35]], 10, 50) == [[15, 30], [35, 50]]


def trace():
    w = ev("user_annotation", 100, 100, "fb.window")
    return {"traceEvents": [
        w,
        ev("kernel", 50, 20, "spin_kernel"),            # the marker
        ev("user_annotation", 100, 40, "step") | {"tid": 7},
        ev("user_annotation", 150, 30, "fb.drain") | {"tid": 1},
        ev("cuda_runtime", 115, 2, "cudaLaunchKernel", correlation=1)
        | {"tid": 7},
        ev("cuda_runtime", 120, 2, "cudaMemcpyAsync", correlation=2)
        | {"tid": 7},
        ev("cuda_runtime", 160, 2, "cudaLaunchKernel", correlation=3)
        | {"tid": 1},
        ev("kernel", 118, 12, "t4_runs_kernel", correlation=1),
        ev("gpu_memcpy", 125, 10, "Memcpy HtoD", correlation=2),
        ev("kernel", 165, 5, "other", correlation=3),
    ], "all_threads": True}


def test_trace_reading():
    t = Trace(trace())
    assert t.marker_kept
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(22e-6)          # [118,135) + [165,170)
    ranges, dev = t.launched_in("step")
    assert len(ranges) == 1 and dev == pytest.approx(22e-6)
    ops = dict(t.device_ops())
    assert set(ops) == {"t4_runs_kernel", "Memcpy HtoD", "other"}
    g = sorted((name, round(sec * 1e6)) for name, sec in t.idle_gaps())
    # [100, 118) under the step, [135, 165) under the drain, [170, 200)
    # under nothing
    assert g == [("drain", 30), ("none", 30), ("step", 18)]
    idle = 1 - t.busy_s / t.window_s
    assert idle == pytest.approx(0.78)
