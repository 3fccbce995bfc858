"""The readers of the session's spans: the program_span readers on a
window's timers, ``device.idle_host_share`` and ``session.upload_gb_s`` on
a hand-made chrome trace, and none of them raising where the program has
no such span."""

import pytest

from fusionbench.harness import registry
from fusionbench.harness.trace import Trace


def ev(cat, ts, dur, name="k", tid=None, **args):
    e = {"cat": cat, "ts": ts, "dur": dur, "name": name, "args": args}
    if tid is not None:
        e["tid"] = tid
    return e


def rng(name, ts, dur, tid=7):
    return ev("user_annotation", ts, dur, name, tid)


def trace(copy_bytes=(True, True)):
    """A window [100, 300): the worker's step [100, 160) holding the
    upload [110, 130); its refine [170, 230) holding the read [200, 220);
    a decode [240, 260); the caller's drain [160, 300) on another
    thread.  ``copy_bytes`` says which of the upload's two HtoD copies
    carry the profiler's byte count."""
    nb = [{"bytes": 4000} if b else {} for b in copy_bytes]
    return {"traceEvents": [
        ev("user_annotation", 100, 200, "fb.window"),
        rng("step", 100, 60),
        rng("device_step.upload", 110, 20),
        rng("refine", 170, 60),
        rng("refine.read", 200, 20),
        rng("decode", 240, 20),
        rng("fb.drain", 160, 140, tid=1),
        ev("cuda_runtime", 112, 2, "cudaMemcpyAsync", 7, correlation=1),
        ev("cuda_runtime", 120, 2, "cudaMemcpyAsync", 7, correlation=2),
        ev("cuda_runtime", 140, 2, "cudaLaunchKernel", 7, correlation=3),
        ev("cuda_runtime", 175, 2, "cudaMemcpyAsync", 7, correlation=4),
        ev("gpu_memcpy", 113, 5, "Memcpy HtoD (Pageable -> Device)",
           correlation=1, **nb[0]),
        ev("gpu_memcpy", 121, 5, "Memcpy HtoD (Pageable -> Device)",
           correlation=2, **nb[1]),
        ev("kernel", 145, 10, "k3", correlation=3),
        ev("gpu_memcpy", 205, 10, "Memcpy DtoH (Device -> Pageable)",
           correlation=4, bytes=8),
    ], "all_threads": True}


def read(name, **ctx):
    return registry.module("metrics", name).read(ctx)


def test_idle_host_share():
    t = Trace(trace())
    # busy [113,118) [121,126) [145,155) [205,215): 30 of 200 us; the
    # worker's ranges less the read: [100,160) [170,200) [220,230)
    # [240,260), of which busy 20 us -> 120 - 20 = 100 us idle
    assert t.busy_s == pytest.approx(30e-6)
    assert read("device.idle_host_share", trace=t) == pytest.approx(0.5)
    assert read("device.idle_share", trace=t) == pytest.approx(0.85)
    assert read("device.idle_host_share", trace=None) is None


def test_idle_host_share_without_worker_ranges():
    tr = trace()
    tr["traceEvents"] = [e for e in tr["traceEvents"]
                         if e["name"] not in ("step", "refine", "decode")]
    assert read("device.idle_host_share", trace=Trace(tr)) is None


@pytest.mark.parametrize("copy_bytes,want", [
    ((True, True), 8000),       # the profiler's byte counts
    ((True, False), None),      # a copy without its count: nothing
    ((False, False), None),
])
def test_upload_gb_s(copy_bytes, want):
    got = read("session.upload_gb_s", trace=Trace(trace(copy_bytes)))
    # two HtoD copies launched in one 20 us upload range; the DtoH copy
    # and the kernel are not counted
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want / 20e-6 / 1e9)


def test_upload_gb_s_without_the_span():
    tr = trace()
    tr["traceEvents"] = [e for e in tr["traceEvents"]
                         if e["name"] != "device_step.upload"]
    assert read("session.upload_gb_s", trace=Trace(tr)) is None
    assert read("session.upload_gb_s", trace=None) is None


def timers(**spans):
    return {k.replace("__", "."): {"total_s": v[0], "count": v[1]}
            for k, v in spans.items()}


WINDOW = timers(device_step=(0.4, 100), device_wait=(0.02, 100),
                device_step__upload=(0.1, 100),
                device_step__launch=(0.2, 100), refine=(0.2, 100),
                refine__read=(0.05, 100), decode__native=(1.6, 800),
                decode__pack=(0.8, 800), csv_write=(1.2, 3))


@pytest.mark.parametrize("name,want", [
    ("session.device_wait_ms", 0.2),
    ("session.upload_ms", 1.0),
    ("session.launch_ms", 2.0),
    ("pipeline.refine_read_ms", 0.5),
    ("decode.native_ms_per_frame", 2.0),
    ("decode.pack_ms_per_frame", 1.0),
    ("export.csv_s", 0.4),
])
def test_program_span_readers(name, want):
    assert read(name, timers=WINDOW, frames=800) == pytest.approx(want)
    # the parent program has none of the new spans: nothing, no raise
    old = {k: v for k, v in WINDOW.items()
           if k in ("device_step", "refine", "device_wait")}
    if name != "session.device_wait_ms":
        assert read(name, timers=old, frames=800) is None
    assert read(name, timers={}, frames=800) is None
