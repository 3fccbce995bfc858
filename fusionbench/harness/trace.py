"""The traced cycles of a ``--trace 1`` run, and what is read from them.

``record(fn, out_dir)`` runs ``fn`` under ``torch.profiler`` with CPU and
CUDA activity on every thread (the session's worker dispatches), opened
by a marker kernel (a ~1 ms spin) so the trace shows whether its first
kernels are kept, and ``fn`` itself inside the host range ``fb.window``.
``Trace`` reads the chrome trace: the device's busy time in the window
(the union of its kernel, copy and fill spans, ``frozen/busy.py``), the
device time launched inside the session's ``step`` ranges, the device
operations that took most time, and the longest idle gaps, each named by
the host range open over it.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

from ..frozen.busy import DEVICE_CATS, busy_intervals, clip, gaps

WINDOW = "fb.window"
MARKER = "spin_kernel"              # torch.cuda._sleep's kernel
MARKER_CYCLES = 2_000_000
# host ranges that name a gap, innermost first: the program's own
# (utils/profiling.annotate), then the harness's around its calls
PROGRAM_RANGES = ("step", "refine", "decode")


def _experimental_config():
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def record(fn, out_dir: str, cuda: bool = True) -> dict:
    """Run ``fn()`` under the profiler; the parsed chrome trace.  Without
    ``cuda`` (the CPU tests) only the host is recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    kw = {}
    cfg = _experimental_config()
    if cfg is not None:
        kw["experimental_config"] = cfg
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, **kw) as prof:
        if cuda:
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        with record_function(WINDOW):
            fn()
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    trace["all_threads"] = cfg is not None
    return trace


class Trace:
    def __init__(self, trace: dict):
        ev = [e for e in trace.get("traceEvents", ()) if "dur" in e]
        win = [e for e in ev if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace has no window range")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])
        self.all_threads = bool(trace.get("all_threads"))
        dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
        self.marker_kept = any(MARKER in e.get("name", "") for e in dev)
        self.device = [e for e in dev if self.lo <= e["ts"] < self.hi]
        self.busy = clip(busy_intervals({"traceEvents": self.device}),
                         self.lo, self.hi)
        self.ranges = [e for e in ev if e.get("cat") == "user_annotation"
                       and e.get("name") != WINDOW]
        self.runtime = [e for e in ev
                        if e.get("cat") in ("cuda_runtime", "cuda_driver")]

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def named(self, name: str) -> list:
        return [e for e in self.ranges if e.get("name") == name]

    def launched_in(self, name: str) -> tuple:
        """``(ranges, device seconds)``: the host ranges called ``name``
        and the summed device time of the kernels, copies and fills
        launched inside them (runtime calls on the range's thread, joined
        to the device events by correlation id)."""
        rs = self.named(name)
        by_tid = defaultdict(list)
        for r in rs:
            by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"]))
        corr = set()
        for e in self.runtime:
            spans = by_tid.get(e.get("tid"))
            if spans and any(a <= e["ts"] < b for a, b in spans):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    corr.add(c)
        dev = sum(e["dur"] for e in self.device
                  if e.get("args", {}).get("correlation") in corr)
        return rs, dev / 1e6

    def device_ops(self, n: int = 10) -> list:
        tot = defaultdict(float)
        for e in self.device:
            tot[e.get("name", "?")[:120]] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def _label(self, t: float) -> str:
        open_ = [r for r in self.ranges if r["ts"] <= t < r["ts"] + r["dur"]]
        for name in PROGRAM_RANGES:
            if any(r["name"] == name for r in open_):
                return name
        harness = sorted((r for r in open_ if r["name"].startswith("fb.")),
                         key=lambda r: -r["ts"])
        return harness[0]["name"][3:] if harness else "none"

    def idle_gaps(self, n: int = 10) -> list:
        out = [[self._label((a + b) / 2), (b - a) / 1e6]
               for a, b in gaps(self.busy, self.lo, self.hi)]
        return sorted(out, key=lambda g: -g[1])[:n]
