"""The device's busy time in a profiler trace, frozen for the benchmark.

``busy_intervals`` is copied from ``chip_smoke.py`` :1516-1529: the union
of the device's kernel, copy and fill spans of a ``torch.profiler`` chrome
trace, as merged ``[start, end)`` microsecond intervals.  ``clip`` and
``gaps`` are the benchmark's own.
"""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_intervals(trace: dict) -> list:
    """Merged [start, end) microsecond intervals of the device's kernels,
    copies and fills in a ``torch.profiler`` chrome trace."""
    spans = sorted((e["ts"], e["ts"] + e["dur"])
                   for e in trace.get("traceEvents", ())
                   if e.get("cat") in DEVICE_CATS
                   and "dur" in e)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def clip(intervals, lo: float, hi: float) -> list:
    """The parts of merged ``intervals`` inside ``[lo, hi)``."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append([a, b])
    return out


def gaps(intervals, lo: float, hi: float) -> list:
    """The ``[start, end)`` stretches of ``[lo, hi)`` that no interval of
    the merged, clipped ``intervals`` covers."""
    out, t = [], lo
    for a, b in intervals:
        if a > t:
            out.append([t, a])
        t = max(t, b)
    if hi > t:
        out.append([t, hi])
    return out
