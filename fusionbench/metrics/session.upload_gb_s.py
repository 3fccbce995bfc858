"""The rate of a dispatch's copies to the card: the bytes of the
host-to-device copies launched inside the session's
``device_step.upload`` ranges of the traced cycles (runtime calls on the
range's thread, joined to the copies by correlation id), over the
ranges' summed host duration, which holds the profiler's own cost of
the traced calls.  The bytes are the profiler's own count of each copy;
nothing is read where a copy carries none."""

from collections import defaultdict

LAYER = "session (runtime/session.py)"
UNIT = "GB/s"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
RANGE = "device_step.upload"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    rs = tr.named(RANGE)
    host_s = sum(r["dur"] for r in rs) / 1e6
    if not rs or host_s <= 0:
        return None
    by_tid = defaultdict(list)
    for r in rs:
        by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"]))
    corr = set()
    for e in tr.runtime:
        spans = by_tid.get(e.get("tid"))
        if spans and any(a <= e["ts"] < b for a, b in spans):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                corr.add(c)
    copies = [e for e in tr.device if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")
              and e.get("args", {}).get("correlation") in corr]
    if not copies or any("bytes" not in e.get("args", {}) for e in copies):
        return None
    nbytes = sum(int(e["args"]["bytes"]) for e in copies)
    return nbytes / host_s / 1e9
