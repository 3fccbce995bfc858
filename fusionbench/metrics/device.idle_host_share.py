"""The share of the traced window in which the card is idle while the
session's worker is busy on the host: inside a ``step``, ``refine`` or
``decode`` range and outside ``refine.read`` (the refine's read, which
waits for the card).  The idle time is ``device.idle_share``'s, so this
share is at most that one; the rest of the idle time falls where the
worker is not in those ranges (waiting for the card or for frames)."""

from fusionbench.frozen.busy import clip, gaps

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
HOST = ("step", "refine", "decode")
WAIT = "refine.read"


def _merged(ranges) -> list:
    out = []
    for a, b in sorted((r["ts"], r["ts"] + r["dur"]) for r in ranges):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(x, y) -> list:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    host = clip(_merged(r for r in tr.ranges if r.get("name") in HOST),
                tr.lo, tr.hi)
    if not host:
        return None
    waits = clip(_merged(tr.named(WAIT)), tr.lo, tr.hi)
    idle = gaps(tr.busy, tr.lo, tr.hi)
    both = _intersect(_intersect(host, gaps(waits, tr.lo, tr.hi)), idle)
    return sum(b - a for a, b in both) / 1e6 / tr.window_s
