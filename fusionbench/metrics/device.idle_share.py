"""The card's idle share of the traced cycles: one less the union of its
kernel, copy and fill spans over the window (``frozen/busy.py``).  The
profiler's host cost lengthens the window, so it is an upper bound."""

LAYER = "device"
UNIT = "share"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
