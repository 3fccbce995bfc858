"""Device time of a dispatch: the kernels, copies and fills launched inside
the session's ``step`` ranges (the worker thread's ``annotate("step")``)
of the traced cycles, joined by correlation id, over the ranges."""

LAYER = "pipelines (models/pipeline.py, models/tsdf.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    ranges, dev_s = tr.launched_in("step")
    if not ranges or dev_s <= 0:
        return None
    return 1e3 * dev_s / len(ranges)
