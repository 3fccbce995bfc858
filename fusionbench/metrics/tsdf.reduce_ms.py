"""Device time of a TSDF dispatch's reduce: the kernels, copies and
fills launched inside the program's ``tsdf.reduce`` ranges (kernel T4,
its find-or-insert K2 and the scatter into the grid) of the traced
cycles, joined by correlation id, over the ranges.  Nothing is read where
the program opens no such range."""

LAYER = "pipelines (models/pipeline.py, models/tsdf.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
RANGE = "tsdf.reduce"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    ranges, dev_s = tr.launched_in(RANGE)
    if not ranges or dev_s <= 0:
        return None
    return 1e3 * dev_s / len(ranges)
