"""Device time of a TSDF dispatch's sort: the kernels, copies and fills
launched inside the program's ``tsdf.sort`` ranges (the one stable sort
of a batch's sample ids) of the traced cycles, joined by correlation id,
over the ranges.  Nothing is read where the program opens no such
range."""

LAYER = "pipelines (models/pipeline.py, models/tsdf.py)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
RANGE = "tsdf.sort"


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    ranges, dev_s = tr.launched_in(RANGE)
    if not ranges or dev_s <= 0:
        return None
    return 1e3 * dev_s / len(ranges)
