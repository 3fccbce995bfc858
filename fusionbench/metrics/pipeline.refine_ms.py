"""The refine pass through the session: its ``refine`` stage timer (host
wall time, with the pass's one read of the card) over the window, per
pass."""

LAYER = "pipelines (models/pipeline.py, models/tsdf.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("refine")
    return 1e3 * t["total_s"] / t["count"] if t and t["count"] else None
