"""The refine's one read of the card: the ``refine.read`` span (the
pass's ``.cpu().tolist()`` of its two counts, which waits for the work
queued before it) over the window, total over the ``refine`` count."""

LAYER = "pipelines (models/pipeline.py, models/tsdf.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    r = ctx["timers"].get("refine.read")
    t = ctx["timers"].get("refine")
    if not r or not t or not t["count"]:
        return None
    return 1e3 * r["total_s"] / t["count"]
