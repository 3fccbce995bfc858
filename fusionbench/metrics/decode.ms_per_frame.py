"""Host decode of PointCloud2 records: the ``decode`` stage timer (the
native decode and the repack into the padded batch) over the window,
per frame."""

LAYER = "host decode (runtime/decode.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("decode")
    if not t or not t["count"] or not ctx["frames"]:
        return None
    return 1e3 * t["total_s"] / ctx["frames"]
