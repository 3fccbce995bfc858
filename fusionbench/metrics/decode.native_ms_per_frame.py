"""The native decode of PointCloud2 records: the session's
``decode.native`` span (a frame's ``decode_frame`` call) over the window,
per frame."""

LAYER = "host decode (runtime/decode.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("decode.native")
    if not t or not t["count"] or not ctx["frames"]:
        return None
    return 1e3 * t["total_s"] / ctx["frames"]
