"""The repack of decoded records into the padded planar batch: the
session's ``decode.pack`` span (a frame's cut to ``max_points`` and its
(n,3) -> (3,N) copy) over the window, per frame."""

LAYER = "host decode (runtime/decode.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("decode.pack")
    if not t or not t["count"] or not ctx["frames"]:
        return None
    return 1e3 * t["total_s"] / ctx["frames"]
