"""The pushing thread's copy of a frame into the session's staging ring:
the ``push.stage`` span (a frame's bytes copied into its ring row, on the
caller's thread, pinned rows on a card) over the window, total over its
count.  Nothing is read where the program has no such span."""

LAYER = "session (runtime/session.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("push.stage")
    return 1e3 * t["total_s"] / t["count"] if t and t["count"] else None
