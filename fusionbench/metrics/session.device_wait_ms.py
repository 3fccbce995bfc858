"""The session's wait for the card: its ``device_wait`` span (the worker
blocked on the previous dispatch's events before it dispatches the next)
over the window, total over count."""

LAYER = "session (runtime/session.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("device_wait")
    return 1e3 * t["total_s"] / t["count"] if t and t["count"] else None
