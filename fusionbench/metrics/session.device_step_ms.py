"""The session's dispatch: its ``device_step`` stage timer (host wall time
of the batch's pageable copy, which waits on the stream, and the enqueue
of the step) over the window, total over count."""

LAYER = "session (runtime/session.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("device_step")
    return 1e3 * t["total_s"] / t["count"] if t and t["count"] else None
