"""The enqueue of a dispatch: the session's ``device_step.launch`` span
(the pipeline's step call: the Python launches of the frontend, the sort,
B3, K2 and K3) over the window, total over the ``device_step`` count."""

LAYER = "session (runtime/session.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    u = ctx["timers"].get("device_step.launch")
    t = ctx["timers"].get("device_step")
    if not u or not t or not t["count"]:
        return None
    return 1e3 * u["total_s"] / t["count"]
