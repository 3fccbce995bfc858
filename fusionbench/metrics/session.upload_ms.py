"""The batch's copies to the card inside a dispatch: the session's
``device_step.upload`` span (every ``put`` of the dispatch; pageable
copies, which return once the data has left the host buffer) over the
window, total over the ``device_step`` count."""

LAYER = "session (runtime/session.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    u = ctx["timers"].get("device_step.upload")
    t = ctx["timers"].get("device_step")
    if not u or not t or not t["count"]:
        return None
    return 1e3 * u["total_s"] / t["count"]
