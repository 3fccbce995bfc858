"""The share of the window's frames that the session staged into its
staging ring at push time (pinned rows on a card): the ``push.stage``
span's count over the frames the window's cycles pushed.  A frame without
a row is stacked and copied pageable by the dispatch.  Nothing is read
where the program has no such span."""

LAYER = "session (runtime/session.py)"
UNIT = "share"
SOURCE = "program_span"
MOVES = "fuse_mpts_s"


def read(ctx):
    t = ctx["timers"].get("push.stage")
    if not t or not t["count"] or not ctx["frames"]:
        return None
    return t["count"] / ctx["frames"]
