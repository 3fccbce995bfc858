"""The extract: ``process()``'s ``process_extract`` stage timer (the
device extract and its copy to the host) over the window, per call."""

LAYER = "extract (ops/extract.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "scan_to_file_s"


def read(ctx):
    t = ctx["timers"].get("process_extract")
    return t["total_s"] / t["count"] if t and t["count"] else None
