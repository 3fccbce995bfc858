"""The export writers: ``process()``'s ``process_export`` stage timer (the
ASCII PCD, with the CSV formatted on a thread beside it) over the
window, per call."""

LAYER = "export writers (io/pcd.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "scan_to_file_s"


def read(ctx):
    t = ctx["timers"].get("process_export")
    return t["total_s"] / t["count"] if t and t["count"] else None
