"""The metadata CSV: ``process()``'s ``csv_write`` span (the CSV thread's
own ``write_metadata_csv``, beside the PCD) over the window, per call."""

LAYER = "export writers (io/pcd.py)"
UNIT = "s"
SOURCE = "program_span"
MOVES = "scan_to_file_s"


def read(ctx):
    t = ctx["timers"].get("csv_write")
    return t["total_s"] / t["count"] if t and t["count"] else None
