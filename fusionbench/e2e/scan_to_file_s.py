"""Seconds a scan-to-files cycle: the window over its cycles."""


def read(rec):
    if rec["step"] != "scan_to_file":
        return None
    return rec["window_s"] / rec["cycles"]
