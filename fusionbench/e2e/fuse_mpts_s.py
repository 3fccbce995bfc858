"""Input points fused per second of window: the points of every scan
(pixels of depth frames, points of records) over the whole window, from
the first scan's start to the end of the last scan's ``drain()``."""


def read(rec):
    if rec["step"] != "scan":
        return None
    return rec["cycles"] * rec["points_per_cycle"] / rec["window_s"] / 1e6
