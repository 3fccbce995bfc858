"""Kernel T2's share of its roofline in the traced cycles: the least time
the card's memory needs for T2's bytes (``frozen/tsdf_bytes.py``: the
depth wire in, 28 B a sample lane out, for every K-frame batch of the
traced scans) over the device time of the kernels whose whole name is
T2's, in percent.  Nothing is read without a trace or where no kernel of
that name ran."""

from fusionbench.frozen import tsdf_bytes
from fusionbench.frozen.kernel_names import device_s

LAYER = "kernels (csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
KERNELS = ("tsdf_lanes_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    cfg = ctx.get("config")
    if tr is None or cfg is None or cfg.get("model") != "tsdf":
        return None
    dev_s = device_s(tr.device, KERNELS)
    K = int(ctx["batch"])
    frames = int(ctx["traffic"]["frames_per_scan"]) * int(ctx["trace_cycles"])
    if dev_s <= 0 or frames % K:
        return None
    S = int(cfg["model_params"]["n_samples"])
    nbytes = frames // K * tsdf_bytes.tsdf_lanes(K, int(ctx["pixels"]), S)
    return 100.0 * nbytes / tsdf_bytes.HBM_BYTES_PER_S / dev_s
