"""Kernel T4's share of its roofline in the traced cycles: the least time
the card's memory needs for T4's bytes (``frozen/tsdf_bytes.py``: each
sample lane's id, order word and six values, each kept cell's probe and
sums, per K-frame batch of the traced scans with the reference's distinct
and new cells of that batch) over the device time of the kernels whose
whole name is one of T4's three or its find-or-insert K2's, in percent.
Nothing is read without a trace, without the reference's counts, or where
no kernel of those names ran."""

from fusionbench.frozen import tsdf_bytes
from fusionbench.frozen.kernel_names import device_s

LAYER = "kernels (csrc)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "fuse_mpts_s"
KERNELS = ("t4_runs_kernel", "t4_carry_kernel", "t4_scatter_kernel",
           "hash_insert_kernel")


def read(ctx):
    tr, ref, cfg = ctx.get("trace"), ctx.get("ref"), ctx.get("config")
    if tr is None or cfg is None or cfg.get("model") != "tsdf" \
            or not ref or "batch_cells" not in ref:
        return None
    dev_s = device_s(tr.device, KERNELS)
    if dev_s <= 0:
        return None
    M = int(ctx["batch"]) * int(cfg["model_params"]["n_samples"]) \
        * int(ctx["pixels"])
    scan = sum(tsdf_bytes.tsdf_reduce(M, u, new, u)
               for u, new in zip(ref["batch_cells"], ref["batch_new"]))
    nbytes = int(ctx["trace_cycles"]) * scan
    return 100.0 * nbytes / tsdf_bytes.HBM_BYTES_PER_S / dev_s
