"""The bytes the TSDF kernels' work must move, frozen for the benchmark.

Copied from ``hifi_fusion_tpu_torch/bounds.py`` (``tsdf_lanes`` :160-167
and ``tsdf_reduce`` :212-222, their byte terms alone; no operation bound
is reached at these shapes), so a change to the program cannot change the
yardstick.  The counts are of the work, not of an implementation: a
batch's frames, pixels and samples, its sample lanes, and the distinct
cells the reference finds in the batch (all kept and placed when no
counter overflows) and the new ones among them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, HBM3


def tsdf_lanes(K: int, N: int, S: int) -> int:
    """T2 on K depth frames of N pixels and S samples a pixel: the u16
    depth and rgb565 (4 B a pixel), the (3,N) f32 rays, K counts and 4x4
    f32 poses in; an i32 cell id and six f32 values (28 B) a sample lane
    out."""
    return K * N * 4 + 12 * N + K * (4 + 64) + K * N * S * 28


def tsdf_reduce(M: int, n_live: int, n_new: int, n_placed: int) -> int:
    """T4 with its find-or-insert on M sorted sample lanes whose distinct
    cells ``n_live`` are kept: per lane its sorted id (4 B), its i64 order
    word (8 B) and its six values (24 B) read; per kept cell its key probe
    (4 B), a new cell's key written (4 B); per placed cell its six f32
    sums read and written (48 B); the two counters."""
    return M * 36 + n_live * 4 + n_new * 4 + n_placed * 48 + 8
