"""Segment helpers: runs of sorted keys and segmented scans.

The counterpart of the segment half of ``hifi_fusion_tpu/ops/scatter.py``
(:117-235).  Lanes are grouped by ``torch.sort(stable=True)``.

* ``runs`` / ``run_sums`` reduce a run by adding its lanes into one row
  per run with ``index_add_`` (PyTorch takes duplicate indices directly);
  the fusion path uses them.
* ``segment_reduce`` is the JAX package's two-level blocked segmented scan,
  restated in its association order so that its f32 sums are bit-identical
  to the JAX package's: per 512-lane block a 9-step Hillis-Steele ladder
  whose lanes with no left neighbour in the block combine with zero, the
  same ladder over the block summaries, then one combine pass; a single
  flat ladder when ``n <= 1024``.  Kernel T1 (``csrc/segscan.cu``) on CUDA
  tensors, ``segment_reduce_plain`` on CPU tensors.  The TSDF batch reduce
  (kernel T4) runs the same ladder itself (``csrc/segladder.cuh``), and
  its plain version runs ``segment_reduce_plain``.

The port's tensors carry no scratch tail, so the masked-scatter helpers
have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

BS = 512                      # lanes per block of the two-level scan
MAX_CHANNELS = 16             # channels T1 takes in one call
KINDS = {"add": 0, "first": 1, "or": 2}
_DTYPES = {"add": (torch.float32,), "first": (torch.float32, torch.int32),
           "or": (torch.int32,)}
_BIG = torch.iinfo(torch.int32).max


def runs(sorted_keys: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Runs of equal keys in a sorted 1-D tensor: ``(run_key, run_start,
    run_len, run_of_lane)``."""
    key, run_of_lane, run_len = torch.unique_consecutive(
        sorted_keys, return_inverse=True, return_counts=True)
    run_start = torch.cumsum(run_len, 0) - run_len
    return key, run_start, run_len, run_of_lane


def run_sums(values: torch.Tensor, run_of_lane: torch.Tensor,
             n_runs: int) -> torch.Tensor:
    """Per-run sums of (n,) or (k, n) lane values -> (n_runs,) or
    (k, n_runs)."""
    if values.dim() == 1:
        return torch.zeros(n_runs, dtype=values.dtype,
                           device=values.device).index_add_(
            0, run_of_lane, values)
    out = torch.zeros(n_runs, values.shape[0], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, run_of_lane, values.t()).t()


def segment_starts(sorted_keys: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(n,) bool: lane is the first of its run of equal (valid) keys."""
    prev = torch.cat([sorted_keys.new_full((1,), _BIG), sorted_keys[:-1]])
    return valid & (sorted_keys != prev)


def segment_ends(sorted_keys: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """(n,) bool: lane is the last of its run of equal (valid) keys."""
    nxt = torch.cat([sorted_keys[1:], sorted_keys.new_full((1,), _BIG)])
    return valid & (sorted_keys != nxt)


def _combine(kind: str, left: torch.Tensor, here: torch.Tensor):
    if kind == "add":
        return left + here
    if kind == "or":
        return left | here
    return left                                   # "first"


def _shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """Shift right by ``s`` along the last axis, zero-filled."""
    out = torch.zeros_like(x)
    out[..., s:] = x[..., :-s]
    return out


def _ladder(v, f, width: int, kind: str):
    """Hillis-Steele inclusive segmented scan along the last axis:
    ``v[i] = f[i] ? v[i] : op(v[i-s], v[i]); f[i] |= f[i-s]``, the lanes
    with no left neighbour at distance ``s`` combining with zero."""
    s = 1
    while s < width:
        vs, fs = _shift(v, s), _shift(f, s)
        v = torch.where(f, v, _combine(kind, vs, v))
        f = f | fs
        s *= 2
    return v, f


def segment_reduce_plain(values: torch.Tensor, starts: torch.Tensor,
                         kind: str) -> torch.Tensor:
    """Plain version of T1: the JAX package's ``segment_reduce`` ladder,
    step for step (scatter.py:187-235)."""
    v = values[None] if values.dim() == 1 else values
    k, n = v.shape
    if n <= 2 * BS:
        out, _ = _ladder(v, starts, n, kind)
        return out[0] if values.dim() == 1 else out
    nb = -(-n // BS)
    pad = nb * BS - n
    f = starts
    if pad:
        v = torch.cat([v, v.new_zeros((k, pad))], dim=1)
        f = torch.cat([f, f.new_zeros((pad,))])
    vv, ff = _ladder(v.reshape(k, nb, BS), f.reshape(nb, BS), BS, kind)
    pv, _ = _ladder(vv[:, :, -1], ff[:, -1], nb, kind)
    ev = _shift(pv, 1)                            # exclusive block prefixes
    out = torch.where(ff, vv, _combine(kind, ev[:, :, None], vv))
    out = out.reshape(k, nb * BS)[:, :n]
    return out[0] if values.dim() == 1 else out


def segment_reduce(values: torch.Tensor, starts: torch.Tensor,
                   kind: str) -> torch.Tensor:
    """Inclusive segmented scan of (n,) or (k, n) ``values`` under the
    (n,) bool segment-start flags ``starts``: ``kind`` "add" (f32 sums),
    "first" (f32 / i32, each segment's start value broadcast over it) or
    "or" (i32).  Masked lanes must carry the identity (zero).  At each
    segment's end lane the result is the whole segment's reduction.
    Kernel T1 on CUDA tensors, its plain version on CPU tensors;
    bit-identical."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    if values.dtype not in _DTYPES[kind]:
        raise TypeError(f"{kind}: values must be one of {_DTYPES[kind]}, "
                        f"got {values.dtype}")
    n = values.shape[-1]
    k = 1 if values.dim() == 1 else values.shape[0]
    if values.dim() not in (1, 2) or k > MAX_CHANNELS:
        raise ValueError(f"values must be (n,) or (k<={MAX_CHANNELS}, n), "
                         f"got {tuple(values.shape)}")
    dev = values.device
    if starts.dtype != torch.bool or tuple(starts.shape) != (n,) \
            or starts.device != dev:
        raise ValueError(f"starts must be ({n},) bool on {dev}")
    if dev.type == "cpu":
        return segment_reduce_plain(values, starts, kind)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError("values and starts must be contiguous")
    out = torch.empty_like(values)
    if n == 0:
        return out
    nb = -(-n // BS) if n > 2 * BS else 1
    # block summaries and their ping-pong partner; per block: first
    # flagged lane and two summary-flag ping-pong rows
    summ = torch.empty((2, k, nb), dtype=torch.int32, device=dev)
    aux = torch.empty((3, nb), dtype=torch.int32, device=dev)
    lib = kernels.library()
    kernels.check(lib.launch_segscan(
        values.data_ptr(), starts.data_ptr(), k, n, KINDS[kind],
        out.data_ptr(), summ.data_ptr(), aux.data_ptr(), kernels.stream()),
        "segscan")
    kernels.LAUNCHES["segscan"] += 1
    return out


def segment_sums(values: torch.Tensor, starts: torch.Tensor
                 ) -> torch.Tensor:
    """Segmented running f32 sums; at each segment's end lane, the segment
    sum."""
    return segment_reduce(values, starts, "add")


def segment_fill(values: torch.Tensor, starts: torch.Tensor
                 ) -> torch.Tensor:
    """Each segment's start-lane value broadcast over its run."""
    return segment_reduce(values, starts, "first")
