"""Segment helpers for the plain PyTorch paths.

The counterpart of the segment half of ``hifi_fusion_tpu/ops/scatter.py``
(:117-235).  Lanes are grouped by ``torch.sort(stable=True)``.  The JAX
package reduces runs with blocked segmented scans because duplicate-index
scatters serialize on a TPU; PyTorch's ``index_add_`` takes duplicate
indices directly, so a run is reduced by adding its lanes into one row
per run.  The port's tensors carry no scratch tail, so the masked-scatter
helpers have no counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
