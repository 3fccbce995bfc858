"""Tracing and stage timers for the port's host runtime.

The counterpart of ``hifi_fusion_tpu/utils/profiling.py``:

* ``trace(log_dir)``: a ``torch.profiler.profile`` of the CPU and (when a
  card is there) CUDA activity, written to ``log_dir`` as a Chrome trace;
* ``StageTimers``: named wall-clock accumulators for host stages, reported
  by ``FusionSession.metrics()["stage_timers"]`` under the JAX package's
  names (``decode``, ``device_step``, ``refine``, ``device_wait``,
  ``process_*``);
* ``annotate(name)``: a ``torch.profiler.record_function`` range, so the
  host stages show on the trace's timeline.

Every timer is host wall time.  On the card a PyTorch launch returns before
its work is done, so ``device_step`` and ``refine`` are the host's dispatch
time: the device work they queue is waited for in ``device_wait`` (the
worker waiting for the previous dispatch), in the syncs inside the steps
(``int()`` reads of counts, which land in ``device_step``), or in
``drain()``.  On the CPU every op completes before it returns.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block into ``log_dir/trace.json``."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A host range on the profiler's timeline (cheap when not tracing)."""
    import torch
    return torch.profiler.record_function(name)


class StageTimers:
    """Accumulating wall-clock timers keyed by stage name.  The session's
    worker adds to them while another thread may report, so both hold a
    lock."""

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self._total[name] += dt
                self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "total_s": round(self._total[name], 6),
                    "count": self._count[name],
                    "mean_ms": round(1e3 * self._total[name]
                                     / max(self._count[name], 1), 3),
                }
                for name in sorted(self._total)
            }

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._count.clear()
