"""Spans and tracing for the port's host runtime.

The counterpart of ``hifi_fusion_tpu/utils/profiling.py``:

* ``trace(log_dir)``: a ``torch.profiler.profile`` of the CPU and (when a
  card is there) CUDA activity, written to ``log_dir`` as a Chrome trace;
* ``StageTimers``: named wall-clock accumulators.  ``stage(name)`` is the
  port's one span: a single ``with`` that adds its host time to the
  timers and, while a profiler is recording, opens a
  ``torch.profiler.record_function`` range on the trace's clock, named
  after the span (``RANGES`` keeps the names the benchmark reads:
  ``device_step`` records the range ``step``).  With no profiler
  recording it opens no range;
* ``span(name)``: a span in the timers of the innermost ``stage`` open on
  the calling thread, for code below the session (the ops) that has no
  timers of its own; outside any stage it only opens the range.

Every timer is host wall time.  On the card a PyTorch launch returns before
its work is done, so ``device_step`` and ``refine`` are the host's dispatch
time: the device work they queue is waited for in ``device_wait`` (the
worker waiting for the previous dispatch), in the syncs inside the steps
(the refine's one read, ``refine.read``), or in ``drain()``.  On the CPU
every op completes before it returns.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

# profiler range names that differ from their span's name
RANGES = {"device_step": "step"}

# the timers of the innermost stage open in this thread
_active: contextvars.ContextVar[Optional["StageTimers"]] = \
    contextvars.ContextVar("hifi_fusion_tpu_torch_timers", default=None)


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


def _open_range(name: str):
    """An entered ``record_function`` range while a profiler records, else
    None."""
    from torch.autograd import profiler
    if not profiler._is_profiler_enabled:
        return None
    r = profiler.record_function(RANGES.get(name, name))
    r.__enter__()
    return r


@contextlib.contextmanager
def _range_only(name: str) -> Iterator[None]:
    r = _open_range(name)
    try:
        yield
    finally:
        if r is not None:
            r.__exit__(None, None, None)


def span(name: str):
    """A span of ``name`` in the timers of the innermost ``stage`` open on
    this thread (the session that called), or only its range."""
    timers = _active.get()
    return _range_only(name) if timers is None else timers.stage(name)


class StageTimers:
    """Accumulating wall-clock timers keyed by span name.  The session's
    worker adds to them while another thread may report, so both hold a
    lock."""

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        token = _active.set(self)
        r = _open_range(name)
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            if r is not None:
                r.__exit__(None, None, None)
            _active.reset(token)
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
