"""How fast the host's CPU ran around a window, so that a run slowed by
its machine can be told from one slowed by the program.

* ``probe_ms()``: the least of five runs of a fixed piece of pure Python,
  taken just before the window opens and just after it closes;
* ``cpu_s()``: this process's CPU seconds (user and system), read at both
  ends of the window.

A sandboxed host's ``/proc`` may report no steal time, no context
switches and no thread placement, so those are not read.
"""

from __future__ import annotations

import resource
import time


def probe_ms(n: int = 200_000) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        x = 0
        for i in range(n):
            x += i
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


def cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime
