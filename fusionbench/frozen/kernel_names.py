"""Kernels of a profiler trace matched by their whole name.

The profiler names a CUDA kernel by its demangled signature: ``void
t4_runs_kernel<16>(int const*, ...)`` or ``tsdf_lanes_kernel(unsigned
short const*, ...)``.  ``base_name`` keeps the function's own name, the
word before its template arguments and parameter list, so that a kernel
is matched by that whole word and never by a part of another name.
"""

from __future__ import annotations


def base_name(name: str) -> str:
    """The function name of a demangled kernel signature."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def device_s(events, names) -> float:
    """Seconds of the device ``kernel`` events whose function name is one
    of ``names``."""
    want = set(names)
    return sum(e["dur"] for e in events
               if e.get("cat") == "kernel"
               and base_name(e.get("name", "")) in want) / 1e6
