"""The session's staging ring: host rows that pushed frames are copied into.

``FusionSession`` copies each pushed frame's bytes into a free row of one
ring on the pushing thread (the span ``push.stage``), and its queue holds
the row instead of the caller's arrays.  A dispatch allocates its device
batch and fills it from the batch's rows with one asynchronous copy per
array for each run of consecutive rows: one run, or two where the rows
wrap round the ring's end.  On a CUDA device the rows are pinned, so the
copies are DMA on the compute stream, in stream order after the previous
dispatch's kernels, and return at once; on the CPU they are plain host
rows through the same code.

A row is taken on the pushing thread and released when its frame is
dropped from the queue or reset away, or once the events recorded after
its dispatch have fired (the session's ``_await_device`` and ``drain``).
Rows are taken next-fit from the last row taken, so frames queued in
order hold consecutive rows; any free row serves when they do not.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

import torch


class StagingRing:
    """``rows`` host rows of each of the arrays ``fields`` names, ``{name:
    (row shape, dtype)}``, for frames of one layout, ``key``."""

    def __init__(self, key: tuple, fields: Dict[str, tuple], rows: int,
                 pin: bool):
        self.key = key
        self.rows = rows
        self.arrays = {name: torch.empty((rows, *shape), dtype=dtype,
                                         pin_memory=pin)
                       for name, (shape, dtype) in fields.items()}
        self._free = [True] * rows
        self._next = 0
        self._lock = threading.Lock()

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.arrays.values())

    def take(self) -> Optional[int]:
        """A free row, the first at or after the last one taken, or None
        when every row is held."""
        with self._lock:
            for i in range(self.rows):
                s = (self._next + i) % self.rows
                if self._free[s]:
                    self._free[s] = False
                    self._next = (s + 1) % self.rows
                    return s
        return None

    def release(self, slots: Iterable[int]) -> None:
        with self._lock:
            for s in slots:
                self._free[s] = True

    def in_use(self) -> int:
        with self._lock:
            return self.rows - sum(self._free)

    def write(self, slot: int, name: str, src, nbytes: int) -> None:
        """Copy the first ``nbytes`` bytes of ``src`` (any contiguous
        buffer: bytes, a numpy array) to the start of row ``slot`` of
        array ``name``."""
        if nbytes:
            row = self.arrays[name][slot].view(-1).view(torch.uint8)
            row[:nbytes].copy_(torch.frombuffer(src, dtype=torch.uint8,
                                                count=nbytes))

    @staticmethod
    def runs(slots: List[int]) -> List[Tuple[int, int, int]]:
        """``(batch row, ring row, length)`` of each run of consecutive
        ring rows in ``slots``."""
        out = []
        for i, s in enumerate(slots):
            if out and s == out[-1][1] + out[-1][2]:
                b, r, n = out[-1]
                out[-1] = (b, r, n + 1)
            else:
                out.append((i, s, 1))
        return out

    def batch(self, runs, k: int, device) -> Dict[str, torch.Tensor]:
        """The (k, ...) device batch of every array, each filled from the
        ring's rows with one non-blocking copy a run."""
        out = {}
        for name, a in self.arrays.items():
            t = torch.empty((k, *a.shape[1:]), dtype=a.dtype, device=device)
            for b, r, n in runs:
                t[b:b + n].copy_(a[r:r + n], non_blocking=True)
            out[name] = t
        return out
