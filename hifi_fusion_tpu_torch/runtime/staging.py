"""The session's staging rings: host rows that pushed frames are copied into.

``FusionSession`` copies every pushed frame's bytes into a row of a ring on
the pushing thread, and its queue holds the ``(ring, row)`` pair instead
of the caller's objects.  Most frames take a free row of the session's
ring (the span ``push.stage``); a frame of another layout, or one pushed
while every row is held, takes the one row of a ring of its own.  A
dispatch allocates its device batch and fills it from the batch's rows
with one asynchronous copy per array for each run of consecutive rows of
one ring (``runs``, ``batch``): one run, or two where the rows wrap round
the ring's end.  Where the rows are pinned (the session's ring on a CUDA
device, for the arrays copied to the card), the copies are DMA on the
compute stream, in stream order after the previous dispatch's kernels,
and return at once; elsewhere they are plain host rows through the same
code.

A row is taken on the pushing thread and released when its frame is
dropped from the queue or reset away, or once the events recorded after
its dispatch have fired (the session's ``_await_device`` and ``drain``).
Rows are taken next-fit from the last row taken, so frames queued in
order hold consecutive rows; any free row serves when they do not.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def runs(rows: Sequence[Tuple[StagingRing, int]]
         ) -> List[Tuple[int, StagingRing, int, int]]:
    """``(batch row, ring, ring row, length)`` of each run of consecutive
    rows of one ring in ``rows``, ``(ring, row)`` pairs."""
    out = []
    for i, (ring, s) in enumerate(rows):
        if out and out[-1][1] is ring and s == out[-1][2] + out[-1][3]:
            b, _, r, n = out[-1]
            out[-1] = (b, ring, r, n + 1)
        else:
            out.append((i, ring, s, 1))
    return out


def batch(runs, k: int, device, names: Sequence[str] = None
          ) -> Dict[str, torch.Tensor]:
    """The (k, ...) device batch of each array ``names`` lists (default:
    every array) of the runs' rings, which share one layout, filled from
    their rows with one non-blocking copy a run."""
    arrays = runs[0][1].arrays
    out = {}
    for name in names or arrays:
        a = arrays[name]
        t = torch.empty((k, *a.shape[1:]), dtype=a.dtype, device=device)
        for b, ring, r, n in runs:
            t[b:b + n].copy_(ring.arrays[name][r:r + n], non_blocking=True)
        out[name] = t
    return out
