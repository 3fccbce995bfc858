"""``scan``: one camera's scan, back to back with the next.

A cycle clears the grid with the session's own reset
(``reset(full=True)``, then ``start()``), pushes the sweep's frames as fast
as the session takes them and waits in ``drain()`` until the card is done.
The clear comes first, so the last scan of the window leaves its grid for
the check.  After the window, ``process()`` (binary files, untimed) hands
over that grid's extract.
"""

from __future__ import annotations

import os

from torch.profiler import record_function

# the session's wait for a K-batch to fill: a closed loop pushes a scan's
# frames at once, so a batch always fills, and the wait only has to be
# longer than the push
BATCH_FILL_WAIT = 10.0


def prepare(session, inputs, ctx) -> None:
    session.start()


def cycle(session, inputs, ctx) -> None:
    with record_function("fb.reset"):
        session.reset(full=True)
        session.start()
    with record_function("fb.push"):
        inputs.push(session)
    with record_function("fb.drain"):
        if not session.drain():
            raise TimeoutError("the session did not drain")


def finish(session, inputs, ctx) -> dict:
    """The last scan's extract, through ``process()``."""
    r = session.process(cloud_name="check.pcd", meta_name="check.csv",
                        ascii_mode=False)
    for p in (r["cloud"], r["metadata"]):
        os.remove(p)
    return {"host": r["host"], "grid_metrics": r["grid_metrics"]}
