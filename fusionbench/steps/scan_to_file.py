"""``scan_to_file``: a scan, then its files, as the reference node's
``process`` service gives them.

A cycle removes the previous cycle's files, pushes the sweep's frames and
calls ``process()`` with its defaults: the final refine where one is due,
the extract, the ASCII PCD and the metadata CSV written into the run's
own directory, and the grid cleared (the reference's ``downloadData``
then ``clearVoxels``).  After the window, the last cycle's files are
parsed back (``reference/files.py``) and judged with the extract
``process()`` returned.
"""

from __future__ import annotations

import os

from torch.profiler import record_function

# the session's wait for a K-batch to fill: a closed loop pushes a scan's
# frames at once, so a batch always fills, and the wait only has to be
# longer than the push
BATCH_FILL_WAIT = 10.0

from fusionbench.reference import files


def prepare(session, inputs, ctx) -> None:
    session.start()
    ctx["last"] = None


def _remove(ctx) -> None:
    last = ctx.get("last")
    if last is not None:
        for p in (last["cloud"], last["metadata"]):
            os.remove(p)
        ctx["last"] = None


def cycle(session, inputs, ctx) -> None:
    _remove(ctx)
    with record_function("fb.push"):
        inputs.push(session)
    with record_function("fb.process"):
        ctx["last"] = session.process()
    ctx["bytes_written"] += sum(os.path.getsize(ctx["last"][k])
                                for k in ("cloud", "metadata"))


def finish(session, inputs, ctx) -> dict:
    """The last cycle's extract and the files it wrote, read back."""
    r = ctx["last"]
    pcd = files.read_pcd(r["cloud"])
    csv = files.read_csv(r["metadata"])
    _remove(ctx)
    return {"host": r["host"], "grid_metrics": r["grid_metrics"],
            "pcd": pcd, "csv": csv}
