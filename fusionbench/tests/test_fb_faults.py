"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.
The cells run on one card, so there is no exchange between cards to
leave out."""

import numpy as np
import pytest

from fusionbench.harness import registry
from fusionbench.tests import tiny

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
STEPS = ("step", "step_batch", "step_depth", "step_batch_depth")


def unchanged(session):
    """Every step returns its grid as it was."""
    for name in STEPS:
        setattr(session.pipeline, name, lambda grid, *a, **k: grid)


def half_batch(session):
    """A batch's second half of frames is left out."""
    pipe = session.pipeline
    for name in ("step_batch", "step_batch_depth"):
        real = getattr(pipe, name)

        def first_half(grid, *args, _real=real, **kw):
            k = max(args[0].shape[0] // 2, 1)
            cut = [a[:k] if (hasattr(a, "shape") and a.dim() >= 1
                             and a.shape[0] == args[0].shape[0]) else a
                   for a in args]
            return _real(grid, *cut, **kw)

        setattr(pipe, name, first_half)


def altered_answer(session):
    """One emitted cell's centroid moved by 2 mm where the extract
    produces it."""
    pipe = session.pipeline
    real = pipe.extract_host

    def extract_host(grid, *a, **k):
        out = real(grid, *a, **k)
        if out["cell"].size:
            c = np.array(out["centroid"], copy=True)
            c[out["cell"].size // 2, 0] += 2e-3
            out["centroid"] = c
        return out

    pipe.extract_host = extract_host


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault):
    r = tiny.run(name, patch=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_passes(name):
    r = tiny.run(name, seed=2 ** 31 + 12345)
    assert r["correct"] is True, r["checks"]
