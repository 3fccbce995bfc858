"""The readers of the session's staging span ``push.stage``: the time a
frame's copy into its ring row takes, and the share of the window's frames
that took a row, with nothing read where the program has no such span."""

import pytest

from fusionbench.harness import registry


def read(name, **ctx):
    return registry.module("metrics", name).read(ctx)


def timers(**spans):
    return {k.replace("__", "."): {"total_s": v[0], "count": v[1]}
            for k, v in spans.items()}


WINDOW = timers(device_step=(0.4, 100), device_wait=(0.02, 100),
                device_step__upload=(0.1, 100),
                device_step__launch=(0.2, 100), refine=(0.2, 100),
                push__stage=(0.4, 800))


@pytest.mark.parametrize("name,want", [
    ("session.push_stage_ms", 0.5),
    ("session.pinned_share", 1.0),
])
def test_push_stage_readers(name, want):
    assert read(name, timers=WINDOW, frames=800) == pytest.approx(want)
    # the parent program has no push.stage span: nothing, no raise
    old = {k: v for k, v in WINDOW.items() if k != "push.stage"}
    assert read(name, timers=old, frames=800) is None
    assert read(name, timers={}, frames=800) is None


def test_pinned_share_counts_frames_without_a_row():
    # 600 of 800 frames staged: the other 200 took the pageable path
    t = timers(push__stage=(0.3, 600))
    assert read("session.pinned_share", timers=t, frames=800) == \
        pytest.approx(0.75)
    assert read("session.pinned_share", timers=t, frames=0) is None
