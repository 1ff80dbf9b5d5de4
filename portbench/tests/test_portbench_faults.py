"""The check catches the faults each cell can have: a run driven whole
on the CPU, past the harness's look for a card, with the timed path broken
underneath, comes out not correct. On a card, the control (the precision
below the configuration's) comes out not correct at each cell's own size."""

import time

import pytest

from portbench import harness

from conftest import tiny_cell

FAULTS = [("ast128.recordings_gated", "fault:answer"),
          ("ast128.recordings_gated", "fault:summary"),
          ("ast1024.finetune_b16", "fault:unchanged"),
          ("ast1024.finetune_b16", "fault:half_batch")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = harness.run_cell(tiny_cell(name), 2 ** 31 + 91, 0.5, False,
                           time.perf_counter(), device="cpu", variant=fault,
                           log=lambda m: None)
    assert not out["correct"], out["checks"]


def test_a_recording_the_capture_missed_is_not_correct(monkeypatch):
    from portbench.kinds import recordings

    monkeypatch.setattr(recordings.Driver, "_capture", lambda self: None)
    out = harness.run_cell(tiny_cell("ast128.recordings_gated"), 2 ** 31 + 93,
                           0.5, False, time.perf_counter(), device="cpu",
                           log=lambda m: None)
    assert out["checks"]["capture"]["value"] > 0 and not out["correct"]
    assert out["metrics"]["windows_per_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["ast1024.recordings_gated",
                                  "ast1024.finetune_b16",
                                  "ast128.recordings_gated"])
def test_the_control_is_not_correct(card, name):
    cell = harness.find(name)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out = harness.run_cell(cell, seed, 2.0, False, time.perf_counter(),
                               variant="control", log=lambda m: None)
        assert not out["correct"], (seed, out["checks"])
