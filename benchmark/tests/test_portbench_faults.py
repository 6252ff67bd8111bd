"""The check fails what it must: a whole run at a tiny size on the CPU
(the look for a card skipped) with the timed path broken under it
(``benchmark/faults.py``), and the control (the reference in the next
precision below the configuration's, in the program's place).  The
cells run on one card, so there is no exchange between cards to leave
out."""

import pytest
import torch

from benchmark import calibrate, faults, harness
from benchmark.tests.tiny import CELLS, SEED, TINY


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault):
    with faults.planted(fault) as calls:
        r = harness.run_cell(name, SEED, 0.0, False, device="cpu",
                             overrides=TINY[name])
    assert calls[0] > 0
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    reading = calibrate.control_reading(name, SEED, torch.device("cpu"),
                                        TINY[name])
    assert reading["limits_pass"] is False
