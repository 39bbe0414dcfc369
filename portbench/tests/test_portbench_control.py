"""The check must fail what it exists to catch.  At the reduced size on the
CPU: the control (the reference in fp8 put in the program's place) reads
above the cell's limits, and a whole run, with the look for a
chip skipped and the timed path broken underneath, comes out not correct
for each fault the cell can have, and for a training step that goes wrong
only once its first steps are over."""
import time

import pytest

import _small
from portbench import calibrate, harness

FAULTS = {
    "train": ["unchanged", "unchanged_when_warm", "half_batch",
              "loss_altered"],
    "prefill": ["unchanged", "half_batch", "token_altered"],
}


def _kind(cell):
    return harness.load("traffic", harness.cell_of(cell)["traffic"])["kind"]


@pytest.mark.parametrize("cell", _small.CELLS)
def test_control_is_not_correct(cell):
    values = calibrate.control(harness, cell, 2 ** 31 + 23, 0.2,
                               device="cpu", **_small.overrides(cell))["fp8"]
    limits = harness.load("limits", cell)
    assert any(values[k] > limits[k] for k in limits), (values, limits)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in _small.CELLS for f in FAULTS[_kind(c)]])
def test_fault_is_not_correct(cell, fault):
    out = harness.run_cell(cell, 2 ** 31 + 29, 0.2, False,
                           time.perf_counter(), device="cpu", fault=fault,
                           **_small.overrides(cell))
    assert out["correct"] is False, out["checks"]
