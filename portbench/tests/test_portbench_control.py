"""The comparison fails what it should, at a size a test run can hold on
the CPU: the reference in TF32 put in the program's place (the control),
and each fault that a cell can have planted in the program underneath a
whole run (the look for a card skipped). A sound run of the program
passes."""

import pytest
import torch

from portbench import calibrate, checks, faults, harness

SMALL = {"batch_size": 2, "sample_num": 2048}
FEW = {"pool": 4, "rooms": 4}
# every sampled request served within the window, also on a busy CPU
SERVE = {"pool": 2, "rooms": 2, "checked_requests": 2, "warmup_requests": 1}
CELLS = ["semantic3d.serve", "semantic3d.train"]


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run(cell, seed):
    serve = cell.endswith("serve")
    return harness.run(cell, seed, 4.0 if serve else 0.1, False, "cpu",
                       overrides=SMALL, mix_overrides=SERVE if serve else FEW)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = run(cell, 2**31 + 101)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = harness.load_cell(cell, overrides=SMALL,
                          mix_overrides=SERVE if cell.endswith("serve")
                          else FEW)
    numbers = calibrate.control(c, 2**31 + 102, "cpu")
    # as the result line compares: each number that has a limit
    assert not checks.verdict({k: {"value": numbers[k], "limit": lim}
                               for k, lim in c.limits.items()}), numbers


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in faults.for_kind("serve" if c.endswith("serve") else "train")])
def test_a_planted_fault_is_not_correct(cell, fault):
    kind = "serve" if cell.endswith("serve") else "train"
    with faults.planted(fault, kind):
        res = run(cell, 2**31 + 103)
    assert res["correct"] is False, res["checks"]
