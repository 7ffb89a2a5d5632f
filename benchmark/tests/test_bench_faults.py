"""``correct`` comes out false with the timed path broken underneath: the
rest of a run but its window, which runs on the card alone (set-up, the
checked micro steps through the window's step, the reference, the
comparison with the cell's own limits), on the CPU at a tiny size in fp32,
where sound runs agree to rounding. On the card (``cuda`` marker): the
control, the reference in float8 put in the program's place, fails the
cell's limits at the cell's own size."""

import pytest
import torch

import faults
import harness
from conftest import tiny_cell

DEV = torch.device("cpu")


def _run(cell_name, breaker=None):
    cell = tiny_cell(cell_name, "float32")
    seed = 2 ** 31 + 21
    prog = harness.prepare(cell, seed, DEV, breaker)[3]
    correct, _, lines = harness.verdict(cell, seed, prog, DEV)
    return correct, lines


def test_sound_run_is_correct(cell_name):
    correct, lines = _run(cell_name)
    assert correct, lines


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(cell_name, fault):
    correct, lines = _run(cell_name, faults.FAULTS[fault])
    assert not correct, lines


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["perf-joint-b64", "default-joint-b22"])
def test_control_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    import check

    cell = harness.load_cell(name)
    device = torch.device("cuda", 0)
    seed = 2 ** 31 + 901
    ref = harness.reference_readings(cell, seed, device)
    ctl = harness.reference_readings(cell, seed, device, "fp8")
    correct, lines = check.judge(check.numbers(ctl, ref), cell.limits)
    assert not correct, lines
