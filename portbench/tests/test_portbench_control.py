"""The controls at a size a test run holds: the reference in the
precision below the configuration's, put in the program's place, must read
at least three times what the program reads on one of the cell's numbers,
and half a batch left out at least ten times. The limits themselves are set
from ``python3 -m portbench.control``'s readings at the cells' own sizes on
the card (PERF.md), where relative noise is smaller than at these widths;
the card-marked case repeats this one there."""
import pytest
import torch

from portbench import control, spec
from portbench.run import Run
from portbench.tests.tiny import tiny

CELLS = ["gan_su.train", "enc.train_mixed", "gan_su.generate"]


def _readings(cell_name, device, seed):
    cell = spec.load_cell(cell_name, overrides=tiny(cell_name))
    run = Run(cell, seed, 0.0, torch.device(device))
    fn = (control.synthesis if cell.driver == "generate"
          else control.training)
    return cell, fn(run, spec.driver(cell.driver))


def _above(numbers, program, limits, times):
    return [k for k in limits
            if k in program and numbers[k] >= times * program[k]]


def _check(cell_name, device):
    for seed in (2 ** 36 + 1, 5):
        cell, readings = _readings(cell_name, device, seed)
        program = readings["program"]
        assert _above(readings["control"], program, cell.limits, 3), readings
        if "half_batch" in readings:
            assert _above(readings["half_batch"], program, cell.limits,
                          10), readings


def test_encoder_products_in_bf16_read_above_the_program():
    """The encoder's products alone in bf16, its convolutions as
    configured, move its outputs by three times the program's gap."""
    _, readings = _readings("enc.train_mixed", "cpu", 2 ** 37 + 3)
    assert (readings["products_bf16"]["out_gap"]
            >= 3 * readings["program"]["out_gap"]), readings


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program(cell):
    _check(cell, "cpu")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_above_the_program_on_the_card(card, cell):
    _check(cell, "cuda")
