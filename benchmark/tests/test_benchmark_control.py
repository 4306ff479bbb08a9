"""The control comes out not correct: the reference with TF32 products (the
nearest precision below the float32 the configurations state) put in the
program's place, against the float32 reference, at the cells' widths on a
64^2 image (the card reads it at the cells' own size:
``benchmark/calibrate.py``)."""
import pytest
import torch

from benchmark import calibrate, check
from benchmark.harness import CellRun
from benchmark.tests import short

CELLS = list(short.CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails_a_limit(cell):
    torch.set_num_threads(2)
    s = CellRun(short.spec(), cell, "cpu",
                overrides={"traffic": {"image_size": 128}})
    seed = 2 ** 31 + 5
    values = check.step_numbers(
        calibrate.as_program(s.reference(seed, "tf32")), s.reference(seed))
    failed = [k for k, v in values.items() if v > s.limits[k]["limit"]]
    assert failed, (values, s.limits)
