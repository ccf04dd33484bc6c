"""The comparison catches what it is there to catch. Each cell is driven
at a toy size on the CPU (the look for a card skipped) with the timed path
broken underneath (``bench/faults.py``), and ``correct`` comes out false:
a step that returns its state unchanged; half of the batch left out (the
mean taken over the rest); the evaluation's accuracy taken over half of
the test rows, or its forward with All-ReLU's slopes of the wrong parity;
a feed that repeats rows. The cells run on one chip, so
there is no exchange between chips to leave out."""
import pytest

from bench.faults import FAULTS
from bench.tests.helpers import cells, toy_run


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_a_broken_step_is_not_correct(cell, fault):
    undo = FAULTS[fault]()
    try:
        r = toy_run(cell)
    finally:
        undo()
    assert r["correct"] is False, r["checks"]
