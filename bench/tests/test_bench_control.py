"""The control, the reference put in the program's place and computed in
the precision just below the configuration's (TF32 for the f32 SET-MLP),
comes out not correct under each cell's limits, here at a toy size on the
CPU (the same check on the card at the cells' own sizes and seeds is in
PERF.md)."""
import pytest
import torch

from bench import compare
from bench.harness import Cell, Context, SubWindow
from bench.tests.helpers import cells

CONTROL = {"set_mlp_train": "tf32"}


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    c = Cell(cell)
    prog = c.runner().build(Context(c, 2**31 + 5, torch.device("cpu"), toy=True))
    prog.measure(0.0, SubWindow(False))
    checks = compare.judged(prog.control_readings(CONTROL[c.workload["runner"]]), c.limits)
    assert any(v > lim for _, v, lim in checks), checks
