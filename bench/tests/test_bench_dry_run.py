"""Each cell's dry run at a toy size on the CPU: a well-formed result with
no device metric, correct against the reference."""
import json
import math

import pytest

from bench.tests.helpers import RESULT_KEYS, cells, toy_run


@pytest.mark.parametrize("cell", cells())
def test_toy_dry_run_is_well_formed(cell):
    r = toy_run(cell)
    line = json.loads(json.dumps(r))
    assert list(line)[: len(RESULT_KEYS)] == list(RESULT_KEYS)
    assert list(line)[-2:] == ["checks", "window_s"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"] == {}  # a CPU run never writes a device metric
    assert line["device"]["platform"] == "cpu"
    for c in line["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from bench import harness

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", cells()[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
