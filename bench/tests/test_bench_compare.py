"""The comparison's numbers by hand (``bench/compare.py``)."""
import math

import torch

from bench import compare


def snap(loss, grad, delta):
    t = lambda d: {k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}  # noqa: E731
    return {"loss": loss, "grad": t(grad), "delta": t(delta)}


def test_gap_of_norms_and_norm_of_difference_by_the_worst_leaf():
    ref = snap([2.0, 1.0, 1.0], {"a": [4.0, 3.0], "b": [0.0, 10.0], "tiny": [1e-6, 0.0]},
               {"a": [4.0, 3.0], "b": [0.0, 10.0], "tiny": [1e-6, 0.0]})
    prog = snap([2.5, 1.0, 1.0], {"a": [3.0, 4.0], "b": [0.0, 10.0], "tiny": [1.0, 0.0]},
                {"a": [4.0, 3.0], "b": [0.0, 9.0], "tiny": [0.0, 0.0]})
    got = compare.numbers(prog, ref)
    assert got["loss_gap.step1"] == 0.25 and got["loss_gap.step2"] == 0.0
    # of all three, the median leaf norm is 5 ("a"): "tiny" is under 1e-3 of
    # it and left out; over the two counted, the median is 7.5
    assert compare.counted_leaves(ref["grad"]) == ["a", "b"]
    assert got["grad_norm_gap"] == 0.0
    assert math.isclose(got["grad_diff"], math.sqrt(2) / 7.5, rel_tol=1e-6)
    assert math.isclose(got["update_norm_gap"], 1 / 10, rel_tol=1e-6)
    assert math.isclose(got["update_diff"], 1 / 10, rel_tol=1e-6)


def test_a_nan_fails_every_limit():
    ref = snap([1.0], {"a": [1.0], "b": [2.0]}, {"a": [1.0], "b": [2.0]})
    prog = snap([float("nan")], {"a": [float("nan")], "b": [2.0]}, {"a": [1.0], "b": [2.0]})
    got = compare.numbers(prog, ref)
    assert got["loss_gap.step1"] == math.inf and got["grad_norm_gap"] == math.inf
    checks = compare.judged(got, {"grad_norm_gap": 1.0, "update_norm_gap": 1.0})
    assert [v > lim for _, v, lim in checks] == [True, False]


def test_eval_numbers_by_hand():
    ref = torch.tensor([[3.0, 0.0], [0.0, 4.0], [1.0, 0.0]])
    labels = [0, 1, 1]  # the reference gets rows 0 and 1 right
    prog = ref + torch.tensor([[0.0, 0.0], [0.0, 0.05], [0.0, 0.0]])
    got = compare.eval_numbers(prog, 2 / 3, ref, labels)
    assert math.isclose(got["eval_logit_diff"], 0.05 / math.sqrt(26), rel_tol=1e-5)
    assert got["eval_acc_rows"] == 0.0
    # an accuracy one row off, over the same logits
    assert math.isclose(compare.eval_numbers(prog, 1.0, ref, labels)["eval_acc_rows"], 1.0)
    # an evaluation over fewer rows, or none, or with a NaN, fails every limit
    assert compare.eval_numbers(prog[:2], 1.0, ref, labels)["eval_logit_diff"] == math.inf
    assert compare.eval_numbers(None, 2 / 3, ref, labels)["eval_logit_diff"] == math.inf
    bad = prog.clone()
    bad[0, 0] = float("nan")
    assert compare.eval_numbers(bad, float("nan"), ref, labels) == {
        "eval_logit_diff": math.inf, "eval_acc_rows": math.inf}


def test_feed_rows_missed_by_hand():
    sound = [[[3, 0], [2, 5]], [[1, 4], [0, 2]]]  # two epochs of 4 distinct rows of 6
    assert compare.feed_rows_missed(sound, 6, 4) == 0
    assert compare.feed_rows_missed([[[3, 0], [3, 0]]], 6, 4) == 2  # a repeated batch
    assert compare.feed_rows_missed([[[3, 0], [2, 6]]], 6, 4) == 1  # a row out of range
    assert compare.feed_rows_missed([[[3, 0]]], 6, 4) == 2  # a short epoch


def test_a_window_that_raised_reads_infinite(monkeypatch):
    from bench.tests.helpers import cells, toy_run
    from repro_torch.train import trainer

    def raising(*args, **kwargs):
        raise RuntimeError("a step that raised")

    monkeypatch.setattr(trainer.SequentialTrainer, "_run_fused", raising)
    r = toy_run(cells()[0])
    assert r["correct"] is False and r["failed"] > 0
    assert all(c["value"] == math.inf for c in r["checks"].values())
