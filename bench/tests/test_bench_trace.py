"""The trace reading's arithmetic by hand (``bench/harness.py``): the
device's busy union, its idle gaps, their labels by the innermost port
span, and the breakdown's lists."""
from bench.harness import TraceReading, breakdown


def reading():
    ops = [("k1", 10.0, 2.0), ("k2", 11.0, 3.0), ("copy", 16.0, 1.0), ("k1", 18.5, 0.5)]
    spans = [{"name": "train.epoch", "t0": 9.0, "t1": 20.0},
             {"name": "train.segment", "t0": 9.5, "t1": 15.0}]
    return TraceReading(ops, 10.0, 1, 4, spans, {}, True, 10.0)


def test_busy_union_and_gaps():
    tr = reading()
    assert tr.busy_s == 4.0 + 1.0 + 0.5  # [10, 14] merged, [16, 17], [18.5, 19]
    assert tr.idle_gaps() == [(14.0, 2.0), (17.0, 1.5), (19.0, 1.0)]
    assert tr.kernel_seconds(r"^k1$") == (2.5, 2)


def test_gap_labels_and_breakdown():
    tr = reading()
    assert tr.span_at(12.0) == "train.segment" and tr.span_at(16.5) == "train.epoch"
    assert tr.span_at(25.0) == "bench"
    b = breakdown(tr)
    assert b["device_ops"][0] == ["k2", 3.0]
    assert b["idle_gaps"][0] == ["train.segment", 2.0]  # the gap opens at 14.0
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
