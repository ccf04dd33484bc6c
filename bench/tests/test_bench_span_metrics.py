"""The readers of the trainer's phase spans (``eval_ms.mlp``,
``eval_h2d_mb.mlp``, ``run_prepare_s.mlp``) on hand-built spans, and
silent where the program has none (a parent commit without the spans)."""
import pytest

from bench.harness import ROOT, TraceReading, load_module


def reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def span(sid, name, parent, t0, dur, **attrs):
    return {"name": name, "id": sid, "parent": parent, "t0": t0, "t1": t0 + dur,
            "dur_s": dur, "attrs": attrs}


def reading(spans):
    return TraceReading([], 1.0, 1, 218, spans, {}, True, 0.0)


def phases():
    spans = [span(1, "train.prepare", 100, 0.0, 5.5, h2d_bytes=1_835_036_000),
             span(2, "train.prepare", 100, 90.0, 7.0, h2d_bytes=0)]
    for epoch, (sid, ms, h2d) in enumerate([(10, 300, 9), (20, 250, 9),
                                            (30, 150, 786_444_000), (40, 170, 786_444_000)]):
        spans.append(span(sid, "train.epoch", 100, 10.0 + epoch, 1.4, epoch=epoch))
        spans.append(span(sid + 1, "train.evaluate", sid, 11.0 + epoch, ms / 1e3,
                          rows=3000, batches=6, acc=0.5, h2d_bytes=h2d))
    return spans


def test_readers_on_hand_built_spans():
    tr = reading(phases())
    assert reader("eval_ms.mlp")(tr) == pytest.approx(160.0)  # epochs 2 and 3
    assert reader("eval_h2d_mb.mlp")(tr) == pytest.approx(786.444)
    assert reader("run_prepare_s.mlp")(tr) == 5.5  # the first by its start


@pytest.mark.parametrize("name", ["eval_ms.mlp", "eval_h2d_mb.mlp", "run_prepare_s.mlp"])
def test_readers_silent_without_the_spans(name):
    # the parent's trainer: epochs and segments only
    old = [span(10, "train.epoch", None, 0.0, 1.4, epoch=2),
           span(11, "train.segment", 10, 0.0, 1.2, steps=218)]
    assert reader(name)(reading(old)) is None
    assert reader(name)(reading([])) is None


def test_eval_bytes_silent_without_the_count():
    spans = [s for s in phases() if s["name"] != "train.prepare"]
    for s in spans:
        s["attrs"].pop("h2d_bytes", None)
    assert reader("eval_h2d_mb.mlp")(reading(spans)) is None
    assert reader("eval_ms.mlp")(reading(spans)) == pytest.approx(160.0)
