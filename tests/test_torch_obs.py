"""The port's obs substrate (``repro_torch.obs``, DESIGN.md §11): the twins
of ``tests/test_obs.py`` — metric math against a numpy oracle, the JSONL
span-tree round-trip, disabled-mode zero-allocation, the Prometheus golden
rendering, the trainer's span taxonomy and the CLI — less its two tests of
the serving gateway and ``serve/metrics.py``, which come with ROADMAP
Queue 1, item 6. Also: the port's summary of a trace equals the
reference's, and a span's ``block_on`` of a CPU tensor returns at once.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; the card's machine has none

from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.trace import NOOP_SPAN  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ---------------------------------------------------------------------------
# metrics vs numpy oracle
# ---------------------------------------------------------------------------


def test_rolling_window_percentile_matches_numpy_linear():
    clock = FakeClock()
    win = obs.RollingWindow(window_s=100.0, clock=clock)
    rng = np.random.default_rng(0)
    vals = rng.normal(10.0, 3.0, size=257)
    for v in vals:
        win.observe(float(v))
    for p in (0, 10, 25, 50, 75, 90, 95, 99, 100):
        assert win.percentile(p) == pytest.approx(
            float(np.percentile(vals, p, method="linear")), rel=1e-12
        ), p
    assert win.mean() == pytest.approx(float(np.mean(vals)))


def test_rolling_window_trim_and_nan_on_empty():
    clock = FakeClock()
    win = obs.RollingWindow(window_s=5.0, clock=clock)
    assert math.isnan(win.percentile(50)) and math.isnan(win.mean())
    win.observe(1.0)
    clock.t = 2.0
    win.observe(3.0)
    assert win.count() == 2
    clock.t = 6.5  # first sample (t=0) now older than the 5s horizon
    assert win.values() == [3.0]
    clock.t = 100.0  # everything expired
    assert win.count() == 0
    assert math.isnan(win.percentile(95))
    assert math.isnan(win.rate_per_s())  # no data must not read as rate 0


def test_rolling_window_sorted_cache_invalidates_on_write():
    clock = FakeClock()
    win = obs.RollingWindow(window_s=100.0, clock=clock)
    for v in (5.0, 1.0, 3.0):
        win.observe(v)
    assert win.percentile(100) == 5.0  # populates the cached sorted view
    win.observe(9.0)  # write must invalidate the cache
    assert win.percentile(100) == 9.0
    assert win.percentile(0) == 1.0


def test_rolling_window_rate_per_s():
    clock = FakeClock()
    win = obs.RollingWindow(window_s=100.0, clock=clock)
    win.observe(4.0)
    assert math.isnan(win.rate_per_s())  # single sample spans no interval
    clock.t = 2.0
    win.observe(6.0)
    assert win.rate_per_s() == pytest.approx((4.0 + 6.0) / 2.0)


def test_histogram_buckets_and_percentile_bounded_by_bucket_width():
    h = obs.Histogram("lat", (), control=True, bounds=(1.0, 2.0, 4.0, 8.0))
    rng = np.random.default_rng(1)
    vals = rng.uniform(0.0, 10.0, size=500)
    for v in vals:
        h.observe(float(v))
    assert h.count == 500
    assert h.sum == pytest.approx(float(np.sum(vals)))
    # bucket counts match a numpy digitize with the same inclusive edges
    expect = np.bincount(
        np.searchsorted((1.0, 2.0, 4.0, 8.0), vals, side="left"), minlength=5
    )
    assert h.counts == list(expect)
    # interpolated percentile is within one bucket of the exact answer
    for p in (50, 95, 99):
        exact = float(np.percentile(vals, p))
        lo = max(0.0, exact - 4.0)  # widest bucket is 4 wide
        assert lo <= h.percentile(p) <= exact + 4.0


def test_registry_interning_snapshot_and_kind_mismatch():
    reg = obs.MetricsRegistry(control=True, clock=FakeClock())
    c = reg.counter("reqs", route="a")
    assert reg.counter("reqs", route="a") is c  # interned by (name, labels)
    assert reg.counter("reqs", route="b") is not c
    c.inc(3)
    reg.gauge("depth").set(7)
    w = reg.window("lat_ms", window_s=60.0)
    for v in (1.0, 2.0, 3.0):
        w.observe(v)
    snap = reg.snapshot()
    assert snap['reqs{route="a"}'] == 3.0
    assert snap["depth"] == 7.0
    assert snap["lat_ms_count"] == 3.0
    assert snap["lat_ms_p50"] == 2.0
    with pytest.raises(TypeError):
        reg.gauge("reqs", route="a")  # same key, different kind


# ---------------------------------------------------------------------------
# span tracing: JSONL round-trip, tree structure, deferred serialization
# ---------------------------------------------------------------------------


def test_span_tree_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    with obs.trace_to(path, meta={"run": "test"}):
        with obs.span("outer", k=1) as sp:
            assert obs.current_span_name() == "outer"
            with obs.span("inner"):
                assert obs.current_span_name() == "inner"
                obs.point("tick", i=0)
            sp.set(loss=0.5)
        obs.event_span("window", 10.0, 11.5, rid=7)
    events = obs.read_events(path)  # only valid after trace_to closes
    assert obs.validate_events(events) == []
    assert events[0]["ev"] == "meta"
    assert events[0]["schema"] == obs.SCHEMA_VERSION
    assert events[0]["attrs"] == {"run": "test"}
    spans = {e["name"]: e for e in events if e["ev"] == "span"}
    points = [e for e in events if e["ev"] == "point"]
    assert spans["inner"]["parent"] == spans["outer"]["id"]
    assert spans["outer"]["parent"] is None
    assert spans["outer"]["attrs"] == {"k": 1, "loss": 0.5}
    assert spans["window"]["dur_s"] == pytest.approx(1.5)
    assert spans["window"]["parent"] is None  # emitted outside any span
    assert points[0]["name"] == "tick" and points[0]["attrs"] == {"i": 0}
    # spans are emitted at close: children precede parents in file order
    names = [e["name"] for e in events if e["ev"] == "span"]
    assert names.index("inner") < names.index("outer")
    # round-trip through the summarizer
    summary = obs.summarize_events(events)
    assert summary["spans"]["outer"]["count"] == 1
    # parent self-time excludes the closed child
    outer = summary["spans"]["outer"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - summary["spans"]["inner"]["total_s"]
    )
    assert "outer" in obs.format_summary(summary)
    # the reference's exporter reads the port's trace the same way
    assert jobs.validate_events(events) == []
    assert jobs.summarize_events(events) == summary
    assert jobs.format_summary(summary) == obs.format_summary(summary)


def test_deferred_serialization_flushes_on_close(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    with obs.trace_to(path) as t:
        with obs.span("a"):
            pass
        obs.point("p")
        assert t.events_written == 3  # meta + span + point, still buffered
        assert os.path.getsize(path) == 0  # nothing serialized yet
        t.flush()
        flushed = os.path.getsize(path)
        assert flushed > 0
        obs.point("q")  # lands in the buffer after the flush
    final = obs.read_events(path)
    assert [e["ev"] for e in final] == ["meta", "span", "point", "point"]
    assert os.path.getsize(path) > flushed


def test_validate_events_catches_corruption():
    good = [
        {"ev": "meta", "schema": obs.SCHEMA_VERSION, "pid": 1, "t": 0.0,
         "attrs": {}},
        {"ev": "span", "name": "s", "id": 1, "parent": None, "t0": 0.0,
         "t1": 1.0, "dur_s": 1.0, "attrs": {}},
    ]
    assert obs.validate_events(good) == []
    bad_dur = [good[0], dict(good[1], dur_s=0.25)]
    assert any("dur_s" in e for e in obs.validate_events(bad_dur))
    orphan = [good[0], dict(good[1], parent=99)]
    assert any("never closed" in e for e in obs.validate_events(orphan))
    assert any(
        "first event must be" in e for e in obs.validate_events(good[::-1])
    )
    dup = [good[0], good[1], dict(good[1])]
    assert any("duplicate span id" in e for e in obs.validate_events(dup))


# ---------------------------------------------------------------------------
# disabled mode: a true no-op
# ---------------------------------------------------------------------------


def test_disabled_mode_allocates_nothing(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    telemetry = obs.MetricsRegistry()
    hist = telemetry.histogram("h", bounds=(1.0,))
    win = telemetry.window("w")
    gauge = telemetry.gauge("g")
    with obs.trace_to(path) as t:
        before_events = t.events_written
        with obs.disabled():
            a0 = obs.debug_allocs()
            for i in range(100):
                with obs.span("hot", i=i):
                    obs.point("tick")
                obs.event_span("ev", 0.0, 1.0)
                hist.observe(0.5)
                win.observe(0.5)
                gauge.set(i)
            assert obs.debug_allocs() - a0 == 0  # zero obs allocations
        assert t.events_written == before_events
    assert hist.count == 0 and win.count() == 0
    assert math.isnan(gauge.value)


def test_disabled_span_is_the_noop_singleton(tmp_path):
    with obs.trace_to(str(tmp_path / "t.jsonl")):
        with obs.disabled():
            assert obs.span("x") is NOOP_SPAN
            assert obs.span("y", k=1) is NOOP_SPAN
            # noop span still honours the Span surface
            sp = obs.span("z")
            assert sp.set(a=1) is sp
            assert sp.block_on("v") == "v"
    obs.shutdown()
    assert obs.span("no_tracer_installed") is NOOP_SPAN


def test_control_registry_ignores_disabled():
    reg = obs.MetricsRegistry(control=True, clock=FakeClock())
    win = reg.window("lat")
    with obs.disabled():
        win.observe(5.0)
        reg.counter("n").inc()
    assert win.count() == 1  # control series keep steering the gateway
    assert reg.counter("n").value == 1.0


# ---------------------------------------------------------------------------
# Prometheus text golden
# ---------------------------------------------------------------------------


def test_prometheus_text_golden():
    reg = obs.MetricsRegistry(control=True, clock=FakeClock())
    reg.counter("a_total").inc(3)
    reg.counter("a_total", stage="x").inc(2)
    reg.gauge("b_depth").set(2.5)
    h = reg.histogram("c_lat", bounds=(1.0, 2.0))
    for v in (0.5, 1.5, 5.0):
        h.observe(v)
    reg.window("d_win", window_s=60.0).observe(2.5)
    assert obs.prometheus_text(reg) == (
        "# TYPE a_total counter\n"
        "a_total 3\n"
        'a_total{stage="x"} 2\n'
        "# TYPE b_depth gauge\n"
        "b_depth 2.5\n"
        "# TYPE c_lat histogram\n"
        'c_lat_bucket{le="1"} 1\n'
        'c_lat_bucket{le="2"} 2\n'
        'c_lat_bucket{le="+Inf"} 3\n'
        "c_lat_sum 7\n"
        "c_lat_count 3\n"
        "# TYPE d_win summary\n"
        'd_win{quantile="0.5"} 2.5\n'
        'd_win{quantile="0.95"} 2.5\n'
        'd_win{quantile="0.99"} 2.5\n'
        "d_win_count 1\n"
    )


# ---------------------------------------------------------------------------
# integration smokes: the documented span taxonomy actually shows up
# ---------------------------------------------------------------------------


def test_trainer_emits_span_taxonomy(tmp_path):
    from repro_torch.data import datasets
    from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
    from repro_torch.train.trainer import SequentialTrainer, TrainerConfig

    data = datasets.load("fashionmnist", scale=0.02, seed=0)
    cfg = SparseMLPConfig(
        layer_dims=(data.n_features, 32, 16, data.n_classes),
        epsilon=8, activation="all_relu", alpha=0.6, dropout=0.0,
        impl="element",
    )
    tc = TrainerConfig(epochs=2, batch_size=32, lr=0.01, zeta=0.2, seed=0)
    path = str(tmp_path / "train.jsonl")
    with obs.trace_to(path, meta={"bench": "test"}):
        SequentialTrainer(SparseMLP(cfg, seed=0, device="cpu"), data, tc).run()
    events = obs.read_events(path)
    assert obs.validate_events(events) == []
    span_names = {e["name"] for e in events if e["ev"] == "span"}
    assert {"train.run", "train.epoch", "train.segment"} <= span_names
    epochs = [e for e in events if e.get("name") == "train.epoch"]
    assert len(epochs) == 2
    run_span = next(e for e in events if e.get("name") == "train.run")
    assert all(e["parent"] == run_span["id"] for e in epochs)
    segments = [e for e in events if e.get("name") == "train.segment"]
    assert sorted(e["parent"] for e in segments) == sorted(e["id"] for e in epochs)


def test_cli_validate_and_summarize(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with obs.trace_to(path):
        with obs.span("work"):
            obs.point("tick")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")]
    )
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "validate", path],
        capture_output=True, text=True, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "PASS" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", path],
        capture_output=True, text=True, env=env,
    )
    assert out.returncode == 0, out.stderr
    assert "work" in out.stdout
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", "--json", path],
        capture_output=True, text=True, env=env,
    )
    assert json.loads(out.stdout)["spans"]["work"]["count"] == 1


def test_block_on_cpu_tensors_returns_at_once(tmp_path):
    """A span's close waits only for CUDA tensors; CPU tensors (and other
    objects, in nested containers) are ready: nothing to wait for."""
    from repro_torch.obs import trace

    with obs.trace_to(str(tmp_path / "t.jsonl")):
        with obs.span("s") as sp:
            x = torch.ones(3)
            assert sp.block_on({"a": (x, [x * 2]), "b": "v"})["a"][0] is x
    found = set()
    trace._cuda_devices({"a": (torch.ones(2), [torch.zeros(1)]), "b": 3}, found)
    assert found == set()
