"""The port's training-dynamics probes (``repro_torch.obs.probes``,
``timeline``, ``detect``; DESIGN.md §12) against the JAX reference on the
CPU: the twins of the 23 tests of ``tests/test_probes.py`` that are not lint
tests (its five lint tests wait for the contract auditor's twin, ROADMAP
Queue 1, item 8), and the probe's wiring into the port's trainer.

* Every reduction is held against the reference's function on the same
  numpy-seeded inputs, at rtol 1e-5 (f32 sums in another order) and exactly
  for the integer histograms and fractions.
* The reference's "byte-identical program" test becomes two checks: the
  probe-off segment's outputs are bit-equal to ``scan_segment`` over
  ``make_mlp_step_core`` called directly, and a spy on
  ``probes.segment_probe`` and on ``mlp_forward(return_preacts=True)``
  counts no call; the probed segment's first four outputs are bit-equal to
  the probe-off segment's.
* Probed ``SequentialTrainer`` runs of both packages (3 fused epochs, device
  SET, the port fed the reference's draws as ``tests/
  test_torch_device_train.py`` feeds them): equal topologies, the loss
  history at rtol 1e-4 and every snapshot's stats within 1e-4 relative
  (+1e-6), the histograms and churn equal. A probed run is bit-equal to the
  unprobed one under ``obs.disabled()``.
* ``mlp_forward(..., return_preacts=True)`` against the reference's, and its
  logits bit-equal to the forward without it (kernel A's store of z + bias,
  then B's All-ReLU: the fused store's bits).
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.models import mlp as jmlp  # noqa: E402
from repro.obs import probes as jprobes  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig  # noqa: E402
from repro_torch.obs import detect, probes, timeline  # noqa: E402
from repro_torch.optim.sgd import MomentumSGD  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    SequentialTrainer,
    TrainerConfig,
    make_segment_program,
)

jax.config.update("jax_platform_name", "cpu")

SRC = str(Path(__file__).resolve().parents[1] / "src")
STAT_RTOL, STAT_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _clean_global_probe_state():
    """Every test starts and ends with no monitor, no timeline, no
    snapshot transform — these are process-globals — and one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    probes.set_snapshot_transform(None)
    detect.configure(None)
    timeline.configure(None)
    yield
    probes.set_snapshot_transform(None)
    detect.configure(None)
    timeline.configure(None)
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# stat reductions vs numpy oracles and the reference's functions
# ---------------------------------------------------------------------------


def test_value_l2_and_zero_fraction_match_numpy():
    rng = np.random.default_rng(0)
    v = rng.normal(size=257).astype(np.float32)
    v[::5] = 0.0
    want = float(np.sqrt(np.sum(np.square(v, dtype=np.float64))))
    assert float(probes.value_l2(_t(v))) == pytest.approx(want, rel=1e-5)
    assert float(probes.value_l2(_t(v))) == pytest.approx(
        float(jprobes.value_l2(jnp.asarray(v))), rel=1e-6)
    assert float(probes.zero_fraction(_t(v))) == float(jprobes.zero_fraction(jnp.asarray(v))) \
        == pytest.approx(float(np.mean(v == 0)))
    # bf16 storage: accumulated in f32
    vb = torch.as_tensor(v).bfloat16()
    assert float(probes.value_l2(vb)) == pytest.approx(
        float(np.sqrt(np.sum(np.square(vb.float().numpy(), dtype=np.float64)))), rel=1e-5)
    st = probes.layer_value_stats(_t(v))
    assert set(st) == {"value_l2", "value_zero_frac"}


def test_saturation_and_grad_sq_norm_match_numpy():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(33, 7)).astype(np.float32)
    assert float(probes.saturation_fraction(_t(z))) == pytest.approx(float(np.mean(z <= 0)))
    assert float(probes.saturation_fraction(_t(z))) == float(
        jprobes.saturation_fraction(jnp.asarray(z)))
    tree = {"a": _t(z), "b": (_t(z[0]), _t(z[1]))}
    want = float(
        np.sum(np.square(z, dtype=np.float64))
        + np.sum(np.square(z[0], dtype=np.float64))
        + np.sum(np.square(z[1], dtype=np.float64))
    )
    assert float(probes.grad_sq_norm_tree(tree)) == pytest.approx(want, rel=1e-5)
    jtree = {"a": jnp.asarray(z), "b": (jnp.asarray(z[0]), jnp.asarray(z[1]))}
    assert float(probes.grad_sq_norm_tree(tree)) == pytest.approx(
        float(jprobes.grad_sq_norm_tree(jtree)), rel=1e-6)


def test_importance_quantiles_match_numpy():
    rng = np.random.default_rng(2)
    out_dim = 11
    vals = rng.normal(size=64).astype(np.float32)
    cols = rng.integers(0, out_dim, size=64)
    got = probes.importance_quantiles(_t(vals), _t(cols), out_dim).numpy()
    imp = np.bincount(cols, weights=np.abs(vals), minlength=out_dim)
    want = np.quantile(imp, probes.IMPORTANCE_QS)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = np.asarray(jprobes.importance_quantiles(jnp.asarray(vals), jnp.asarray(cols), out_dim))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # column-sorted slots with their offsets (an element topology's canonical
    # order) give the same, and the importance twin sums in slot order
    order = np.argsort(cols, kind="stable")
    scols = torch.as_tensor(cols[order]).int()
    col_ptr = torch.searchsorted(scols, torch.arange(out_dim + 1, dtype=torch.int32))
    got2 = probes.importance_quantiles(_t(vals[order]), scols, out_dim, col_ptr=col_ptr)
    np.testing.assert_allclose(got2.numpy(), want, rtol=1e-5)
    imp_t = timp.neuron_importance_jnp(_t(vals), _t(cols), out_dim)
    np.testing.assert_allclose(imp_t.numpy(), imp, rtol=1e-6)
    from repro.core import importance as jimp

    np.testing.assert_allclose(
        imp_t.numpy(), np.asarray(jimp.neuron_importance_jnp(jnp.asarray(vals),
                                                              jnp.asarray(cols), out_dim)),
        rtol=1e-6)


def test_degree_histogram_and_dead_fraction_match_numpy():
    dim = 20
    # degrees: neuron 0 -> 0 links (dead), 1 -> 1, 2 -> 3, 3 -> 8
    idx = np.array([1] + [2] * 3 + [3] * 8)
    got = probes.degree_histogram(_t(idx), dim)
    assert got.dtype == torch.int32
    deg = np.bincount(idx, minlength=dim)
    want = np.zeros(probes.HIST_BINS, np.int64)
    for d in deg:
        b = 0 if d == 0 else min(probes.HIST_BINS - 1, 1 + int(np.floor(np.log2(d))))
        want[b] += 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jprobes.degree_histogram(jnp.asarray(idx), dim)))
    assert int(got.sum()) == dim
    assert float(probes.dead_fraction(_t(idx), dim)) == pytest.approx(float(np.mean(deg == 0)))
    # degrees past the last bucket clip into it
    big = np.repeat(np.arange(3), [300, 2, 1])
    np.testing.assert_array_equal(probes.degree_histogram(_t(big), 5).numpy(),
                                  np.asarray(jprobes.degree_histogram(jnp.asarray(big), 5)))


def test_streamed_stats_shard_invariant():
    rng = np.random.default_rng(3)
    vals = rng.normal(size=1000).astype(np.float32)
    vals[::7] = 0.0
    cols = rng.integers(0, 13, size=1000)
    whole_v = probes.streamed_value_stats(vals, shard_rows=10**9)
    shard_v = probes.streamed_value_stats(vals, shard_rows=17)
    assert whole_v == jprobes.streamed_value_stats(vals, shard_rows=10**9)
    for k in whole_v:
        assert shard_v[k] == pytest.approx(whole_v[k], rel=1e-9), k
    whole_q = probes.streamed_importance_quantiles(vals, cols, 13, shard_rows=10**9)
    shard_q = probes.streamed_importance_quantiles(vals, cols, 13, shard_rows=17)
    assert whole_q == jprobes.streamed_importance_quantiles(vals, cols, 13, shard_rows=10**9)
    for k in whole_q:
        assert shard_q[k] == pytest.approx(whole_q[k], rel=1e-9), k


def test_padded_buffer_probe_masks_padding_rows():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(8, 4)).astype(np.float32)
    z[1, :] = 0.0
    z[6:, :] = 99.0  # padding garbage that must not leak into the stats
    n_valid = 6
    sat, l2, zero = probes.padded_buffer_probe(_t(z), torch.tensor(n_valid))
    live = z[:n_valid]
    assert float(sat) == pytest.approx(float(np.mean(live <= 0)))
    assert float(l2) == pytest.approx(
        float(np.sqrt(np.sum(np.square(live, dtype=np.float64)))), rel=1e-5)
    assert float(zero) == pytest.approx(float(np.mean(live == 0)))
    want = jprobes.padded_buffer_probe(jnp.asarray(z), jnp.asarray(n_valid))
    for g, w in zip((sat, l2, zero), want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)


def test_padded_buffer_probe_one_compile_across_valid_counts():
    z = torch.zeros((6, 3))
    probes.padded_buffer_probe(z, torch.tensor(2))
    size = probes.probe_compile_counts()["obs_padded_buffer_probe"]
    probes.padded_buffer_probe(z, torch.tensor(5))  # a tensor count: one shape serves
    assert probes.probe_compile_counts()["obs_padded_buffer_probe"] == size
    probes.padded_buffer_probe(torch.zeros((7, 3)), torch.tensor(5))
    assert probes.probe_compile_counts()["obs_padded_buffer_probe"] == size + 1


# ---------------------------------------------------------------------------
# segment probe: values + probe-off identity
# ---------------------------------------------------------------------------


def _tiny_segment_args(cfg, opt, seed=0, n=40, steps=4, batch=8):
    model = SparseMLP(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg.layer_dims[0])).astype(np.float32)
    y = rng.integers(0, cfg.layer_dims[-1], size=n)
    params = model.params()
    gen = torch.Generator()
    gen.manual_seed(seed)
    return model, (
        params, opt.init(params), model.topo_arrays(),
        torch.as_tensor(x), torch.as_tensor(y).long(),
        torch.arange(steps * batch).reshape(steps, batch),
        torch.full((steps,), 0.01), gen,
    )


def test_segment_probe_stats_match_numpy_oracles():
    # dropout 0: the packages draw their masks from different generators
    cfg = SparseMLPConfig(layer_dims=(12, 16, 5), epsilon=4, impl="element", dropout=0.0)
    opt = MomentumSGD()
    model, args = _tiny_segment_args(cfg, opt)
    out = make_segment_program(cfg, opt, probe=True)(*args)
    params2, stats = out[0], out[4]
    assert set(stats) >= {
        "grad_l2", "value_l2", "value_zero_frac", "saturation",
        "imp_q10", "imp_q50", "imp_q90", "dead_out_frac", "dead_in_frac",
        "in_deg_hist", "out_deg_hist",
    }
    for l in range(cfg.n_layers):
        v = params2["values"][l].numpy().astype(np.float64)
        assert float(stats["value_l2"][l]) == pytest.approx(float(np.sqrt(np.sum(v * v))),
                                                            rel=1e-4)
        assert float(stats["value_zero_frac"][l]) == pytest.approx(float(np.mean(v == 0)),
                                                                   abs=1e-6)
        assert 0.0 <= float(stats["saturation"][l]) <= 1.0
        assert np.isfinite(float(stats["grad_l2"][l]))
        assert int(stats["in_deg_hist"][l].sum()) == cfg.layer_dims[l + 1]
        assert int(stats["out_deg_hist"][l].sum()) == cfg.layer_dims[l]
    # the reference's program on the same model and inputs gives the same stats
    jcfg = jmlp.SparseMLPConfig(**dataclasses.asdict(cfg))
    jm = jmlp.SparseMLP(jcfg, seed=0)
    for l, t in enumerate(model.topos):
        jm.topos[l] = type(jm.topos[l])(t.in_dim, t.out_dim, t.rows, t.cols)
    jm.values = [jnp.asarray(v.numpy()) for v in model.values]
    jm.biases = [jnp.asarray(b.numpy()) for b in model.biases]
    jopt = jsgd.MomentumSGD()
    jargs = (jm.params(), jopt.init(jm.params()), jm.topo_arrays(), jnp.asarray(args[3].numpy()),
             jnp.asarray(args[4].numpy()), jnp.asarray(args[5].numpy(), jnp.int32),
             jnp.asarray(args[6].numpy()), jax.random.PRNGKey(0))
    jstats = jax.jit(jtrainer.make_segment_program(jcfg, jopt, probe=True))(*jargs)[4]
    _close_stats(stats, jstats)


def _close_stats(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]), \
            np.asarray(want[k])
        if k.endswith("_hist"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=STAT_RTOL, atol=STAT_ATOL, err_msg=k)


def test_probe_off_segment_is_byte_identical(monkeypatch):
    """``probe=False`` runs the steps and nothing else: its outputs are the
    bits of ``scan_segment`` over ``make_mlp_step_core`` called directly,
    and neither the probe's reductions nor the pre-activation forward is
    called. ``probe=True`` changes none of those outputs."""
    cfg = SparseMLPConfig(layer_dims=(12, 16, 5), epsilon=4, impl="element", dropout=0.2)
    opt = MomentumSGD()
    _, args = _tiny_segment_args(cfg, opt)
    calls = {"segment_probe": 0, "return_preacts": 0}
    real_probe, real_fwd = probes.segment_probe, tmlp.mlp_forward

    def probe_spy(*a, **k):
        calls["segment_probe"] += 1
        return real_probe(*a, **k)

    def fwd_spy(*a, return_preacts=False, **k):
        calls["return_preacts"] += bool(return_preacts)
        return real_fwd(*a, return_preacts=return_preacts, **k)

    monkeypatch.setattr(probes, "segment_probe", probe_spy)
    monkeypatch.setattr(ttrainer, "mlp_forward", fwd_spy)
    monkeypatch.setattr(tsteps, "mlp_forward", fwd_spy)

    def fresh(args):
        gen = torch.Generator()
        gen.set_state(args[7].get_state())
        return (*args[:7], gen)

    off = make_segment_program(cfg, opt, probe=False)(*fresh(args))
    assert calls == {"segment_probe": 0, "return_preacts": 0}
    core = tsteps.make_mlp_step_core(cfg, opt, args[2], args[3], args[4])
    direct = tsteps.scan_segment(core, args[0], args[1], fresh(args)[7], (args[5], args[6]))
    default = ttrainer.make_segment_fn(cfg, opt)(*fresh(args))
    for got in (off, default):
        assert len(got) == 4
        _bits(got[0], direct[0])
        _bits(got[1].velocity, direct[1].velocity)
        assert torch.equal(got[3], direct[3])
        assert torch.equal(got[2].get_state(), direct[2].get_state())
    on = make_segment_program(cfg, opt, probe=True)(*fresh(args))
    assert calls == {"segment_probe": 1, "return_preacts": 1}
    assert len(on) == 5
    _bits(on[0], off[0])
    _bits(on[1].velocity, off[1].velocity)
    assert torch.equal(on[3], off[3])


def _bits(a, b):
    for k in a:
        for x, y in zip(a[k], b[k]):
            assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# timeline store: round-trip, validation, CLI
# ---------------------------------------------------------------------------


def _fake_probe(n_layers=3, grad=1.0, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "grad_l2": torch.full((n_layers,), grad),
        "value_l2": torch.as_tensor(rng.uniform(1, 5, n_layers).astype(np.float32)),
        "value_zero_frac": torch.zeros((n_layers,)),
        "saturation": torch.full((n_layers,), 0.4),
        "imp_q50": torch.full((n_layers,), 2.0),
        "in_deg_hist": torch.ones((n_layers, probes.HIST_BINS), dtype=torch.int32),
    }


def test_timeline_roundtrip_and_validation(tmp_path):
    path = tmp_path / "tl.jsonl"
    with timeline.timeline_to(path, run_id="rt", attrs={"seed": 7}):
        s0 = probes.record_snapshot(
            0, "train", _fake_probe(), churn=[0.3, 0.2, 0.1], extra={"epoch": 0},
        )
        probes.record_snapshot(10, "train", _fake_probe(grad=0.9))
    assert s0["layers"][0]["churn_frac"] == pytest.approx(0.3)
    events = timeline.read_timeline(path)
    assert timeline.validate_timeline(events) == []
    assert events[0]["ev"] == "meta"
    assert events[0]["schema"] == timeline.TIMELINE_SCHEMA_VERSION
    assert events[0]["attrs"] == {"seed": 7}
    snaps = timeline.snapshots(events)
    assert [s["step"] for s in snaps] == [0, 10]
    assert snaps[0]["layers"][1]["churn_frac"] == pytest.approx(0.2)
    # hists survive as int lists
    assert snaps[0]["layers"][0]["in_deg_hist"] == [1] * probes.HIST_BINS
    assert timeline.alerts(events) == []
    # the reference reads the port's timeline the same way
    from repro.obs import timeline as jtimeline

    assert jtimeline.validate_timeline(events) == []
    assert jtimeline.render_report(events) == timeline.render_report(events)


def test_timeline_validation_catches_corruption(tmp_path):
    path = tmp_path / "tl.jsonl"
    with timeline.timeline_to(path, run_id="rt"):
        probes.record_snapshot(0, "train", _fake_probe())
    lines = path.read_text().splitlines()
    lines.append('{"ev":"snapshot","run_id":"OTHER","step":-3,"layers":1}')
    lines.append("not json at all")
    path.write_text("\n".join(lines) + "\n")
    errors = timeline.validate_timeline(timeline.read_timeline(path))
    text = "\n".join(errors)
    assert "run_id" in text and "step" in text and "unparseable" in text


def test_record_snapshot_disabled_writes_nothing(tmp_path):
    path = tmp_path / "tl.jsonl"
    with timeline.timeline_to(path, run_id="rt") as w:
        before = w.events_written
        with obs.disabled():
            assert probes.record_snapshot(0, "train", _fake_probe()) is None
        assert w.events_written == before


def _cli(*args):
    env = {"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"}
    return subprocess.run([sys.executable, "-m", "repro_torch.obs", *args],
                          capture_output=True, text=True, env=env)


def test_cli_report_and_diff(tmp_path):
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    with timeline.timeline_to(a, run_id="run-a"):
        probes.record_snapshot(0, "train", _fake_probe(), extra={"loss": 2.0})
        probes.record_snapshot(5, "train", _fake_probe(grad=0.8))
    with timeline.timeline_to(b, run_id="run-b"):
        probes.record_snapshot(5, "train", _fake_probe(grad=8.0))
    rep = _cli("report", str(a))
    assert rep.returncode == 0, rep.stderr
    assert "run-a" in rep.stdout and "grad_l2" in rep.stdout
    assert "alerts: none" in rep.stdout
    val = _cli("report", "--validate-only", str(a))
    assert val.returncode == 0 and "PASS" in val.stdout
    diff = _cli("diff", str(a), str(b))
    assert diff.returncode == 0, diff.stderr
    assert "run-a" in diff.stdout and "run-b" in diff.stdout
    assert "x10.00!" in diff.stdout  # grad 0.8 -> 8.0 flagged beyond 2x


# ---------------------------------------------------------------------------
# anomaly detectors: seeded pathologies, quiet period, stickiness
# ---------------------------------------------------------------------------


def _mon(**kw):
    kw.setdefault("rss_fn", lambda: None)  # keep RSS out of unit tests
    return detect.AnomalyMonitor(**kw)


def _healthy_layers(n=3):
    return [
        {"grad_l2": 1.0, "value_l2": 5.0, "imp_q50": 2.0, "churn_frac": 0.3}
        for _ in range(n)
    ]


def test_detector_quiet_period_suppresses_first_snapshot():
    m = _mon()
    layers = _healthy_layers()
    layers[0]["value_l2"] = 0.0  # would be dead_layer after the quiet period
    assert m.observe(0, "train", layers) == []
    assert m.active == {}


def test_detector_dead_layer_fires_on_the_right_layer():
    m = _mon()
    m.observe(0, "train", _healthy_layers())
    layers = _healthy_layers()
    layers[1]["value_l2"] = 0.0
    fired = m.observe(1, "train", layers)
    assert [(a.rule, a.layer) for a in fired] == [("dead_layer", 1)]


def test_detector_vanishing_and_exploding_absolute():
    m = _mon()
    m.observe(0, "train", _healthy_layers())
    layers = _healthy_layers()
    layers[0]["grad_l2"] = 1e-8   # < vanish_grad_l2, > dead_grad_l2
    layers[2]["grad_l2"] = 2e3    # > explode_grad_l2 absolute
    rules = {(a.rule, a.layer) for a in m.observe(1, "train", layers)}
    assert rules == {("vanishing_grads", 0), ("exploding_grads", 2)}


def test_detector_exploding_ratio_vs_running_median():
    m = _mon()
    for step in range(3):
        m.observe(step, "train", _healthy_layers())
    layers = _healthy_layers()
    layers[1]["grad_l2"] = 60.0  # < 1e3 absolute but > 50x median(1.0)
    fired = m.observe(3, "train", layers)
    assert [(a.rule, a.layer) for a in fired] == [("exploding_grads", 1)]
    assert "running median" in fired[0].message


def test_detector_churn_collapse_and_importance_drift():
    m = _mon()
    m.observe(0, "train", _healthy_layers())
    layers = _healthy_layers()
    layers[0]["churn_frac"] = 1e-4
    layers[2]["imp_q50"] = 2.0 * 9  # > 8x first-seen baseline
    rules = {(a.rule, a.layer) for a in m.observe(1, "train", layers)}
    assert rules == {("churn_collapse", 0), ("importance_drift", 2)}


def test_detector_rss_growth_needs_ratio_and_absolute():
    rss = [256 << 20]
    m = _mon(rss_fn=lambda: rss[0])
    m.observe(0, "train", _healthy_layers())     # baseline = 256 MiB
    rss[0] = 512 << 20  # 2x but under both thresholds together
    assert m.observe(1, "train", _healthy_layers()) == []
    rss[0] = 2048 << 20  # 8x and +1.75 GiB: both conditions hold
    fired = m.observe(2, "train", _healthy_layers())
    assert [a.rule for a in fired] == ["rss_growth"]
    assert fired[0].layer is None


def test_detector_alerts_sticky_until_cleared():
    m = _mon()
    m.observe(0, "train", _healthy_layers())
    bad = _healthy_layers()
    bad[0]["value_l2"] = 0.0
    m.observe(1, "train", bad)
    m.observe(2, "train", bad)  # same key: refires but doesn't duplicate
    assert len(m.active_alerts) == 1
    assert m.active_alerts[0]["step"] == 1  # first occurrence kept
    block = m.health_block()
    assert block["latest_probe_snapshot"]["step"] == 2
    assert len(block["active_alerts"]) == 1
    m.clear()
    assert m.active_alerts == []


def test_detector_healthy_stream_zero_false_positives():
    rng = np.random.default_rng(6)
    m = _mon()
    for step in range(30):  # healthy drift: grads decay, importance grows
        layers = []
        for _ in range(3):
            layers.append({
                "grad_l2": float(1.0 * 0.95 ** step * rng.uniform(0.7, 1.3)),
                "value_l2": float(5.0 * rng.uniform(0.9, 1.1)),
                "imp_q50": float(2.0 * (1 + 0.02 * step)),
                "churn_frac": float(0.3 * 0.9 ** step + 0.02),
            })
        m.observe(step, "train", layers)
    assert m.active_alerts == []


# ---------------------------------------------------------------------------
# end-to-end: probed trainer run -> timeline + monitor
# ---------------------------------------------------------------------------


def _e2e_config(data):
    return SparseMLPConfig(layer_dims=(data.n_features, 24, 24, data.n_classes), epsilon=6,
                           impl="element")


def _e2e_tc(**kw):
    return TrainerConfig(epochs=3, batch_size=32, lr=0.01, zeta=0.3, seed=0, eval_every=3,
                         fused_epochs=True, device_evolution=True, **kw)


def test_probed_training_run_healthy_and_renders(tmp_path):
    data = datasets.load("fashionmnist", scale=0.02, seed=0)
    tc = _e2e_tc(probe=True)
    path = tmp_path / "train.jsonl"
    monitor = detect.configure(_mon())
    try:
        with timeline.timeline_to(path, run_id="e2e"):
            SequentialTrainer(SparseMLP(_e2e_config(data), seed=0, device="cpu"), data,
                              tc).run()
    finally:
        detect.configure(None)
    events = timeline.read_timeline(path)
    assert timeline.validate_timeline(events) == []
    snaps = timeline.snapshots(events, "train")
    assert len(snaps) == tc.epochs
    # evolution runs on every epoch but the last -> churn recorded there
    assert "churn_frac" in snaps[0]["layers"][0]
    assert 0.0 < snaps[0]["layers"][0]["churn_frac"] <= 1.0
    assert "churn_frac" not in snaps[-1]["layers"][0]
    assert snaps[0]["extra"]["epoch"] == 0
    # acceptance: a healthy short run fires nothing
    assert timeline.alerts(events) == []
    assert monitor.active_alerts == []
    report = timeline.render_report(events)
    assert "[train]" in report and "alerts: none" in report


def test_probed_run_is_bit_equal_to_unprobed(tmp_path):
    """A probe reads the weights and never writes them: the probed run
    (traced, timeline, monitor) gives the unprobed run's history, topology
    and weights under ``obs.disabled()``, bit for bit."""
    data = datasets.load("fashionmnist", scale=0.02, seed=0)

    def run(probe):
        model = SparseMLP(_e2e_config(data), seed=0, device="cpu")
        trainer = SequentialTrainer(model, data, _e2e_tc(probe=probe))
        if probe:
            detect.configure(_mon())
            with obs.trace_to(str(tmp_path / "t.jsonl")), \
                    timeline.timeline_to(tmp_path / "tl.jsonl", run_id="p"):
                hist = trainer.run()
            detect.configure(None)
        else:
            with obs.disabled():
                hist = trainer.run()
        hist = {k: v for k, v in hist.items() if k != "epoch_seconds"}
        return hist, model

    (h1, m1), (h0, m0) = run(True), run(False)
    np.testing.assert_equal(h1, h0)  # NaN accuracies (no evaluation) compare equal
    for a, b in zip(m1.topos, m0.topos):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    for a, b in zip(m1.values + m1.biases, m0.values + m0.biases):
        assert torch.equal(a, b)
    assert len(timeline.snapshots(timeline.read_timeline(tmp_path / "tl.jsonl"))) == 3


def test_probed_trainer_matches_reference(monkeypatch, tmp_path):
    """Probed fused runs of both packages, the port fed the reference's
    device-SET draws: equal topologies, the loss history at rtol 1e-4 and
    each epoch's snapshot within 1e-4 (the histograms and churn equal)."""
    from test_torch_device_train import ELEMENT, _feed_draws, _models, _record_reference_draws

    from repro.data import datasets as jdata
    from repro.obs import timeline as jtimeline

    fields = dict(ELEMENT, layer_dims=(784, 48, 32, 10))
    jm, tm = _models(fields, seed=0)
    jd = jdata.load("fashionmnist", scale=0.02, seed=0)
    td = datasets.load("fashionmnist", scale=0.02, seed=0)
    kw = dict(epochs=3, batch_size=32, lr=0.01, zeta=0.3, seed=0, eval_every=3, probe=True)
    draws = []
    _record_reference_draws(monkeypatch, draws)
    with jtimeline.timeline_to(tmp_path / "j.jsonl", run_id="j"):
        jh = jtrainer.SequentialTrainer(jm, jd, jtrainer.TrainerConfig(**kw)).run()
    _feed_draws(monkeypatch, draws)
    with timeline.timeline_to(tmp_path / "t.jsonl", run_id="t"):
        th = SequentialTrainer(tm, td, TrainerConfig(**kw)).run()
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=1e-4)
    assert th["n_params"] == jh["n_params"]
    for a, b in zip(tm.topos, jm.topos):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    jsnaps = jtimeline.snapshots(jtimeline.read_timeline(tmp_path / "j.jsonl"))
    tsnaps = timeline.snapshots(timeline.read_timeline(tmp_path / "t.jsonl"))
    assert [s["step"] for s in tsnaps] == [s["step"] for s in jsnaps]
    for ts, js in zip(tsnaps, jsnaps):
        assert ts["extra"]["epoch"] == js["extra"]["epoch"]
        for tl, jl in zip(ts["layers"], js["layers"]):
            assert set(tl) == set(jl)
            for k in jl:
                if k.endswith("_hist") or k == "churn_frac":
                    assert tl[k] == jl[k], k
                else:
                    np.testing.assert_allclose(tl[k], jl[k], rtol=STAT_RTOL, atol=STAT_ATOL,
                                               err_msg=k)


def test_seeded_pathology_caught_through_record_path(tmp_path):
    path = tmp_path / "sick.jsonl"
    detect.configure(_mon())
    probes.set_snapshot_transform(probes.zero_layer_transform(layer=0))
    try:
        with timeline.timeline_to(path, run_id="sick"):
            probes.record_snapshot(0, "train", _fake_probe())
            probes.record_snapshot(1, "train", _fake_probe())
    finally:
        probes.set_snapshot_transform(None)
        detect.configure(None)
    events = timeline.read_timeline(path)
    assert timeline.validate_timeline(events) == []
    al = timeline.alerts(events)
    assert [(a["rule"], a["layer"]) for a in al] == [("dead_layer", 0)]
    # the transform corrupts what is *recorded* too, by design
    assert timeline.snapshots(events)[1]["layers"][0]["value_l2"] == 0.0


# ---------------------------------------------------------------------------
# the pre-activation forward, the non-element subset, profiling on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["element", "block", "masked", "dense"])
def test_return_preacts_matches_reference(impl):
    fields = dict(layer_dims=(24, 32, 16, 5), epsilon=4, impl=impl, block_m=8, block_n=8,
                  dropout=0.0)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=0)
    topos = None if impl == "dense" else [(t.rows, t.cols) for t in jm.topos]
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), topos or [None] * 3,
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    x = np.random.default_rng(1).standard_normal((7, 24)).astype(np.float32)
    want, wpre = jmlp.mlp_forward(jm.params(), jm.topo_arrays(), jnp.asarray(x), jm.config,
                                  return_preacts=True)
    for grad in (True, False):
        with torch.set_grad_enabled(grad):
            params = {k: tuple(t.detach().requires_grad_(grad) for t in v)
                      for k, v in tm.params().items()}
            got, pre = tmlp.mlp_forward(params, tm.topo_arrays(), torch.as_tensor(x),
                                        tm.config, return_preacts=True)
            plain = tmlp.mlp_forward(params, tm.topo_arrays(), torch.as_tensor(x), tm.config)
        assert len(pre) == len(wpre) == 3
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for z, w in zip(pre, wpre):
            assert tuple(z.shape) == w.shape
            np.testing.assert_allclose(z.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        # the pre-activation forward keeps the logits' bits
        assert torch.equal(got.detach(), plain.detach())
        assert torch.equal(pre[-1].detach(), got.detach())


def test_block_probe_carries_the_value_subset():
    """A block model's probe: the value/grad/saturation subset, as the
    reference's docstring states (its code fails on block topologies)."""
    cfg = SparseMLPConfig(layer_dims=(16, 32, 8), epsilon=4, impl="block", block_m=8,
                          block_n=8)
    opt = MomentumSGD()
    _, args = _tiny_segment_args(cfg, opt)
    stats = make_segment_program(cfg, opt, probe=True)(*args)[4]
    assert set(stats) == {"grad_l2", "grad_zero_frac", "value_l2", "value_zero_frac",
                          "saturation"}
    assert all(s.shape == (2,) and torch.isfinite(s).all() for s in stats.values())


def test_profiling_on_the_cpu(tmp_path):
    """No card: ``sample_device_memory`` reads nothing (as the reference on
    CPU jaxlib); ``profile_trace`` writes a Chrome trace of the block,
    bracketed by its two points; ``record_compile_counts`` sets gauges."""
    reg = obs.MetricsRegistry(control=True)
    assert obs.sample_device_memory(reg) == {}
    path = tmp_path / "t.jsonl"
    with obs.trace_to(str(path)):
        with obs.profile_trace(str(tmp_path / "prof"), name="p"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace_file = tmp_path / "prof" / "p.pt.trace.json"
    assert trace_file.exists() and "traceEvents" in json.loads(trace_file.read_text())
    names = [e["name"] for e in obs.read_events(str(path)) if e["ev"] == "point"]
    assert names == ["profile.start", "profile.stop"]
    obs.record_compile_counts({"a": 2}, registry=reg)
    assert reg.snapshot()['compile_cache_entries{program="a"}'] == 2.0
