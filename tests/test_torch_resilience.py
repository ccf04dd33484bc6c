"""The port's runtime (``repro_torch.runtime``: fault injection, the
supervisor, retries, heartbeat elasticity) on the CPU: the twins of
``tests/test_resilience.py``.

* **The port against itself.** A run killed at a step (an injected
  exception in process, a real ``SIGKILL`` of the supervisor CLI, or one
  from outside by ``wait_and_kill``), retried after a transient fault, or
  resumed past a torn newest checkpoint, ends with the history of the run
  that never failed, bit for bit: fused and per-batch, XL, and WASAP killed
  at a phase-1 and at a phase-2 epoch. A fault raised INSIDE a segment,
  after the hook, is retried bit-equal too: the segment is not donated and
  the trainer puts its generator back.
* **Against the reference.** ``FaultPlan.from_seed`` gives the reference's
  plan, field by field; the corruptions damage a checkpoint as the
  reference's do. An uninterrupted supervised run (host SET, dropout 0)
  and WASAP's elastic round (a worker silenced, evicted, the average
  renormalised over the survivor; device SET fed the reference's draws)
  follow the reference's on the same numpy data: the histories and values
  at rtol = atol = 1e-5, the ``elastic_log``'s statuses and weights exactly.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import topology as jtopo  # noqa: E402
from repro.core import wasap as jw  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.runtime import faultinject as jfi  # noqa: E402
from repro.runtime import supervisor as jsup  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import wasap as tw  # noqa: E402
from repro_torch.data.synthetic import Dataset, make_classification  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig  # noqa: E402
from repro_torch.runtime import faultinject as fi  # noqa: E402
from repro_torch.runtime.supervisor import (  # noqa: E402
    HeartbeatMonitor,
    StragglerPolicy,
    SupervisorConfig,
    run_supervised,
)
from repro_torch.train.trainer import SequentialTrainer, TrainerConfig, XLTrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SRC = str(Path(__file__).resolve().parents[1] / "src")
TRAJ = ("epoch", "train_loss", "test_acc", "n_params")  # epoch_seconds is wall clock
TOL = dict(rtol=1e-5, atol=1e-5)
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Boom(Exception):
    """An injected unrecoverable failure (SIGKILL's stand-in in process)."""


def boom_at(k):
    def hook(gstep):
        if gstep >= k:
            raise Boom(f"injected failure at gstep {gstep}")

    return hook


def same_trajectory(h_a, h_b, keys=TRAJ):
    for key in keys:
        np.testing.assert_array_equal(np.asarray(h_a[key], float), np.asarray(h_b[key], float),
                                      err_msg=key)


def small_arrays(n_features=20, n_classes=4, n=200, seed=0):
    rng = np.random.default_rng(seed)
    x, y = make_classification(n, n_features, n_informative=8, n_redundant=4,
                               n_classes=n_classes, rng=rng)
    return (x[:160].astype(np.float32), y[:160], x[160:].astype(np.float32), y[160:],
            n_classes)


@pytest.fixture(scope="module")
def data():
    return Dataset("resilience", *small_arrays())


def seq_trainer(data, fused, epochs=3, seed=3, dropout=0.2, device_evolution=True):
    cfg = SparseMLPConfig(layer_dims=(data.x_train.shape[1], 32, 32, data.n_classes),
                          epsilon=8, dropout=dropout)
    tc = TrainerConfig(epochs=epochs, batch_size=16, evolve=True, seed=seed,
                       fused_epochs=fused, device_evolution=device_evolution)
    return SequentialTrainer(SparseMLP(cfg, seed=seed, device="cpu"), data, tc)


def sup(d, retries=0):
    return SupervisorConfig(checkpoint_dir=str(d), save_every_epochs=1, step_retries=retries)


# ---------------------------------------------------------------------------
# fault plans and corruptions: the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,total,ckpts,modes", [
    (11, 40, [10, 20], ["flip_bytes", "delete_manifest"]),
    (0, 7, [], []),
    (12345, 1000, [100, 200, 300, 900], ["truncate_leaf", "orphan_tmp", "flip_bytes"]),
])
def test_fault_plan_from_seed_is_the_reference_plan(seed, total, ckpts, modes):
    kw = dict(total_steps=total, ckpt_steps=ckpts, corruption_modes=modes)
    plan, want = fi.FaultPlan.from_seed(seed, **kw), jfi.FaultPlan.from_seed(seed, **kw)
    for f in ("seed", "kill_at_step", "transient_steps", "transient_persistent", "corruptions",
              "straggler_suppress", "straggler_delay_s"):
        assert getattr(plan, f) == getattr(want, f), f
    assert plan == fi.FaultPlan.from_seed(seed, **kw)
    assert fi.FaultPlan.from_json(plan.to_json()) == plan
    assert json.loads(plan.to_json()) == json.loads(want.to_json())
    assert 1 <= plan.kill_at_step < max(2, total)
    assert all(m in fi.CORRUPTION_MODES for m, _ in plan.corruptions)
    with pytest.raises(ValueError, match="unknown corruption"):
        fi.FaultPlan.from_seed(seed, total_steps=total, corruption_modes=["melt"])


@pytest.mark.parametrize("mode", ["truncate_leaf", "flip_bytes", "delete_manifest"])
def test_corruptions_hit_what_the_reference_hits_and_are_quarantined(tmp_path, mode):
    """The port's corruption of a port checkpoint damages the same file the
    reference's does on a copy; the manager detects it, quarantines the step
    and falls back to the one before."""
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    for d in ("port", "ref"):
        mgr = CheckpointManager(str(tmp_path / d), keep_last=5, async_write=False)
        mgr.save(1, tree)
        mgr.save(2, tree)
    hit = fi.corrupt(mode, tmp_path / "port", 2)
    assert hit == jfi.corrupt(mode, tmp_path / "ref", 2)
    for f in sorted((tmp_path / "port" / "step_000000002" / "arrays").rglob("*")):
        twin = tmp_path / "ref" / f.relative_to(tmp_path / "port")  # the same leaf damaged
        assert f.is_file() == twin.is_file() and (not f.is_file()
                                                   or f.read_bytes() == twin.read_bytes())
    mgr = CheckpointManager(str(tmp_path / "port"))
    assert mgr.verify_step(2) is not None and mgr.latest_valid_step() == 1
    assert (tmp_path / "port" / "quarantine" / "step_000000002").is_dir()


# ---------------------------------------------------------------------------
# in-core kill/resume, retries: bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_batch"])
def test_sequential_kill_resume_bit_exact(tmp_path, data, fused):
    ref = run_supervised(seq_trainer(data, fused), sup(tmp_path / "ref"))
    steps = 160 // 16
    tr = seq_trainer(data, fused)
    # the fused hook fires once a segment, at its first gstep
    tr.fault_hook = boom_at(steps if fused else steps + 3)
    with pytest.raises(Boom):
        run_supervised(tr, sup(tmp_path / "run"))
    assert CheckpointManager(str(tmp_path / "run")).latest_valid_step() == steps
    # a FRESH trainer: the process that died knows nothing
    res = run_supervised(seq_trainer(data, fused), sup(tmp_path / "run"))
    assert res["resumed_from_step"] == steps
    same_trajectory(res["history"], ref["history"])


@pytest.mark.parametrize("where", ["hook", "inside"])
def test_sequential_transient_fault_recovers_bit_exact(tmp_path, data, where):
    """A transient at the epoch-1 segment, raised by the hook (before the
    segment) or INSIDE the segment after it ran (its generator advanced):
    the retry re-enters with the first attempt's inputs and the run is
    bit-equal to the one that never failed, weights included."""
    ref_tr = seq_trainer(data, True)
    ref = run_supervised(ref_tr, sup(tmp_path / "ref"))
    tr = seq_trainer(data, True)
    injector = fi.TransientFaultInjector([10])  # the epoch-1 segment
    if where == "hook":
        tr.fault_hook = injector
    else:
        segment, calls = tr._segment, []

        def failing(*args):
            out = segment(*args)  # the whole segment runs, drawing dropout
            calls.append(int(out[1].step))
            if len(calls) == 2:
                raise fi.TransientFault("injected inside the segment, after it ran")
            return out

        tr._segment = failing
    res = run_supervised(tr, sup(tmp_path / "run", retries=2))
    if where == "hook":
        assert injector.raised == 1
    else:
        assert calls == [10, 20, 20, 30]  # epoch 1's segment ran twice
    assert res["resumed_from_step"] is None
    same_trajectory(res["history"], ref["history"])
    for a, b in zip(tr.model.values + tr.model.biases, ref_tr.model.values + ref_tr.model.biases):
        assert torch.equal(a, b)


def test_resume_skips_corrupt_newest_checkpoint(tmp_path, data):
    ref = run_supervised(seq_trainer(data, True), sup(tmp_path / "ref"))
    steps = 160 // 16
    tr = seq_trainer(data, True)
    tr.fault_hook = boom_at(2 * steps)  # dies at the epoch-2 segment
    with pytest.raises(Boom):
        run_supervised(tr, sup(tmp_path / "run"))
    fi.flip_bytes(tmp_path / "run", 2 * steps)  # the newest boundary is torn
    res = run_supervised(seq_trainer(data, True), sup(tmp_path / "run"))
    assert res["resumed_from_step"] == steps  # fell back one boundary
    assert (tmp_path / "run" / "quarantine").is_dir()
    same_trajectory(res["history"], ref["history"])


def test_supervised_run_matches_the_reference(tmp_path):
    """An uninterrupted supervised run of each package on the same numpy
    data and seeded model, host SET (both draw from their numpy rngs) at
    dropout 0: the histories at rtol = atol = 1e-5, n_params and the
    topologies equal, the values at 1e-5."""
    xtr, ytr, xte, yte, n_classes = small_arrays()
    jdata = jsyn.Dataset("resilience", xtr, ytr, xte, yte, n_classes)
    tdata = Dataset("resilience", xtr, ytr, xte, yte, n_classes)
    jcfg = jmlp.SparseMLPConfig(layer_dims=(20, 32, 32, 4), epsilon=8, dropout=0.0)
    jm = jmlp.SparseMLP(jcfg, seed=3)
    tm = mlp_from_numpy(dataclasses.asdict(jcfg), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    kw = dict(epochs=3, batch_size=16, evolve=True, seed=3, device_evolution=False)
    jt = jtrainer.SequentialTrainer(jm, jdata, jtrainer.TrainerConfig(**kw))
    tt = SequentialTrainer(tm, tdata, TrainerConfig(**kw))
    want = jsup.run_supervised(jt, jsup.SupervisorConfig(checkpoint_dir=str(tmp_path / "j")))
    got = run_supervised(tt, sup(tmp_path / "t"))
    hj, ht = want["history"], got["history"]
    assert ht["epoch"] == hj["epoch"] and ht["n_params"] == hj["n_params"]
    for key in ("train_loss", "test_acc"):
        np.testing.assert_allclose(ht[key], hj[key], **TOL, err_msg=key)
    for a, b in zip(tm.topos, jm.topos):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    for a, b in zip(tm.values + tm.biases, list(jm.values) + list(jm.biases)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # both wrote a checkpoint at every epoch boundary
    assert CheckpointManager(str(tmp_path / "t")).all_steps() == [10, 20, 30]


# ---------------------------------------------------------------------------
# a real SIGKILL through the supervisor CLI, and the driver-side kill
# ---------------------------------------------------------------------------


def _supervisor_cmd(ckpt, out, **flags):
    cmd = [sys.executable, "-m", "repro_torch.runtime.supervisor", "--device", "cpu",
           "--ckpt", str(ckpt), "--out", str(out), "--epochs", "2", "--batch-size", "32",
           "--n-train", "256", "--n-test", "64", "--per-batch"]
    for k, v in flags.items():
        cmd += [f"--{k.replace('_', '-')}", str(v)]
    return cmd


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run(cmd):
    return subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)


def test_subprocess_sigkill_resume_matches_uninterrupted(tmp_path):
    """SIGKILL a real training subprocess mid-epoch (no atexit, no
    cleanup), rerun it on the same checkpoint directory: the history equals
    the never-killed run's."""
    ref = _run(_supervisor_cmd(tmp_path / "ref_ck", tmp_path / "ref.json"))
    assert ref.returncode == 0, ref.stderr
    ref_hist = json.loads((tmp_path / "ref.json").read_text())["history"]
    # 256/32 = 8 steps an epoch; step 11 is mid-epoch-1
    killed = _run(_supervisor_cmd(tmp_path / "ck", tmp_path / "out.json", kill_at_step=11))
    assert killed.returncode in (-signal.SIGKILL, 137), (killed.returncode, killed.stderr)
    assert not (tmp_path / "out.json").exists()  # it died before finishing
    resumed = _run(_supervisor_cmd(tmp_path / "ck", tmp_path / "out.json"))
    assert resumed.returncode == 0, resumed.stderr
    payload = json.loads((tmp_path / "out.json").read_text())
    assert payload["resumed_from_step"] == 8  # the epoch-0 boundary
    for key in TRAJ:
        assert payload["history"][key] == ref_hist[key], key


def test_cli_without_a_card_raises_unless_asked_for_the_cpu(tmp_path):
    cmd = [a for a in _supervisor_cmd(tmp_path / "ck", tmp_path / "o.json") if a not in (
        "--device", "cpu")]
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = _run(cmd)
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_wait_and_kill_external_driver(tmp_path):
    progress = tmp_path / "progress"
    child = textwrap.dedent(
        """
        import os, sys, time
        path = sys.argv[1]
        for step in range(10_000):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} 0\\n")
            os.replace(tmp, path)
            time.sleep(0.01)
        """
    )
    proc = subprocess.Popen([sys.executable, "-c", child, str(progress)])
    try:
        seen = fi.wait_and_kill(proc, str(progress), at_step=5, timeout_s=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=CHILD_TIMEOUT_S)
    assert seen >= 5
    assert proc.returncode == -signal.SIGKILL


# ---------------------------------------------------------------------------
# the streamed XL path
# ---------------------------------------------------------------------------


def test_xl_kill_resume_and_retry_trajectory(tmp_path):
    """Killed mid-epoch-1, resumed from epoch 0's streamed checkpoint; and a
    transient at a streamed step, retried: both bit-equal to the run that
    never stopped (the hook fires before the step writes the host state)."""
    from repro_torch.xl import plan_memory_budget

    dims = (40, 64, 48, 5)
    rng = np.random.default_rng(1)
    x, y = make_classification(200, dims[0], n_informative=8, n_redundant=8,
                               n_classes=dims[-1], rng=rng)
    data = Dataset("xl", x[:160].astype(np.float32), y[:160], x[160:].astype(np.float32),
                   y[160:], dims[-1])

    def make_trainer():
        cfg = SparseMLPConfig(layer_dims=dims, epsilon=8, activation="all_relu", alpha=0.6,
                              dropout=0.0, impl="element", element_impl="custom",
                              spmm_chunk=128)
        model = SparseMLP(cfg, seed=0, device="cpu")
        plan = plan_memory_budget(dims, [t.nnz for t in model.topos], 16, budget_bytes=60_000,
                                  chunk=128, min_chunk=32)
        tc = TrainerConfig(epochs=3, batch_size=16, lr=0.01, zeta=0.3, seed=0, evolve=True)
        return XLTrainer(model, data, tc, plan, device="cpu")

    ref = run_supervised(make_trainer(), sup(tmp_path / "ref"))
    tr = make_trainer()
    tr.fault_hook = boom_at(14)  # 160/16 = 10 steps an epoch: mid-epoch-1
    with pytest.raises(Boom):
        run_supervised(tr, sup(tmp_path / "run"))
    res = run_supervised(make_trainer(), sup(tmp_path / "run"))
    assert res["resumed_from_step"] == 10
    same_trajectory(res["history"], ref["history"])
    tr = make_trainer()
    injector = fi.TransientFaultInjector([13])
    tr.fault_hook = injector
    res = run_supervised(tr, sup(tmp_path / "retry", retries=1))
    assert injector.raised == 1
    same_trajectory(res["history"], ref["history"])


# ---------------------------------------------------------------------------
# WASAP: phase-aware resume and the elastic round
# ---------------------------------------------------------------------------


def _wasap_arrays(seed=4):
    dims = (24, 32, 32, 4)
    rng = np.random.default_rng(seed)
    x, y = make_classification(320, dims[0], n_informative=8, n_redundant=4,
                               n_classes=dims[-1], rng=rng)
    return dims, (x[:256].astype(np.float32), y[:256], x[256:].astype(np.float32), y[256:],
                  dims[-1])


def _wasap_config(module, seed=4):
    return module.WASAPConfig(n_workers=2, phase1_epochs=2, phase2_epochs=2, sync_every=2,
                              lr=0.02, zeta=0.3, seed=seed, batch_size=16)


def _wasap_trainer(seed=4):
    dims, arrays = _wasap_arrays(seed)
    cfg = SparseMLPConfig(layer_dims=dims, epsilon=8, activation="all_relu", alpha=0.6,
                          dropout=0.0, impl="element")
    return tw.WASAPTrainer(SparseMLP(cfg, seed=seed, device="cpu"), Dataset("wasap", *arrays),
                           _wasap_config(tw, seed))


@pytest.mark.parametrize("kill_call", [1, 3], ids=["phase1_epoch1", "phase2_epoch3"])
def test_wasap_kill_resume_bit_exact(tmp_path, kill_call):
    ref_tr = _wasap_trainer()
    ref_hist = ref_tr.run()
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    tr = _wasap_trainer()
    tr.epoch_end_hook = lambda t, epoch: t.save_checkpoint(mgr)
    calls = [0]

    def die_at_nth_epoch(gstep):
        if calls[0] == kill_call:
            raise Boom(f"epoch call {calls[0]}")
        calls[0] += 1

    tr.fault_hook = die_at_nth_epoch
    with pytest.raises(Boom):
        tr.run()
    assert mgr.latest_valid_step() == kill_call  # the boundary before the kill
    tr2 = _wasap_trainer()
    assert tr2.restore_checkpoint(mgr) == kill_call
    hist = tr2.run()
    assert hist["phase"] == ref_hist["phase"]
    for key in TRAJ:  # array_equal: the final row's train_loss is NaN by design
        np.testing.assert_array_equal(np.asarray(hist[key], float),
                                      np.asarray(ref_hist[key], float), err_msg=key)
    for a, b in zip(ref_tr.model.values + ref_tr.model.biases,
                    tr2.model.values + tr2.model.biases):
        assert torch.equal(a, b)


@pytest.mark.parametrize("phase", [1, 2])
def test_wasap_transient_retried_bit_exact(phase):
    """A transient at a phase-1 epoch call (retried with the generator put
    back) or at a phase-2 epoch (all K workers' segments and evolutions
    re-run from their entries): the run is bit-equal to the clean one."""
    ref_tr = _wasap_trainer()
    ref_hist = ref_tr.run()
    tr = _wasap_trainer()
    injector = fi.TransientFaultInjector([8 if phase == 1 else 3 * 8])
    tr.fault_hook, tr.step_retries = injector, 1
    hist = tr.run()
    assert injector.raised == 1
    for key in TRAJ:
        np.testing.assert_array_equal(np.asarray(hist[key], float),
                                      np.asarray(ref_hist[key], float), err_msg=key)
    for a, b in zip(ref_tr.model.values + ref_tr.model.biases, tr.model.values + tr.model.biases):
        assert torch.equal(a, b)


def _elastic(trainer, monitor_cls, policy_cls):
    """Attach the reference test's monitor: w1's beats never arrive, w0's
    move the clock 150 s an epoch (hard deadline 100 s, evicted at the
    second miss)."""
    clock = [0.0]
    trainer.monitor = monitor_cls(
        ["w0", "w1"], policy_cls(soft_deadline_s=50, hard_deadline_s=100, evict_after=2),
        clock=lambda: clock[0])

    def beat_filter(wid, epoch):
        if wid == "w0":
            clock[0] = (epoch + 1) * 150.0
        return wid != "w1"

    trainer.beat_filter = beat_filter
    return trainer


def test_wasap_elastic_round_matches_the_reference(monkeypatch):
    """Heartbeat elasticity: w1's beats stop, it is classified dead, charged
    misses and evicted; the phase-1 rounds renormalise over w0 and the run
    completes. The port (its device SET fed the reference's draws) against
    the reference on the same data and seeded model: ``elastic_log``
    (statuses, weights) exactly, history and final values at 1e-5."""
    dims, arrays = _wasap_arrays()
    jcfg = jmlp.SparseMLPConfig(layer_dims=dims, epsilon=8, activation="all_relu", alpha=0.6,
                                dropout=0.0, impl="element")
    jm = jmlp.SparseMLP(jcfg, seed=4)
    tm = mlp_from_numpy(dataclasses.asdict(jcfg), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    draws = []
    real_j = jw.evolve_element_layers_device

    def spy(topo_arrays, values, velocity, key, *, layer_dims, zeta,
            init_scheme="he_uniform", probe=False):
        keys = jax.random.split(key, len(topo_arrays))
        for l, t in enumerate(topo_arrays):
            n, total = int(t.rows.shape[0]), layer_dims[l] * layer_dims[l + 1]
            k_grow, k_init = jax.random.split(keys[l])
            cand = jax.random.randint(k_grow, (2 * n,), 0, total, dtype=jnp.int32)
            init = jtopo._init_device(k_init, (n,), fan_in_dense=layer_dims[l],
                                      scheme=init_scheme)
            draws.append((n, total, np.asarray(cand), np.asarray(init)))
        return real_j(topo_arrays, values, velocity, key, layer_dims=layer_dims, zeta=zeta,
                      init_scheme=init_scheme, probe=probe)

    monkeypatch.setattr(jw, "evolve_element_layers_device", spy)
    jt = _elastic(jw.WASAPTrainer(jm, jsyn.Dataset("wasap", *arrays), _wasap_config(jw)),
                  jsup.HeartbeatMonitor, jsup.StragglerPolicy)
    hj = jt.run()
    taken = iter(draws)

    def fake(generator, n, total, *, fan_in_dense, scheme):
        want_n, want_total, cand, init = next(taken)
        assert (n, total) == (want_n, want_total)
        return torch.tensor(cand), torch.tensor(init)

    monkeypatch.setattr(ttopo, "evolution_draws", fake)
    tt = _elastic(tw.WASAPTrainer(tm, Dataset("wasap", *arrays), _wasap_config(tw)),
                  HeartbeatMonitor, StragglerPolicy)
    ht = tt.run()
    assert next(taken, None) is None  # the port took every draw the reference made
    assert "w1" in tt.monitor.evicted
    assert len(tt.elastic_log) == tt.wc.phase1_epochs
    assert tt.elastic_log == jt.elastic_log
    # w1 contributed nothing once dead: the weights renormalise over w0
    assert tt.elastic_log[-1]["weights"] == [1.0, 0.0]
    assert tt.elastic_log[-1]["status"]["w1"] in ("dead", "evicted")
    assert ht["phase"] == hj["phase"] and ht["n_params"] == hj["n_params"]
    np.testing.assert_allclose(ht["train_loss"], hj["train_loss"], **TOL)
    np.testing.assert_allclose(ht["test_acc"], hj["test_acc"], **TOL)
    for a, b in zip(tm.topos, jm.topos):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    for a, b in zip(tm.values + tm.biases, list(jm.values) + list(jm.biases)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert np.isfinite(ht["test_acc"][-1]) and ht["test_acc"][-1] > 0.2
