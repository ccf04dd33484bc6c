"""The port's elastic training driver (``repro_torch.launch.train``) on the
CPU, on the SMOKE Qwen1.5 config.

* **The contract of** ``tests/test_launch.py``'s two ``run_training`` tests:
  suppressed heartbeats take a host from straggling to dead to evicted,
  the eviction re-plans the mesh once and restores the newest valid
  checkpoint, a transient step fault is retried, and ``resume`` falls back
  past a bit-flipped newest checkpoint. The reference's own ``run_training``
  cannot be the oracle here: under its explicit mesh the embedding gather
  raises ``jax._src.core.ShardingTypeError`` inside the JAX package.
* **The numbers.** A fault-free run's per-step losses against the
  reference's ``make_train_step``, jitted without a mesh, from the same
  weights on the same ``synthetic_batch`` draws, at rtol = atol = 1e-5.
* **The meshes.** ``run_training`` on (2, 1), (1, 2) and (2, 2) ``gloo``
  meshes of spawned ranks (``tests/torch_dist_workers.py``) gives the
  1 x 1 run's losses on the same global batch at 1e-5, each parameter
  stored as its rank's shard of the reference's layout.
* **The refusal.** The encoder-decoder.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.interop import lm_from_numpy  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.runtime.faultinject import TransientFaultInjector, flip_bytes  # noqa: E402
from repro_torch.runtime.supervisor import StragglerPolicy  # noqa: E402

import torch_dist_workers as workers  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _driver_config(tmp_path, **kw):
    base = dict(steps=8, seq=16, per_replica_batch=2, mesh_data=1, mesh_model=1,
                save_every=2, ckpt_dir=str(tmp_path), verbose=False, device="cpu")
    base.update(kw)
    return ttrain.DriverConfig(**base)


def test_driver_config_is_the_reference_s_plus_the_device():
    ours = {f.name: f.default for f in dataclasses.fields(ttrain.DriverConfig)}
    want = {f.name: f.default for f in dataclasses.fields(jtrain.DriverConfig)}
    assert set(ours) - set(want) == {"device"}
    assert set(want) <= set(ours)
    # the reference's 2 x 1 default mesh (one card passes mesh_data=1)
    assert ours["mesh_data"] == 2 and want["mesh_data"] == 2
    assert {k: v for k, v in ours.items() if k not in ("device", "policy", "clock")} == {
        k: v for k, v in want.items() if k not in ("policy", "clock")}


def test_synthetic_batch_draws_the_reference_s_numbers():
    for prefix in (0, 3):
        got = ttrain.synthetic_batch(np.random.default_rng(1234), 2, 16, 512, prefix=prefix,
                                     d_model=8, device="cpu")
        want = jtrain.synthetic_batch(np.random.default_rng(1234), 2, 16, 512, prefix=prefix,
                                      d_model=8)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_run_training_elastic_eviction_replans_and_restores(tmp_path):
    """Suppressed heartbeats -> straggling -> dead (miss charged) -> evicted
    -> plan_elastic_mesh replan + restore from the latest valid checkpoint,
    while a transient step fault is absorbed by retry_step; n_hosts
    decouples the monitor from the one device."""
    clock = [0.0]
    injector = TransientFaultInjector([4])

    def fault_hook(step):
        clock[0] = step * 10.0  # one 10 s heartbeat interval per step
        injector(step)

    dc = _driver_config(
        tmp_path, n_hosts=2,
        policy=StragglerPolicy(soft_deadline_s=5.0, hard_deadline_s=15.0, evict_after=2),
        clock=lambda: clock[0],
        # host1 stops beating from step 2 on: straggling at step 2, dead
        # (miss 1) at 3, dead (miss 2) at 5
        beat_filter=lambda host, step: not (host == "host1" and step >= 2),
        fault_hook=fault_hook,
    )
    hist = ttrain.run_training(dc)

    assert len(hist["loss"]) == dc.steps
    assert all(np.isfinite(l) for l in hist["loss"])
    assert injector.raised == 1
    assert [r["step"] for r in hist["recoveries"]] == [4]
    assert hist["status"][2]["host1"] == "straggling"
    assert hist["status"][3]["host1"] == "dead"
    assert hist["status"][5]["host1"] == "evicted"
    assert hist["healthy"][5] == 1
    assert len(hist["replans"]) == 1  # one replan, not one per later step
    replan = hist["replans"][0]
    assert "host1" in replan["reason"] and "elastic" in replan["plan"]
    assert replan["restored_step"] == 4  # the newest checkpoint before the eviction
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6, 8]


def test_run_training_resume_skips_corrupt_checkpoint(tmp_path):
    ttrain.run_training(_driver_config(tmp_path, steps=4))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    flip_bytes(str(tmp_path), 4)
    hist = ttrain.run_training(_driver_config(tmp_path, steps=6, resume=True))
    assert hist["resumed_from"] == 2  # step 4 quarantined
    assert len(hist["loss"]) == 6 - 2
    assert CheckpointManager(str(tmp_path)).latest_valid_step() == 6


def test_simulated_failure_replans_and_restores(tmp_path):
    hist = ttrain.run_training(_driver_config(tmp_path, steps=6, simulate_failure_at=5))
    assert [r["restored_step"] for r in hist["replans"]] == [4]
    assert hist["replans"][0]["reason"] == "simulated device loss"
    assert len(hist["loss"]) == 6 and all(np.isfinite(hist["loss"]))


def test_losses_match_the_reference_train_step(tmp_path, monkeypatch):
    """8 fault-free steps of the port's driver against the reference's
    ``make_train_step`` jitted without a mesh, from the reference model's
    weights (carried into the port's driver), on ``synthetic_batch``'s
    draws from ``default_rng(1234)``: every loss at 1e-5."""
    cfg = jconfigs.get_spec("qwen1.5-0.5b").smoke
    jm = jtransformer.PatternLM(cfg, seed=0)
    params_np = jax.tree.map(np.asarray, jm.params)
    monkeypatch.setattr(ttrain, "PatternLM", lambda c, seed, device: lm_from_numpy(
        dataclasses.asdict(c), params_np, {}, seed=seed, device=device))
    dc = _driver_config(tmp_path, save_every=100)
    got = ttrain.run_training(dc)["loss"]

    step, opt = jsteps.make_train_step(jm, lr=dc.lr)
    step = jax.jit(step)
    params, opt_state, topo = jm.params, opt.init(jm.params), jm.topo_arrays()
    rng = np.random.default_rng(1234)
    want = []
    for _ in range(dc.steps):
        batch = jtrain.synthetic_batch(rng, dc.per_replica_batch, dc.seq, cfg.vocab)
        params, opt_state, metrics = step(params, opt_state, batch, topo)
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    assert want[-1] < want[0]


@pytest.fixture(scope="module")
def one_by_one(tmp_path_factory):
    """The 1 x 1 run on one gloo rank, global batch 4."""
    return workers.spawn(workers.drive, 1, (1, 1), 4, str(tmp_path_factory.mktemp("m11")))


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_run_training_on_a_gloo_mesh(tmp_path, mesh, one_by_one):
    """The same global batch of 4 (per replica 4 / data) on a mesh of data x
    model gloo ranks: the 1 x 1 run's losses at 1e-5, and every parameter a
    DTensor holding its rank's shard of the reference's shape-aware layout
    (the embedding table's vocab on ``model``, its embed on ``data``)."""
    res = workers.spawn(workers.drive, mesh[0] * mesh[1], mesh, 4 // mesh[0], str(tmp_path))
    np.testing.assert_allclose(res["loss"], one_by_one["loss"], **TOL)
    local, full, placements = res["leaves"]["embed__table"]
    assert full == one_by_one["leaves"]["embed__table"][1] == [512, 64]
    assert local == [512 // mesh[1], 64 // mesh[0]]
    for name, (local, full, _) in res["leaves"].items():
        assert int(np.prod(local)) * mesh[0] * mesh[1] >= int(np.prod(full)), name


def test_the_encoder_decoder_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="whisper"):
        ttrain.run_training(_driver_config(tmp_path, arch="whisper-medium"))


def test_cli_runs_on_the_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
         "--seq", "8", "--save-every", "2", "--ckpt-dir", str(tmp_path), "--mesh-data", "1"],
        env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "[train] done: 3 steps" in res.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
