"""The port's training machinery against the JAX reference on the CPU:
momentum SGD and the LR schedules, the loader's epoch order, one block
train step, and whole ``SequentialTrainer`` runs with host evolution and
importance pruning.

Tolerances: an optimizer update and one step's params and velocity at
rtol = atol = 1e-5 (f32); a 3-epoch run holds the topology and the
``n_params`` history exactly equal after every epoch (they are integer
decisions on the same seeded draws), the loss history at rtol = 1e-4, and
test accuracy within one test sample (both forwards must classify the same
samples; one sample whose top two logits tie within float noise may flip).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core.importance import PruningSchedule as JSchedule  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data.loader import ShardedLoader as JLoader  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.interop import mlp_from_numpy, sgd_state_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.core.topology import evolve_element_layers_device  # noqa: E402
from repro_torch.xl import plan_memory_budget  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELDS = dict(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, block_m=8, block_n=8,
              impl="block", dropout=0.0)


def _tree(rng, shapes):
    return {k: tuple(rng.standard_normal(s).astype(np.float32) for s in ss)
            for k, ss in shapes.items()}


def test_momentum_sgd_matches_reference():
    rng = np.random.default_rng(0)
    shapes = {"values": [(3, 4, 4), (5,)], "biases": [(4,), (2,)]}
    params = _tree(rng, shapes)
    jopt = jsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    topt = tsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    jp = {k: tuple(jnp.asarray(a) for a in v) for k, v in params.items()}
    tp = {k: tuple(torch.as_tensor(a) for a in v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _tree(rng, shapes)
        lr = 0.01 * (step + 1)
        jp, js = jopt.update({k: tuple(jnp.asarray(a) for a in v) for k, v in grads.items()},
                             js, jp, lr)
        tp, ts = topt.update({k: tuple(torch.as_tensor(a) for a in v) for k, v in grads.items()},
                             ts, tp, torch.tensor(lr, dtype=torch.float32))
        for k in shapes:
            for a, b in zip(tp[k], jp[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            for a, b in zip(ts.velocity[k], js.velocity[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        assert int(ts.step) == int(js.step) == step + 1
    new = tsgd.replace_values_velocity(ts, [torch.zeros(1)])
    assert new.velocity["values"][0].shape == (1,) and new.step is ts.step
    assert new.velocity["biases"] is ts.velocity["biases"]


@pytest.mark.parametrize("make", [
    lambda m: m.constant_lr(0.05),
    lambda m: m.warmup_linear_scaled_lr(0.01, 4, 10),
    lambda m: m.large_then_fixed_lr(0.01, 3.0, 5),
    lambda m: m.step_decay_lr(0.1, 0.5, 4),
    lambda m: m.cosine_lr(0.1, 30, warmup=5),
    lambda m: m.cosine_lr(0.1, 30),
])
def test_lr_schedules_match_reference(make):
    jfn, tfn = make(jsgd), make(tsgd)
    for step in (0, 1, 4, 5, 9, 10, 17, 29, 40):
        np.testing.assert_allclose(float(tfn(step)), float(jfn(step)), rtol=1e-6)


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
@pytest.mark.parametrize("drop", [True, False])
def test_loader_epoch_order_identical(shard, drop):
    x = np.arange(103 * 2, dtype=np.float32).reshape(103, 2)
    y = np.arange(103, dtype=np.int32)
    a = JLoader(x, y, 16, seed=7, shard_id=shard[0], num_shards=shard[1], drop_remainder=drop)
    b = ShardedLoader(x, y, 16, seed=7, shard_id=shard[0], num_shards=shard[1],
                      drop_remainder=drop)
    assert a.steps_per_epoch == b.steps_per_epoch
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(a.epoch_order(epoch), b.epoch_order(epoch))
        for (xa, ya), (xb, yb) in zip(a.epoch(epoch), b.epoch(epoch)):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError, match="shard_id"):
        ShardedLoader(x, y, 16, shard_id=3, num_shards=3)


def _models(seed=0, **overrides):
    fields = dict(FIELDS, **overrides)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=seed)
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    return jm, tm


def test_one_train_step_matches_reference():
    """Two steps from a nonzero velocity: params and velocity within 1e-5."""
    jm, tm = _models(seed=1)
    rng = np.random.default_rng(2)
    jopt = jsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    topt = tsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    vel = {k: [0.01 * rng.standard_normal(np.shape(a)).astype(np.float32) for a in v]
           for k, v in jm.params().items()}
    js = jsgd.SGDState(velocity={k: tuple(jnp.asarray(a) for a in v) for k, v in vel.items()},
                       step=jnp.asarray(3, jnp.int32))
    ts = sgd_state_from_numpy(vel, 3, device="cpu")
    jstep = jsteps.make_mlp_train_step(jm.config, jopt)
    tstep = tsteps.make_mlp_train_step(tm.config, topt)
    jp, tp = jm.params(), tm.params()
    for _ in range(2):
        x = rng.standard_normal((16, 784)).astype(np.float32)
        y = rng.integers(0, 10, 16).astype(np.int32)
        jp, js, jl = jstep(jp, js, jm.topo_arrays(), jnp.asarray(x), jnp.asarray(y),
                           jnp.asarray(0.05, jnp.float32), jax.random.PRNGKey(0))
        tp, ts, tl = tstep(tp, ts, tm.topo_arrays(), torch.as_tensor(x),
                           torch.as_tensor(y).long(), torch.tensor(0.05), None)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        for k in ("values", "biases"):
            for a, b in zip(tp[k], jp[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            for a, b in zip(ts.velocity[k], js.velocity[k]):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert int(ts.step) == int(js.step) == 5


def _capture_topologies(store):
    def hook(trainer, epoch):
        store.append([(t.rows.copy(), t.cols.copy()) for t in trainer.model.topos])
    return hook


def _run_both(epochs=3, fused=True, seed=0, data_scale=0.01, **tc_overrides):
    data_j = jdata.load("fashionmnist", scale=data_scale)
    data_t = tdata.load("fashionmnist", scale=data_scale)
    jm, tm = _models(seed=seed)
    tc = dict(epochs=epochs, batch_size=32, lr=0.01, zeta=0.3, seed=seed,
              device_evolution=False, fused_epochs=fused, **tc_overrides)
    jt = jtrainer.SequentialTrainer(
        jm, data_j, jtrainer.TrainerConfig(
            **tc, pruning=JSchedule(tau=1, period=1, percentile=5.0)))
    tt = ttrainer.SequentialTrainer(
        tm, data_t, ttrainer.TrainerConfig(
            **tc, pruning=PruningSchedule(tau=1, period=1, percentile=5.0)))
    topo_j, topo_t = [], []
    jt.epoch_end_hook = _capture_topologies(topo_j)
    tt.epoch_end_hook = _capture_topologies(topo_t)
    return jt, tt, jt.run(), tt.run(), topo_j, topo_t


def _assert_same_run(hj, ht, topo_j, topo_t, n_test):
    assert ht["epoch"] == hj["epoch"]
    assert ht["n_params"] == hj["n_params"]
    assert len(topo_t) == len(topo_j) == len(hj["epoch"])
    for tj, tt in zip(topo_j, topo_t):
        for (rj, cj), (rt, ct) in zip(tj, tt):
            np.testing.assert_array_equal(rt, rj)
            np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(ht["train_loss"], hj["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(ht["test_acc"], hj["test_acc"], atol=1.0 / n_test + 1e-9)


def test_sequential_trainer_matches_reference():
    """3 fused epochs, SET every epoch and importance pruning at epochs 1
    and 2, dropout 0, host evolution: the same topology after every epoch,
    the same n_params history, loss and accuracy within tolerance."""
    jt, tt, hj, ht, topo_j, topo_t = _run_both()
    assert ht["n_params"][1] < ht["n_params"][0]  # pruning fired
    assert len(set(map(len, ht.values()))) == 1 and set(ht) == set(hj)
    _assert_same_run(hj, ht, topo_j, topo_t, len(jt.data.y_test))
    assert all(s > 0 for s in ht["epoch_seconds"])
    # the trained model's final state matches too
    for a, b in zip(tt.model.values, jt.model.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    assert (tt.gstep, tt.epoch_next) == (jt.gstep, jt.epoch_next)


def test_per_batch_mode_matches_reference_and_fused():
    jt, tt, hj, ht, topo_j, topo_t = _run_both(epochs=2, fused=False)
    _assert_same_run(hj, ht, topo_j, topo_t, len(jt.data.y_test))
    # the port's two modes run the same arithmetic in the same order
    _, tt_fused, _, hf, _, _ = _run_both(epochs=2, fused=True)
    assert hf["train_loss"] == ht["train_loss"] and hf["n_params"] == ht["n_params"]
    for a, b in zip(tt.model.values, tt_fused.model.values):
        assert torch.equal(a, b)


def test_dropout_run_is_finite_falls_and_is_reproducible():
    data = tdata.load("fashionmnist", scale=0.01)
    hist = []
    for fused in (True, False, True):
        tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**dict(FIELDS, dropout=0.3)), seed=0,
                            device="cpu")
        tc = ttrainer.TrainerConfig(epochs=3, batch_size=32, lr=0.01, seed=0,
                                    device_evolution=False, fused_epochs=fused)
        hist.append(ttrainer.SequentialTrainer(tm, data, tc).run())
    h = hist[0]
    assert np.isfinite(h["train_loss"]).all() and h["train_loss"][-1] < h["train_loss"][0]
    # one generator, drawn in the same order by both modes
    assert hist[1]["train_loss"] == h["train_loss"] == hist[2]["train_loss"]


def test_trainer_refuses_what_this_slice_lacks():
    data = tdata.load("fashionmnist", scale=0.01)
    tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**FIELDS), seed=0, device="cpu")
    # device evolution is ported: the default config is taken
    # (tests/test_torch_device_train.py holds it against the reference)
    ttrainer.SequentialTrainer(tm, data, ttrainer.TrainerConfig())
    # the probes are ported (tests/test_torch_probes.py): a probed trainer is made
    assert ttrainer.SequentialTrainer(tm, data, ttrainer.TrainerConfig(
        device_evolution=False, probe=True))._probe_segment is not None
    # element training is ported: its trainer runs (test_torch_element_train.py
    # holds it against the reference)
    el = tmlp.SparseMLP(tmlp.SparseMLPConfig(**dict(FIELDS, impl="element")), seed=0,
                        device="cpu")
    hist = ttrainer.SequentialTrainer(
        el, data, ttrainer.TrainerConfig(device_evolution=False, epochs=1)).run()
    assert np.isfinite(hist["train_loss"]).all() and hist["n_params"] == [el.n_params]
    ttrainer.SequentialTrainer(el, data, ttrainer.TrainerConfig())
    # no evolution needs no device evolution
    tr = ttrainer.SequentialTrainer(tm, data, ttrainer.TrainerConfig(evolve=False, epochs=1))
    tr.fault_hook = lambda step: None
    with pytest.raises(NotImplementedError, match="fault hooks.*item 5"):
        tr.run()
    # the out-of-core trainer is ported (tests/test_torch_xl.py holds it
    # against the reference); it takes the probes and refuses the fault hook
    plan = plan_memory_budget(el.config.layer_dims, [t.nnz for t in el.topos], 32,
                              budget_bytes=10**8)
    ttrainer.XLTrainer(el, data, ttrainer.TrainerConfig(batch_size=32, probe=True), plan)
    xl = ttrainer.XLTrainer(el, data, ttrainer.TrainerConfig(batch_size=32, epochs=1), plan)
    xl.fault_hook = lambda step: None
    with pytest.raises(NotImplementedError, match="fault hooks.*item 5"):
        xl.run()
    assert dataclasses.asdict(ttrainer.TrainerConfig()) == dataclasses.asdict(
        jtrainer.TrainerConfig())
    # the masked and dense impls train now (tests/test_torch_mlp_training.py
    # holds them against the reference), with no topology phase; the
    # forward's pre-activations and device evolution's churn probe are
    # ported (tests/test_torch_probes.py)
    for impl in ("masked", "dense"):
        m = tmlp.SparseMLP(tmlp.SparseMLPConfig(**dict(FIELDS, impl=impl)), seed=0,
                           device="cpu")
        tr = ttrainer.SequentialTrainer(m, data, ttrainer.TrainerConfig(
            epochs=1, batch_size=32, pruning=PruningSchedule(tau=0, period=1, percentile=50.0)))
        hist = tr.run()
        assert hist["n_params"] == [m.n_params] and np.isfinite(hist["train_loss"]).all()
    logits, pre = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.zeros((2, 784)),
                                   tm.config, return_preacts=True)
    assert len(pre) == tm.config.n_layers and torch.equal(pre[-1], logits)
    vel = [torch.zeros_like(v) for v in el.values]
    out = evolve_element_layers_device(el.topo_arrays(), el.values, vel, torch.Generator(),
                                       layer_dims=el.config.layer_dims, zeta=0.3, probe=True)
    assert out[3].shape == (el.config.n_layers,)


def test_evaluate_matches_reference():
    jm, tm = _models(seed=3)
    data = tdata.load("fashionmnist", scale=0.01)
    assert ttrainer.evaluate(tm, data.x_test, data.y_test, batch=37) == jtrainer.evaluate(
        jm, data.x_test, data.y_test, batch=37)
