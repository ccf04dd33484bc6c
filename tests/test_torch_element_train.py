"""The port's element (COO) training path against the JAX reference on the
CPU: host SET (``evolve_element``, ``retain_valid_updates_element``) bit
for bit on the same rng, importance pruning with the element cascade, one
element train step, and whole ``SequentialTrainer`` runs of the
``examples/quickstart.py`` architecture (784-100-100-100-10, epsilon 20,
alpha 0.6, he_uniform) with host evolution and pruning firing.

Tolerances: topology, values and draws of the host phases bit-equal (the
same numpy algorithm on the same numbers); one step's params, velocity and
loss at rtol = atol = 1e-5 (f32); a 3-epoch run holds the topology and the
``n_params`` history exactly equal after every epoch (integer decisions on
the same seeded draws), the loss history at rtol = 1e-4, and test accuracy
within one test sample (a sample whose top two logits tie within float
noise may flip).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.interop import mlp_from_numpy, sgd_state_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
HP = jdata.PAPER_HPARAMS["fashionmnist"]
# examples/quickstart.py's model, at dropout 0 so that both packages draw
# nothing the other cannot
QUICKSTART = dict(
    layer_dims=(784, *[max(32, h // 10) for h in jdata.PAPER_ARCHS["fashionmnist"]], 10),
    epsilon=HP["epsilon"], activation="all_relu", alpha=HP["alpha"], dropout=0.0,
    init=HP["init"], impl="element",
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topologies(seed, in_dim=40, out_dim=30, epsilon=5):
    j = jsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, np.random.default_rng(seed))
    return j, tsp.ElementTopology(in_dim, out_dim, j.rows, j.cols)


@pytest.mark.parametrize("with_momentum", [True, False])
@pytest.mark.parametrize("scheme", ["normal", "he_uniform"])
@pytest.mark.parametrize("dims", [(40, 30, 5), (12, 9, 30)])  # sparse and dense vacancy draws
def test_evolve_element_bit_equal(dims, scheme, with_momentum):
    j, t = _topologies(1, *dims)
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(j.nnz).astype(np.float32)
    vals[::7] = 0.0  # exact zeros are always pruned
    mom = rng.standard_normal(j.nnz).astype(np.float32) if with_momentum else None
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    a = jtopo.evolve_element(j, vals, 0.3, rj, momentum=mom, init_scheme=scheme)
    b = ttopo.evolve_element(t, vals, 0.3, rt, momentum=mom, init_scheme=scheme)
    np.testing.assert_array_equal(b.topology.rows, a.topology.rows)
    np.testing.assert_array_equal(b.topology.cols, a.topology.cols)
    np.testing.assert_array_equal(b.values, a.values)
    if with_momentum:
        np.testing.assert_array_equal(b.momentum, a.momentum)
    else:
        assert a.momentum is None and b.momentum is None
    assert (b.n_pruned, b.n_grown) == (a.n_pruned, a.n_grown) and b.n_grown > 0
    assert b.topology.nnz == t.nnz
    assert rt.integers(1 << 30) == rj.integers(1 << 30)  # the same draws, in the same order


def test_retain_valid_updates_element_bit_equal():
    j, t = _topologies(4)
    rng = np.random.default_rng(5)
    vals = rng.standard_normal(j.nnz).astype(np.float32)
    new_j = jtopo.evolve_element(j, vals, 0.3, np.random.default_rng(6)).topology
    new_t = ttopo.evolve_element(t, vals, 0.3, np.random.default_rng(6)).topology
    upd = rng.standard_normal(j.nnz).astype(np.float32)
    got = ttopo.retain_valid_updates_element(upd, t, new_t)
    np.testing.assert_array_equal(got, jtopo.retain_valid_updates_element(upd, j, new_j))
    assert (got == 0).sum() >= int(0.3 * j.nnz) // 2  # vanished connections get nothing


def test_importance_prune_element_ties_and_unconnected_neurons():
    """Columns of equal importance fall on the same side of the
    threshold, and a column with no connection is never reported pruned, on
    both packages alike."""
    rows = np.array([0, 1, 2, 0, 1, 2, 0, 3, 1, 2], np.int32)
    cols = np.array([0, 0, 0, 1, 1, 1, 2, 2, 4, 4], np.int32)  # column 3 has none
    vals = np.array([1, 1, 1, 1, 1, 1, 3, 3, 0.5, 0.25], np.float32)  # 0 and 1 tie
    mom = np.arange(10, dtype=np.float32)
    j = jsp.ElementTopology(4, 5, rows, cols)
    t = tsp.ElementTopology(4, 5, rows, cols)
    for pct in (10.0, 40.0, 60.0, 99.0):
        a = jimp.importance_prune_element(j, vals[np.lexsort((rows, cols))],
                                          jimp.PruningSchedule(percentile=pct),
                                          momentum=mom)
        b = timp.importance_prune_element(t, vals[np.lexsort((rows, cols))],
                                          timp.PruningSchedule(percentile=pct),
                                          momentum=mom)
        np.testing.assert_array_equal(b.pruned_neurons, a.pruned_neurons)
        assert 3 not in b.pruned_neurons
        assert (0 in b.pruned_neurons) == (1 in b.pruned_neurons)
        np.testing.assert_array_equal(b.topology.rows, a.topology.rows)
        np.testing.assert_array_equal(b.topology.cols, a.topology.cols)
        np.testing.assert_array_equal(b.values, a.values)
        np.testing.assert_array_equal(b.momentum, a.momentum)
        assert b.removed_params == a.removed_params


def _models(seed=0, **overrides):
    fields = dict(QUICKSTART, **overrides)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=seed)
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    return jm, tm


def test_interop_carries_an_element_model_and_its_velocity():
    jm, tm = _models(seed=2)
    assert tm.config.impl == "element" and tm.n_params == jm.n_params
    for tt, jt, tv, jv in zip(tm.topos, jm.topos, tm.values, jm.values):
        assert isinstance(tt, tsp.ElementTopology)
        np.testing.assert_array_equal(tt.rows, jt.rows)
        np.testing.assert_array_equal(tt.cols, jt.cols)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    vel = {k: [np.full(np.shape(a), 0.5, np.float32) for a in v] for k, v in jm.params().items()}
    ts = sgd_state_from_numpy(vel, 7, device="cpu")
    assert int(ts.step) == 7
    for k in vel:
        for a, b in zip(ts.velocity[k], tm.params()[k]):
            assert a.shape == b.shape and bool((a == 0.5).all())


@pytest.mark.parametrize("element_impl", ["auto", "custom"])
def test_one_element_train_step_matches_reference(element_impl):
    """Two steps from a nonzero velocity and nonzero biases: params,
    velocity and loss within 1e-5."""
    jm, tm = _models(seed=1, element_impl=element_impl)
    rng = np.random.default_rng(2)
    biases = [0.1 * rng.standard_normal(np.shape(b)).astype(np.float32) for b in jm.biases]
    jp = {"values": tuple(jm.values), "biases": tuple(jnp.asarray(b) for b in biases)}
    tp = {"values": tuple(tm.values), "biases": tuple(torch.as_tensor(b) for b in biases)}
    jopt = jsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    topt = tsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    vel = {k: [0.01 * rng.standard_normal(np.shape(a)).astype(np.float32) for a in v]
           for k, v in jm.params().items()}
    js = jsgd.SGDState(velocity={k: tuple(jnp.asarray(a) for a in v) for k, v in vel.items()},
                       step=jnp.asarray(3, jnp.int32))
    ts = sgd_state_from_numpy(vel, 3, device="cpu")
    jstep = jsteps.make_mlp_train_step(jm.config, jopt)
    tstep = tsteps.make_mlp_train_step(tm.config, topt)
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


def _pruned_pair(seed=0):
    """Both trainers of the same model, with 40% of each hidden layer's
    neurons below the pruning threshold."""
    data_j = jdata.load("fashionmnist", scale=0.01)
    data_t = tdata.load("fashionmnist", scale=0.01)
    jm, tm = _models(seed=seed)
    tc = dict(epochs=2, batch_size=64, seed=seed, device_evolution=False)
    jt = jtrainer.SequentialTrainer(jm, data_j, jtrainer.TrainerConfig(
        **tc, pruning=jimp.PruningSchedule(tau=0, period=1, percentile=40.0)))
    tt = ttrainer.SequentialTrainer(tm, data_t, ttrainer.TrainerConfig(
        **tc, pruning=timp.PruningSchedule(tau=0, period=1, percentile=40.0)))
    return jt, tt


def test_element_cascade_prune_matches_reference():
    """Importance pruning at epoch 0 on the same model and velocity: the
    hidden layers lose the weak neurons' incoming connections, the next
    layer (the output layer too) their outgoing ones."""
    jt, tt = _pruned_pair()
    rng = np.random.default_rng(4)
    vel = [rng.standard_normal(np.shape(v)).astype(np.float32) for v in jt.model.values]
    jt.opt_state = jsgd.replace_values_velocity(jt.opt_state, [jnp.asarray(v) for v in vel])
    tt.opt_state = tsgd.replace_values_velocity(tt.opt_state, [torch.as_tensor(v) for v in vel])
    before = [t.nnz for t in tt.model.topos]
    jt._importance_prune(0)
    tt._importance_prune(0)
    after = [t.nnz for t in tt.model.topos]
    assert all(a < b for a, b in zip(after, before))  # the output layer: the cascade
    for l, (a, b) in enumerate(zip(jt.model.topos, tt.model.topos)):
        np.testing.assert_array_equal(b.rows, a.rows, err_msg=f"layer {l}")
        np.testing.assert_array_equal(b.cols, a.cols, err_msg=f"layer {l}")
        np.testing.assert_array_equal(tt.model.values[l].numpy(), np.asarray(jt.model.values[l]))
        np.testing.assert_array_equal(tt.opt_state.velocity["values"][l].numpy(),
                                      np.asarray(jt.opt_state.velocity["values"][l]))
    assert tt.model.n_params == jt.model.n_params


def _capture_topologies(store):
    def hook(trainer, epoch):
        store.append([(t.rows.copy(), t.cols.copy()) for t in trainer.model.topos])
    return hook


def _run_both(epochs=3, fused=True, seed=0):
    data_j = jdata.load("fashionmnist", scale=0.01)
    data_t = tdata.load("fashionmnist", scale=0.01)
    jm, tm = _models(seed=seed)
    tc = dict(epochs=epochs, batch_size=min(HP["batch"], 64), lr=HP["lr"], zeta=0.3, seed=seed,
              device_evolution=False, fused_epochs=fused)
    jt = jtrainer.SequentialTrainer(
        jm, data_j, jtrainer.TrainerConfig(
            **tc, pruning=jimp.PruningSchedule(tau=1, period=1, percentile=10.0)))
    tt = ttrainer.SequentialTrainer(
        tm, data_t, ttrainer.TrainerConfig(
            **tc, pruning=timp.PruningSchedule(tau=1, period=1, percentile=10.0)))
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


def test_element_trainer_matches_reference():
    """3 fused epochs of the quickstart model, SET after epochs 0 and 1 and
    importance pruning (with the cascade) at epochs 1 and 2, dropout 0, host
    evolution: the same topology after every epoch, the same n_params
    history, loss and accuracy within tolerance, and the final weights."""
    jt, tt, hj, ht, topo_j, topo_t = _run_both()
    assert ht["n_params"][2] < ht["n_params"][1] < ht["n_params"][0]  # pruning fired
    assert len(set(map(len, ht.values()))) == 1 and set(ht) == set(hj)
    _assert_same_run(hj, ht, topo_j, topo_t, len(jt.data.y_test))
    for a, b in zip(tt.model.values, jt.model.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    assert (tt.gstep, tt.epoch_next) == (jt.gstep, jt.epoch_next)


def test_element_per_batch_mode_matches_reference_and_fused():
    jt, tt, hj, ht, topo_j, topo_t = _run_both(epochs=2, fused=False)
    _assert_same_run(hj, ht, topo_j, topo_t, len(jt.data.y_test))
    _, tt_fused, _, hf, _, _ = _run_both(epochs=2, fused=True)
    assert hf["train_loss"] == ht["train_loss"] and hf["n_params"] == ht["n_params"]
    for a, b in zip(tt.model.values, tt_fused.model.values):
        assert torch.equal(a, b)


def test_element_dropout_run_falls_and_is_reproducible():
    """At the quickstart's dropout 0.2 (its masks drawn from the trainer's
    torch.Generator, which the reference's jax.random cannot match): the
    loss is finite and falls, and the same seed gives the same run."""
    data = tdata.load("fashionmnist", scale=0.01)
    hist = []
    for _ in range(2):
        tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**dict(QUICKSTART, dropout=0.2)), seed=0,
                            device="cpu")
        tc = ttrainer.TrainerConfig(epochs=3, batch_size=64, lr=HP["lr"], seed=0,
                                    device_evolution=False)
        hist.append(ttrainer.SequentialTrainer(tm, data, tc).run())
    h = hist[0]
    assert np.isfinite(h["train_loss"]).all() and h["train_loss"][-1] < h["train_loss"][0]
    assert hist[1]["train_loss"] == h["train_loss"]
