"""The twin of ``tests/test_mlp_training.py`` on the port, and the paper's
masked and dense baselines against the JAX reference on the CPU.

* **The reference's end-to-end behaviour on the port.** The SET-MLP learns
  under every impl (element, block, masked, dense) with evolution and
  dropout; importance pruning shrinks an element model without collapse;
  the sparse model is far smaller than the dense one; the element forward
  agrees with the densified scatter; All-ReLU's parity signs.
* **Masked and dense against the reference.** The seeded draws (the mask's
  ER topology, then the dense matrix) bit-equal; ``n_params`` and the
  topology arrays (the masked model's 0/1 mask, ``None`` per dense layer)
  equal; the forward and one momentum-SGD step at rtol = atol = 1e-5 (f32,
  IEEE ``torch.matmul``), the masked step's gradient zero off the mask; a
  2-epoch dropout-0 ``SequentialTrainer`` run (pruning scheduled, which
  both skip) with the loss history at the same tolerance, accuracies and
  ``n_params`` equal and the topology unchanged; checkpoints in the
  reference's layout (no topology files), resumed bit-equal and restored by
  the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core.importance import PruningSchedule as JSchedule  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.all_relu import all_relu  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, mlp_forward  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train.trainer import SequentialTrainer, TrainerConfig, evaluate  # noqa: E402

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


def tiny_data(name="fashionmnist", scale=0.02, seed=0):
    # 10-class image clone: chance = 0.1, separable enough for tiny budgets
    return datasets.load(name, scale=scale, seed=seed)


# ---------------------------------------------------------------------------
# the twin of tests/test_mlp_training.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["element", "block", "masked", "dense"])
def test_mlp_learns(impl):
    data = tiny_data()
    cfg = SparseMLPConfig(
        layer_dims=(data.n_features, 64, 32, data.n_classes), epsilon=16,
        activation="all_relu", alpha=0.6, dropout=0.1, impl=impl, block_m=8, block_n=8,
    )
    model = SparseMLP(cfg, seed=0, device="cpu")
    tc = TrainerConfig(epochs=8, batch_size=32, lr=0.01, zeta=0.2, seed=0)
    hist = SequentialTrainer(model, data, tc).run()
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert hist["test_acc"][-1] > 0.5, impl  # chance is 0.1 (10 classes)
    assert np.isfinite(hist["train_loss"]).all()


def test_importance_pruning_shrinks_params_without_collapse():
    data = tiny_data()
    cfg = SparseMLPConfig(
        layer_dims=(data.n_features, 64, 32, data.n_classes),
        epsilon=16, activation="all_relu", alpha=0.6, dropout=0.0, impl="element",
    )
    model = SparseMLP(cfg, seed=1, device="cpu")
    tc = TrainerConfig(
        epochs=10, batch_size=32, lr=0.01, zeta=0.2, seed=1,
        pruning=PruningSchedule(tau=4, period=2, percentile=10.0),
    )
    hist = SequentialTrainer(model, data, tc).run()
    assert hist["n_params"][-1] < hist["n_params"][0]
    assert hist["test_acc"][-1] > 0.5


def test_all_relu_parity_signs():
    """Eq. (3): even layers use -alpha, odd layers +alpha on negatives."""
    x = torch.tensor([-2.0, 3.0])
    np.testing.assert_allclose(all_relu(x, 0.5, layer_index=2).numpy(), [1.0, 3.0])
    np.testing.assert_allclose(all_relu(x, 0.5, layer_index=1).numpy(), [-1.0, 3.0])


def test_sparse_model_smaller_than_dense():
    data = tiny_data()
    dims = (data.n_features, 128, 128, data.n_classes)
    sparse = SparseMLP(SparseMLPConfig(layer_dims=dims, epsilon=10, impl="element"),
                       device="cpu")
    dense = SparseMLP(SparseMLPConfig(layer_dims=dims, impl="dense"), device="cpu")
    assert sparse.n_params < 0.35 * dense.n_params
    want = jmlp.SparseMLP(jmlp.SparseMLPConfig(layer_dims=dims, impl="dense"))
    assert dense.n_params == want.n_params == sum(
        a * b + b for a, b in zip(dims[:-1], dims[1:]))


@pytest.mark.parametrize("impl", ["element", "block", "masked"])
def test_forward_agrees_with_dense_scatter(impl):
    data = tiny_data()
    cfg = SparseMLPConfig(layer_dims=(data.n_features, 32, data.n_classes), epsilon=8,
                          impl=impl, dropout=0.0, block_m=8, block_n=8)
    model = SparseMLP(cfg, seed=3, device="cpu")
    x = torch.as_tensor(data.x_test[:16])
    logits = mlp_forward(model.params(), model.topo_arrays(), x, cfg, train=False)
    h = x
    for l in range(cfg.n_layers):
        v = model.values[l]
        w = v * model.topo_arrays()[l] if impl == "masked" else model.topos[l].to_dense(v)
        h = h @ w + model.biases[l]
        if l < cfg.n_layers - 1:
            h = all_relu(h, cfg.alpha, l + 1)
    np.testing.assert_allclose(logits.detach().numpy(), h.detach().numpy(), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# masked and dense against the reference
# ---------------------------------------------------------------------------

FIELDS = dict(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, dropout=0.0)


def _port(jm):
    return mlp_from_numpy(dataclasses.asdict(jm.config),
                          [None if t is None else (t.rows, t.cols) for t in jm.topos],
                          [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                          device="cpu")


@pytest.mark.parametrize("impl", ["masked", "dense"])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("init", ["he_uniform", "normal", "xavier"])
def test_masked_dense_draws_match_reference(impl, seed, init):
    cfg = dict(FIELDS, impl=impl, init=init)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**cfg), seed=seed)
    tm = SparseMLP(SparseMLPConfig(**cfg), seed=seed, device="cpu")
    for l in range(tm.config.n_layers):
        np.testing.assert_array_equal(tm.values[l].numpy(), np.asarray(jm.values[l]))
        np.testing.assert_array_equal(tm.biases[l].numpy(), np.asarray(jm.biases[l]))
        if impl == "masked":
            np.testing.assert_array_equal(tm.topos[l].rows, jm.topos[l].rows)
            np.testing.assert_array_equal(tm.topos[l].cols, jm.topos[l].cols)
        else:
            assert tm.topos[l] is None and jm.topos[l] is None
    assert tm.n_params == jm.n_params
    for got, want in zip(tm.topo_arrays(), jm.topo_arrays()):
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["masked", "dense"])
@pytest.mark.parametrize("infer", [True, False])
@pytest.mark.parametrize("activation", ["all_relu", "relu"])
def test_masked_dense_forward_matches_reference(impl, infer, activation):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**dict(FIELDS, impl=impl, activation=activation)),
                        seed=2)
    rng = np.random.default_rng(3)
    jm.biases = [jnp.asarray(rng.standard_normal(b.shape).astype(np.float32))
                 for b in jm.biases]
    tm = _port(jm)
    x = rng.standard_normal((37, 784)).astype(np.float32)
    want = jmlp.mlp_forward(jm.params(), jm.topo_arrays(), jnp.asarray(x), jm.config,
                            infer=infer)
    with torch.no_grad():
        got = mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x), tm.config,
                          infer=infer)
        lead = mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x)[None],
                           tm.config, infer=infer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(lead[0].numpy(), got.numpy())


@pytest.mark.parametrize("impl", ["masked", "dense"])
def test_masked_dense_step_matches_reference(impl):
    """Two momentum-SGD steps: loss, params and velocity within 1e-5; the
    masked model's gradient is zero off the mask, as the reference's."""
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**dict(FIELDS, impl=impl)), seed=1)
    tm = _port(jm)
    jopt = jsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    topt = tsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4)
    jstep = jsteps.make_mlp_train_step(jm.config, jopt)
    tstep = tsteps.make_mlp_train_step(tm.config, topt)
    jp, js = jm.params(), jopt.init(jm.params())
    tp, ts = tm.params(), topt.init(tm.params())
    rng = np.random.default_rng(2)
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
    # the gradient off the mask: with no weight decay and no momentum, an
    # off-mask weight does not move
    if impl == "masked":
        opt = tsgd.MomentumSGD(momentum=0.0, weight_decay=0.0)
        p0 = tm.params()
        p1, _, _ = tsteps.make_mlp_train_step(tm.config, opt)(
            p0, opt.init(p0), tm.topo_arrays(), torch.as_tensor(x), torch.as_tensor(y).long(),
            torch.tensor(0.05), None)
        for a, b, mask in zip(p1["values"], p0["values"], tm.topo_arrays()):
            off = mask == 0
            assert torch.equal(a[off], b[off]) and not torch.equal(a, b)


def _capture_topologies(store):
    def hook(trainer, epoch):
        store.append([None if t is None else (t.rows.copy(), t.cols.copy())
                      for t in trainer.model.topos])
    return hook


@pytest.mark.parametrize("impl", ["masked", "dense"])
@pytest.mark.parametrize("fused", [True, False])
def test_masked_dense_trainer_history_matches_reference(impl, fused):
    """2 epochs at dropout 0 with SET and importance pruning scheduled, which
    both packages skip for these impls: the same history keys, n_params and
    accuracies equal, the loss within 1e-5, the topology unchanged."""
    data_j = jdata.load("fashionmnist", scale=0.01)
    data_t = datasets.load("fashionmnist", scale=0.01)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**dict(FIELDS, impl=impl)), seed=4)
    tm = _port(jm)
    tc = dict(epochs=2, batch_size=32, lr=0.01, zeta=0.3, seed=4, fused_epochs=fused)
    jt = jtrainer.SequentialTrainer(jm, data_j, jtrainer.TrainerConfig(
        **tc, pruning=JSchedule(tau=0, period=1, percentile=20.0)))
    tt = SequentialTrainer(tm, data_t, TrainerConfig(
        **tc, pruning=PruningSchedule(tau=0, period=1, percentile=20.0)))
    topo_j, topo_t = [], []
    jt.epoch_end_hook = _capture_topologies(topo_j)
    tt.epoch_end_hook = _capture_topologies(topo_t)
    hj, ht = jt.run(), tt.run()
    assert set(ht) == set(hj) and ht["epoch"] == hj["epoch"] == [0, 1]
    assert ht["n_params"] == hj["n_params"] == [tm.n_params] * 2
    assert ht["test_acc"] == hj["test_acc"]
    np.testing.assert_allclose(ht["train_loss"], hj["train_loss"], **TOL)
    first = [None if t is None else (t.rows, t.cols) for t in _port(jm).topos]
    for tj, tt_ in zip(topo_j, topo_t):
        for a, b, c in zip(tj, tt_, first):
            if c is None:
                assert a is None and b is None
            else:
                for x, y, z in zip(a, b, c):
                    np.testing.assert_array_equal(x, z)
                    np.testing.assert_array_equal(y, z)
    for a, b in zip(tt.model.values, jt.model.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert evaluate(tt.model, data_t.x_test, data_t.y_test) == ht["test_acc"][-1]


@pytest.mark.parametrize("impl", ["masked", "dense"])
def test_masked_dense_checkpoint_resumes_and_crosses(impl, tmp_path):
    """Saved at every epoch with no topology files, as the reference's; a
    fresh trainer restored from epoch 0 runs on bit-equal (dropout 0.2: the
    generator's stream resumes too); the reference restores the port's
    checkpoint with the same params and velocity."""
    data = datasets.load("fashionmnist", scale=0.01)
    cfg = SparseMLPConfig(**dict(FIELDS, impl=impl, dropout=0.2))
    tc = TrainerConfig(epochs=3, batch_size=32, lr=0.01, seed=2)
    mgr = CheckpointManager(str(tmp_path / "port"), async_write=False, keep_last=5)
    full = SequentialTrainer(SparseMLP(cfg, seed=2, device="cpu"), data, tc)
    full.epoch_end_hook = lambda tr, epoch: tr.save_checkpoint(mgr)
    want = full.run()
    step0 = mgr.all_steps()[0]
    assert not (mgr.dir / f"step_{step0:09d}" / "topology").exists()
    resumed = SequentialTrainer(SparseMLP(cfg, seed=2, device="cpu"), data, tc)
    assert resumed.restore_checkpoint(mgr, step=step0) == step0
    got = resumed.run()
    for k in ("epoch", "train_loss", "test_acc", "n_params"):
        assert got[k] == want[k]
    for a, b in zip(resumed.model.values, full.model.values):
        assert torch.equal(a, b)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**dataclasses.asdict(cfg)), seed=2)
    jt = jtrainer.SequentialTrainer(jm, jdata.load("fashionmnist", scale=0.01),
                                    jtrainer.TrainerConfig(epochs=3, batch_size=32, lr=0.01,
                                                           seed=2))
    jt.restore_checkpoint(jmanager.CheckpointManager(str(tmp_path / "port")), step=step0)
    resumed0 = SequentialTrainer(SparseMLP(cfg, seed=2, device="cpu"), data, tc)
    resumed0.restore_checkpoint(mgr, step=step0)
    for a, b in zip(resumed0.model.values, jt.model.values):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(resumed0.opt_state.velocity["values"], jt.opt_state.velocity["values"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (jt.gstep, jt.epoch_next) == (resumed0.gstep, resumed0.epoch_next)
