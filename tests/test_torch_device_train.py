"""The port's trainer with device-resident SET (``device_evolution=True``,
the default) against the reference's fused trainer on the CPU, fed the
reference's draws.

The reference evolves on the device with ``jax.random``, the port with a
``torch.Generator``: the two give other numbers. So each run records the
key the reference passes to each evolution (``evolve_element_layers_device``
for an element model, ``evolve_block_device`` per layer for a block model,
wrapped in ``repro.train.trainer``), makes that evolution's draws from it
as the reference does, and hands them to the port's trainer in place of its
own (``repro_torch.core.topology.evolution_draws``, replaced).

Runs: 3 fused epochs, dropout 0, SET after epochs 0 and 1 and importance
pruning at epochs 1 and 2, on the element quickstart model and on the
block model of ``tests/test_torch_train.py``. Tolerances, those of the
host-evolution runs (``tests/test_torch_element_train.py``): the topology
and the ``n_params`` history equal after every epoch (integer decisions
on the same draws), the loss history at rtol 1e-4, test accuracy within
one test sample.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

HP = jdata.PAPER_HPARAMS["fashionmnist"]
ELEMENT = dict(
    layer_dims=(784, *[max(32, h // 10) for h in jdata.PAPER_ARCHS["fashionmnist"]], 10),
    epsilon=HP["epsilon"], activation="all_relu", alpha=HP["alpha"], dropout=0.0,
    init=HP["init"], impl="element",
)
BLOCK = dict(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, block_m=8, block_n=8,
             impl="block", dropout=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(fields, seed=0):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=seed)
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    return jm, tm


def _record_reference_draws(monkeypatch, draws):
    """Wrap the reference trainer's device evolutions so that each appends
    the draws it makes, per layer in order, to ``draws``: the candidates
    and (element) the initial values, as ``(n, total, cand, init)``."""
    evolve_layers = jtrainer.evolve_element_layers_device
    evolve_block = jtrainer.evolve_block_device

    def element_spy(topo_arrays, values, velocity, key, *, layer_dims, zeta,
                    init_scheme="he_uniform", probe=False):
        keys = jax.random.split(key, len(topo_arrays))
        for l, t in enumerate(topo_arrays):
            n, total = int(t.rows.shape[0]), layer_dims[l] * layer_dims[l + 1]
            k_grow, k_init = jax.random.split(keys[l])
            cand = jax.random.randint(k_grow, (2 * n,), 0, total, dtype=jnp.int32)
            init = jtopo._init_device(k_init, (n,), fan_in_dense=layer_dims[l],
                                      scheme=init_scheme)
            draws.append((n, total, np.asarray(cand), np.asarray(init)))
        return evolve_layers(topo_arrays, values, velocity, key, layer_dims=layer_dims,
                             zeta=zeta, init_scheme=init_scheme, probe=probe)

    def block_spy(rows, cols, values, momentum, key, *, meta, zeta):
        n = int(rows.shape[0])
        k_grow, _ = jax.random.split(key)
        cand = jax.random.randint(k_grow, (2 * n,), 0, meta.total_blocks, dtype=jnp.int32)
        draws.append((n, meta.total_blocks, np.asarray(cand), None))
        return evolve_block(rows, cols, values, momentum, key, meta=meta, zeta=zeta)

    monkeypatch.setattr(jtrainer, "evolve_element_layers_device", element_spy)
    monkeypatch.setattr(jtrainer, "evolve_block_device", block_spy)


def _feed_draws(monkeypatch, draws):
    """Replace the port's draws with ``draws``, taken in order."""
    taken = iter(draws)

    def fake(generator, n, total, *, fan_in_dense, scheme):
        want_n, want_total, cand, init = next(taken)
        assert (n, total) == (want_n, want_total)
        assert (init is None) == (scheme is None)
        return (torch.tensor(cand, device=generator.device),
                None if init is None else torch.tensor(init, device=generator.device))

    monkeypatch.setattr(ttopo, "evolution_draws", fake)
    return taken


def _capture_topologies(store):
    def hook(trainer, epoch):
        store.append([(t.rows.copy(), t.cols.copy()) for t in trainer.model.topos])
    return hook


def _run_both(monkeypatch, fields, batch_size, percentile):
    data_j = jdata.load("fashionmnist", scale=0.01)
    data_t = tdata.load("fashionmnist", scale=0.01)
    jm, tm = _models(fields)
    tc = dict(epochs=3, batch_size=batch_size, lr=0.01, zeta=0.3, seed=0)
    jt = jtrainer.SequentialTrainer(jm, data_j, jtrainer.TrainerConfig(
        **tc, pruning=jimp.PruningSchedule(tau=1, period=1, percentile=percentile)))
    tt = ttrainer.SequentialTrainer(tm, data_t, ttrainer.TrainerConfig(
        **tc, pruning=timp.PruningSchedule(tau=1, period=1, percentile=percentile)))
    assert jt.tc.device_evolution and tt.tc.device_evolution  # the default
    draws = []
    _record_reference_draws(monkeypatch, draws)
    topo_j, topo_t = [], []
    jt.epoch_end_hook = _capture_topologies(topo_j)
    tt.epoch_end_hook = _capture_topologies(topo_t)
    hj = jt.run()
    taken = _feed_draws(monkeypatch, draws)
    ht = tt.run()
    assert next(taken, None) is None  # the port took every draw the reference made
    n_layers = len(fields["layer_dims"]) - 1
    assert len(draws) == 2 * n_layers  # SET after epochs 0 and 1
    return jt, tt, hj, ht, topo_j, topo_t


@pytest.mark.parametrize("fields,batch_size,percentile", [
    pytest.param(ELEMENT, 64, 10.0, id="element"),
    pytest.param(BLOCK, 32, 5.0, id="block"),
])
def test_device_evolution_trainer_matches_reference(monkeypatch, fields, batch_size,
                                                    percentile):
    jt, tt, hj, ht, topo_j, topo_t = _run_both(monkeypatch, fields, batch_size, percentile)
    assert ht["epoch"] == hj["epoch"] == [0, 1, 2]
    assert ht["n_params"] == hj["n_params"]
    assert ht["n_params"][1] < ht["n_params"][0]  # pruning fired
    assert len(topo_t) == len(topo_j) == 3
    for epoch, (tj, t_t) in enumerate(zip(topo_j, topo_t)):
        for l, ((rj, cj), (rt, ct)) in enumerate(zip(tj, t_t)):
            np.testing.assert_array_equal(rt, rj, err_msg=f"epoch {epoch}, layer {l}")
            np.testing.assert_array_equal(ct, cj, err_msg=f"epoch {epoch}, layer {l}")
    np.testing.assert_allclose(ht["train_loss"], hj["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(ht["test_acc"], hj["test_acc"],
                               atol=1.0 / len(jt.data.y_test) + 1e-9)
    for a, b in zip(tt.model.values, jt.model.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    for a, b in zip(tt.opt_state.velocity["values"], jt.opt_state.velocity["values"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_device_evolution_is_the_default_path(monkeypatch):
    """``TrainerConfig()`` evolves on the device: the fused run goes through
    the layer loop (not host SET), the host mirror is synced only where it
    is read (pruning, the end of the run), and a seed gives the same run."""
    data = tdata.load("fashionmnist", scale=0.01)
    calls = {"device": 0, "host": 0, "sync": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(ttrainer, "evolve_element_layers_device",
                        counting("device", ttrainer.evolve_element_layers_device))
    monkeypatch.setattr(ttrainer, "evolve_element", counting("host", ttrainer.evolve_element))
    monkeypatch.setattr(ttrainer.SequentialTrainer, "_sync_topology_to_host",
                        counting("sync", ttrainer.SequentialTrainer._sync_topology_to_host))
    hist = []
    for _ in range(2):
        tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**ELEMENT), seed=0, device="cpu")
        tc = ttrainer.TrainerConfig(epochs=4, batch_size=64, lr=HP["lr"], seed=0,
                                    pruning=timp.PruningSchedule(tau=2, period=2,
                                                                 percentile=10.0))
        assert tc.device_evolution and tc.fused_epochs
        tr = ttrainer.SequentialTrainer(tm, data, tc)
        hist.append(tr.run())
        for t in tr.model.topos:  # the mirror is the device topology after the run
            assert isinstance(t, tsp.ElementTopology) and t.nnz > 0
    # SET after epochs 0-2; the mirror synced before pruning (epoch 2) and
    # at the end of the run
    assert calls == {"device": 6, "host": 0, "sync": 4}
    h = hist[0]
    assert np.isfinite(h["train_loss"]).all() and h["train_loss"][-1] < h["train_loss"][0]
    assert h["n_params"][:2] == [h["n_params"][0]] * 2 and h["n_params"][3] < h["n_params"][0]
    assert hist[1]["train_loss"] == h["train_loss"] and hist[1]["n_params"] == h["n_params"]
