"""The port's async parameter server (``repro_torch.core.wasap_ps``), the
paper's literal Algorithm 1 protocol, on the CPU.

The reference's four async-PS tests (``tests/test_wasap.py``) are the spec
and run on the port. The server's update (``_apply``: RetainValidUpdates,
weight decay, momentum, the staleness discount), numpy in both packages,
is held to the reference's on fixed gradients, fresh and stale, at rtol
1e-6. The kernels' plan registries, which the worker threads fill as they
make device arrays, are held consistent under many threads, and a weakref
callback may not remove an entry made since for another tensor.
"""
import dataclasses
import queue as queue_mod
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none

from repro.core import wasap_ps as jps  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core.wasap_ps import AsyncPSConfig, AsyncParameterServer  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.train.trainer import evaluate  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_model_and_data(seed=0, dropout=0.1):
    data = tdata.load("fashionmnist", scale=0.02, seed=seed)
    cfg = tmlp.SparseMLPConfig(
        layer_dims=(data.n_features, 64, 32, data.n_classes),
        epsilon=16, activation="all_relu", alpha=0.6, dropout=dropout, impl="element",
    )
    return tmlp.SparseMLP(cfg, seed=seed, device="cpu"), data


# ---------------------------------------------------------------------------
# the reference's async-PS tests
# ---------------------------------------------------------------------------


def test_async_ps_trains_and_filters_stale_updates():
    # 10-class image clone: chance accuracy = 0.1, so learning is unambiguous
    model, data = make_model_and_data(seed=2, dropout=0.0)
    cfg = AsyncPSConfig(
        n_workers=3, epochs=5, lr=0.01, zeta=0.3, batch_size=16, seed=2,
        staleness_discount=0.5,
    )
    ps = AsyncParameterServer(model, data, cfg)
    stats = ps.run()
    assert stats["updates"] == cfg.epochs * ps.steps_per_epoch
    assert stats["evolutions"] == cfg.epochs - 1
    acc1 = evaluate(model, data.x_test, data.y_test)
    assert np.isfinite(acc1)
    assert acc1 > 0.5  # far above 10-class chance despite async staleness
    # stale gradients against evolved topologies were filtered (Alg.1 l.14)
    assert stats["stale_entries_dropped"] > 0


def test_async_ps_straggler_does_not_block_progress():
    model, data = make_model_and_data(seed=3)
    cfg = AsyncPSConfig(
        n_workers=3, epochs=2, lr=0.03, zeta=0.3, batch_size=16, seed=3,
        straggler_delay=0.05, staleness_discount=0.5,
    )
    ps = AsyncParameterServer(model, data, cfg)
    stats = ps.run()
    # all scheduled updates applied even with a deliberately slow worker
    assert stats["updates"] == cfg.epochs * ps.steps_per_epoch


def test_async_ps_full_queue_retries_same_gradient():
    """A full queue must not discard the computed gradient: the worker
    retries the push for the SAME gradient instead of advancing to the next
    batch. With the queue kept full, the worker computes exactly one
    gradient no matter how long it runs."""
    model, data = make_model_and_data(seed=5)
    cfg = AsyncPSConfig(n_workers=1, epochs=1, lr=0.01, batch_size=16, seed=5)
    ps = AsyncParameterServer(model, data, cfg)
    ps.grad_queue = queue_mod.Queue(maxsize=1)
    ps.grad_queue.put("sentinel")  # full forever — the PS never drains it

    n_grads = [0]
    inner = ps._grad_fn

    def counting_grad_fn(*args, **kw):
        n_grads[0] += 1
        return inner(*args, **kw)

    ps._grad_fn = counting_grad_fn
    worker = threading.Thread(target=ps._worker_loop, args=(0,), daemon=True)
    worker.start()
    deadline = time.time() + 10.0
    while time.time() < deadline and ps.stats["queue_full_retries"] < 2:
        time.sleep(0.05)
    assert ps.stats["queue_full_retries"] >= 2, "worker never hit the full queue"
    ps.stop_flag.set()
    worker.join(timeout=15.0)
    assert not worker.is_alive()
    # the one computed gradient was retried, never discarded-and-recomputed
    assert n_grads[0] == 1
    assert ps.stats["grads_dropped"] == 1  # accounted at shutdown


def test_async_ps_clean_shutdown_drops_nothing():
    """With no fault injected, a run to completion loses no work, and the
    counters are surfaced as per-epoch history."""
    model, data = make_model_and_data(seed=7)
    cfg = AsyncPSConfig(
        n_workers=2, epochs=2, lr=0.01, batch_size=16, seed=7, evolve=False,
    )
    ps = AsyncParameterServer(model, data, cfg)
    stats = ps.run()
    assert stats["updates"] == cfg.epochs * ps.steps_per_epoch
    assert stats["grads_dropped"] == 0
    assert stats["stale_entries_dropped"] == 0
    hist = stats["history"]
    for key in ("epoch", "updates", "queue_full_retries", "grads_dropped",
                "stale_entries_dropped"):
        assert key in hist
    # final snapshot (taken after workers exit) matches the totals
    assert hist["epoch"][-1] == cfg.epochs
    assert hist["updates"][-1] == stats["updates"]
    assert hist["grads_dropped"][-1] == 0
    assert hist["stale_entries_dropped"][-1] == 0


def test_a_failing_worker_stops_the_run_and_raises():
    """A worker whose gradient raises (a kernel's error on the card) ends
    the run with that error, instead of leaving the server waiting."""
    model, data = make_model_and_data(seed=7)
    ps = AsyncParameterServer(model, data, AsyncPSConfig(n_workers=2, epochs=1, batch_size=16))

    def broken(*args, **kwargs):
        raise ValueError("boom")

    ps._grad_fn = broken
    with pytest.raises(RuntimeError, match="worker failed") as err:
        ps.run()
    assert isinstance(err.value.__cause__, ValueError)


# ---------------------------------------------------------------------------
# the server's update against the reference's
# ---------------------------------------------------------------------------


def _both_servers(seed=0):
    data = tdata.load("fashionmnist", scale=0.02, seed=seed)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(
        layer_dims=(784, 64, 32, 10), epsilon=16, alpha=0.6, dropout=0.0, impl="element"),
        seed=seed)
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values],
                        [np.asarray(b) for b in jm.biases], device="cpu")
    kw = dict(n_workers=2, lr=0.02, momentum=0.9, weight_decay=2e-4, zeta=0.3, seed=seed,
              staleness_discount=0.25)
    return (jps.AsyncParameterServer(jm, data, jps.AsyncPSConfig(**kw)),
            AsyncParameterServer(tm, data, AsyncPSConfig(**kw)))


def _fixed_grads(model, rng):
    gv = [(0.1 * rng.standard_normal(t.nnz)).astype(np.float32) for t in model.topos]
    gb = [(0.1 * rng.standard_normal(int(np.asarray(b).size))).astype(np.float32)
          for b in model.biases]
    return gv, gb


def _same_state(jp, tp):
    for a, b in zip(tp.model.values, jp.model.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    for a, b in zip(tp.model.biases, jp.model.biases):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    for a, b in zip(tp.vel_values + tp.vel_biases, jp.vel_values + jp.vel_biases):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    for a, b in zip(tp.model.topos, jp.model.topos):
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
    assert tp.stats == jp.stats and tp.t_global == jp.t_global


def test_apply_matches_the_reference_on_fresh_and_stale_gradients():
    jp, tp = _both_servers()
    rng = np.random.default_rng(0)
    for staleness in (0, 3, 0):  # fresh gradients, one of them discounted
        gv, gb = _fixed_grads(tp.model, rng)
        jp._apply([g.copy() for g in gv], [g.copy() for g in gb], None, staleness)
        tp._apply(gv, gb, None, staleness)
        _same_state(jp, tp)
    old_j, old_t = list(jp.model.topos), list(tp.model.topos)
    gv, gb = _fixed_grads(tp.model, rng)  # computed against the old topology
    jp._evolve()
    tp._evolve()  # host SET on the same numpy draws
    _same_state(jp, tp)
    jp._apply([g.copy() for g in gv], [g.copy() for g in gb], old_j, 2)
    tp._apply(gv, gb, old_t, 2)
    _same_state(jp, tp)
    assert tp.stats["stale_entries_dropped"] > 0


# ---------------------------------------------------------------------------
# the kernels' plan registries under threads
# ---------------------------------------------------------------------------


def test_a_stale_weakref_callback_leaves_a_newer_entry():
    """A dead tensor's id can be taken by a newer tensor: the old tensor's
    callback must remove only its own entry."""
    for table, remember, read in (
        (tsp._SEG_PTRS, lambda t, v: tsp._remember(tsp._SEG_PTRS, t, v), lambda e: e[1]),
        (tsp._LONGEST, lambda t, v: tsp._note_offsets(t, v, 0), lambda e: e[1]),
    ):
        t1 = torch.zeros(3)
        remember(t1, 11)
        key = id(t1)
        old = table[key]  # keeps t1's weakref alive past its entry's replacement
        t2 = torch.ones(3)
        table[key] = (weakref.ref(t2), 22) + old[2:]  # the entry made since, for t2
        del t1  # t1's callback fires
        assert old[0]() is None and read(table[key]) == 22
        del table[key]
        t3 = torch.zeros(2)  # an entry still its tensor's goes when the tensor does
        remember(t3, 33)
        k3 = id(t3)
        del t3
        assert k3 not in table


def test_registries_stay_consistent_under_many_threads():
    """More threads than cores make device arrays of their own topologies
    (as the parameter server's workers do on every fetch) with a short
    switch interval: every array set finds its own offsets and F plan."""
    errors, n_threads, rounds = [], 16, 25
    cpu = torch.device("cpu")

    def work(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(rounds):
                host = tsp.ElementTopology.erdos_renyi(30, 20, 5, rng)
                arrays = host.device_arrays(cpu)
                col_ptr = tsp.registered_offsets(arrays.cols)
                row_ptr = tsp.registered_offsets(arrays.rows_r)
                runs = tsp._recall(tsp._DW_RUNS, arrays.cols)
                if (col_ptr is None or row_ptr is None or runs is None
                        or not np.array_equal(col_ptr.numpy(), host.col_ptr())
                        or not np.array_equal(row_ptr.numpy(), host.row_ptr())):
                    errors.append(seed)
                del arrays
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,)) for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
