"""The port's out-of-core XL substrate (``repro_torch.xl``) against the
reference's (``repro.xl``), on the CPU: the twin of ``tests/test_xl.py``, at
its sizes (dims 40-64-48-5, batch 16, chunk 128, a 60,000-byte budget that
makes the wide layers four shards).

* the planner: the same inputs give the same plan JSON, at the test sizes
  and at the paper's first Table-4 row at full width
  (65536-500000-500000-2, epsilon 10, batch 32, 0.6 x the in-core bytes),
  and ``PlannerError`` on the same infeasible budgets;
* the shard helpers and the extreme-scale datasets: ``array_equal``;
* the streamed forward: logits within 1e-5 of the reference's streamed
  logits (its chunked sums run in another order) and bit-equal to the
  port's in-core forward; one streamed step: values, velocity and biases
  within 1e-6 of the reference's streamed step, and bit-equal to the
  port's in-core step; ``XLTrainer``: history within rtol 1e-4 of the
  reference's, test accuracy equal;
* shard-wise evolution: the streamed thresholds and the evolved topology,
  values and momentum equal to the reference's, given the same values and
  rng state;
* streamed checkpoints written by either package restore in the other;
  a memmapped state trains and evolves, and leaves no spool behind;
* the static-buffer contract (``compile_counts``, ``allocations``);
* K8's plain versions (``xl_shard_acc``, ``xl_shard_dw``) against the
  reference's XLA passes on random shards with padded tails and segments
  that span two shards.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import xl as jxl  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.data.synthetic import Dataset, make_classification  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import xl as txl  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch.steps import make_mlp_train_step  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim.sgd import MomentumSGD  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.xl import stream as tstream  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

DIMS = (40, 64, 48, 5)
B = 16
CHUNK = 128
TIGHT_BUDGET = 60_000  # four shards on the wide layers at CHUNK=128
GENEROUS_BUDGET = 2_000_000  # every layer's index shards cached on the device
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_ATOL = 1e-6
LOSS_RTOL = 1e-4
FIELDS = ("rows", "cols", "perm_r", "values", "velocity", "bias", "bias_vel")
# the paper's first Table-4 row at full width (benchmarks/table4_extreme.py)
XL_DIMS = (65536, 500000, 500000, 2)
XL_EPSILON = 10
XL_BATCH = 32
XL_BUDGET_FRACTION = 0.6


@pytest.fixture(autouse=True, scope="module")
def _leave_no_reference_programs():
    """The reference's XL tests count its jitted programs' cache entries
    (``tests/test_xl.py::test_zero_recompiles_across_shards_layers_epochs``);
    this file's runs of the reference at other shapes would add to them
    when a test worker runs both files, so it clears JAX's caches after."""
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (and ``index_add_`` adds in slot order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_cfg(module, **kw):
    base = dict(
        layer_dims=DIMS, epsilon=8, activation="all_relu", alpha=0.6,
        dropout=0.0, impl="element", element_impl="custom", spmm_chunk=CHUNK,
    )
    base.update(kw)
    return module.SparseMLPConfig(**base)


def models(seed=0):
    """The same seeded model in both packages (the port's on the CPU)."""
    return (jmlp.SparseMLP(make_cfg(jmlp), seed=seed),
            tmlp.SparseMLP(make_cfg(tmlp), seed=seed, device="cpu"))


def plans(model, budget=TIGHT_BUDGET, **kw):
    nnz = [t.nnz for t in model.topos]
    args = (DIMS, nnz, B)
    kw = dict(budget_bytes=budget, chunk=CHUNK, min_chunk=32, **kw)
    return jxl.plan_memory_budget(*args, **kw), txl.plan_memory_budget(*args, **kw)


def states(budget=TIGHT_BUDGET, seed=0):
    jm, tm = models(seed)
    jplan, tplan = plans(tm, budget)
    return jxl.XLModelState.from_model(jm, jplan), txl.XLModelState.from_model(tm, tplan), tm


def batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], B).astype(np.int32)
    return x, y


def assert_states(j, t, **tol):
    for a, b in zip(j.layers, t.layers):
        for f in FIELDS:
            got, want = np.asarray(getattr(b, f)), np.asarray(getattr(a, f))
            if tol:
                np.testing.assert_allclose(got, want, err_msg=f, **tol)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    x, y = make_classification(
        200, DIMS[0], n_informative=8, n_redundant=8, n_classes=DIMS[-1], rng=rng,
    )
    return Dataset("t", x[:160].astype(np.float32), y[:160],
                   x[160:].astype(np.float32), y[160:], DIMS[-1])


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget,kw", [
    (TIGHT_BUDGET, {}), (45_000, {}), (GENEROUS_BUDGET, {}),
    (TIGHT_BUDGET, {"memmap_threshold_bytes": 64}),
], ids=["tight", "chunk_descent", "generous", "memmap"])
def test_plan_json_equals_reference(budget, kw):
    _, tm = models()
    jplan, tplan = plans(tm, budget, **kw)
    assert tplan.to_json() == jplan.to_json()
    assert txl.XLPlan.from_json(tplan.to_json()) == tplan
    assert tplan.peak_device_bytes <= tplan.budget_bytes


def test_full_width_plan_equals_reference():
    """The paper's first Table-4 row, unscaled: the reference's own numbers
    for these inputs, and the same JSON from both planners."""
    nnz = [tsp.erdos_renyi_nnz(XL_EPSILON, a, b) for a, b in zip(XL_DIMS, XL_DIMS[1:])]
    assert nnz == [5_655_360, 10_000_000, 1_000_000]
    in_core = txl.estimate_in_core_bytes(XL_DIMS, nnz, XL_BATCH)
    assert in_core == jxl.estimate_in_core_bytes(XL_DIMS, nnz, XL_BATCH) == 880_370_704
    budget = int(XL_BUDGET_FRACTION * in_core)
    tplan = txl.plan_memory_budget(XL_DIMS, nnz, XL_BATCH, budget)
    jplan = jxl.plan_memory_budget(XL_DIMS, nnz, XL_BATCH, budget)
    assert tplan.to_json() == jplan.to_json()
    assert (tplan.budget_bytes, tplan.peak_device_bytes) == (528_222_422, 528_161_560)
    assert (tplan.shard_capacity, tplan.chunk) == (73_728, 8_192)
    assert [lp.n_shards for lp in tplan.layers] == [77, 136, 14]


@pytest.mark.parametrize("budget,kw", [
    (1_000, {}),                      # the fixed floor alone exceeds it
    (52_000, {"min_chunk": 4096}),    # no shard of the chunk floor fits
], ids=["floor", "chunk_floor"])
def test_planner_error_on_the_same_budgets(budget, kw):
    _, tm = models()
    nnz = [t.nnz for t in tm.topos]
    args = dict(chunk=CHUNK, min_chunk=32)
    args.update(kw)
    with pytest.raises(jxl.PlannerError, match="infeasible budget") as jerr:
        jxl.plan_memory_budget(DIMS, nnz, B, budget, **args)
    with pytest.raises(txl.PlannerError, match="infeasible budget") as terr:
        txl.plan_memory_budget(DIMS, nnz, B, budget, **args)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# shard helpers and datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [32, 200, 256])
def test_shard_helpers_equal_reference(cap):
    _, tm = models()
    assert ttopo.element_shard_bounds(1000, cap) == jtopo.element_shard_bounds(1000, cap)
    for topo in tm.topos:
        args = (topo.rows, topo.cols, topo.in_dim, topo.out_dim, cap)
        np.testing.assert_array_equal(ttopo.element_shard_key_intervals(*args),
                                      jtopo.element_shard_key_intervals(*args))
        perm = ttopo.element_row_order(topo.rows, topo.cols)
        np.testing.assert_array_equal(perm, jtopo.element_row_order(topo.rows, topo.cols))
        ttopo.check_element_shards(topo.rows, topo.cols, perm, topo.in_dim, topo.out_dim, cap)
        tail = topo.cols[-(topo.nnz % cap or cap):]
        np.testing.assert_array_equal(ttopo.pad_shard(tail, cap, topo.out_dim),
                                      jtopo.pad_shard(tail, cap, topo.out_dim))
    with pytest.raises(ValueError):
        ttopo.element_shard_bounds(0, cap)
    with pytest.raises(AssertionError, match="permutation"):
        t = tm.topos[0]
        ttopo.check_element_shards(t.rows, t.cols, np.zeros(t.nnz, np.int64), t.in_dim,
                                   t.out_dim, cap)


def test_extreme_dataset_equals_reference():
    a = jdata.make_extreme_dataset(300, 512, seed=0)
    b = tdata.make_extreme_dataset(300, 512, seed=0)
    for k in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    assert (b.n_classes, b.x_train.shape) == (a.n_classes, (210, 512))


def test_streaming_extreme_dataset_batches_equal_reference():
    kw = dict(n_features=256, batch_size=8, n_informative=8, n_redundant=16, seed=3)
    ja, ta = jdata.StreamingExtremeDataset(**kw), tdata.StreamingExtremeDataset(**kw)
    for i in (0, 5, -1):
        for got, want in zip(ta.batch(i), ja.batch(i)):
            np.testing.assert_array_equal(got, want)
    for (tx, ty), (jx, jy) in zip(ta.epoch(1, 3), ja.epoch(1, 3)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    for got, want in zip(ta.test_set(2), ja.test_set(2)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the streamed forward and step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget", [TIGHT_BUDGET, GENEROUS_BUDGET], ids=["streamed", "resident"])
def test_streamed_logits(budget):
    jst, tst, tm = states(budget)
    x, _ = batch()
    ex = txl.StreamExecutor(tst, device="cpu")
    got = ex.logits(x)
    np.testing.assert_allclose(got, jxl.StreamExecutor(jst).logits(x), **LOGIT_TOL)
    with torch.no_grad():
        in_core = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x),
                                   tm.config).numpy()
    assert np.array_equal(got, in_core)
    # a ragged evaluation batch: the first rows' logits are the same bits
    assert np.array_equal(ex.logits(x[:5]), got[:5])


@pytest.mark.parametrize("budget", [TIGHT_BUDGET, GENEROUS_BUDGET], ids=["streamed", "resident"])
def test_one_streamed_step(budget):
    jst, tst, tm = states(budget)
    x, y = batch()
    step = dict(momentum=0.9, weight_decay=2e-4)
    j_loss = jxl.StreamExecutor(jst).train_step(x, y, 0.01, **step)
    t_loss = txl.StreamExecutor(tst, device="cpu").train_step(x, y, 0.01, **step)
    assert t_loss == pytest.approx(j_loss, abs=STATE_ATOL)
    assert_states(jst, tst, atol=STATE_ATOL, rtol=0)
    # the port's in-core step on the same model: the same bits
    opt = MomentumSGD(**step)
    params = tm.params()
    p2, s2, loss = make_mlp_train_step(tm.config, opt)(
        params, opt.init(params), tm.topo_arrays(), torch.as_tensor(x),
        torch.as_tensor(y).long(), torch.tensor(0.01), None)
    assert t_loss == float(loss)
    for l, layer in enumerate(tst.layers):
        assert np.array_equal(layer.values, p2["values"][l].numpy())
        assert np.array_equal(layer.velocity, s2.velocity["values"][l].numpy())
        assert np.array_equal(layer.bias, p2["biases"][l].numpy())
        assert np.array_equal(layer.bias_vel, s2.velocity["biases"][l].numpy())


def test_xl_trainer_tracks_reference(data):
    kw = dict(epochs=3, batch_size=B, lr=0.01, zeta=0.3, seed=0, evolve=False, eval_every=1)
    jm, tm = models()
    jplan, tplan = plans(tm)
    h_ref = jtrainer.XLTrainer(jm, data, jtrainer.TrainerConfig(**kw), jplan).run()
    tr = ttrainer.XLTrainer(tm, data, ttrainer.TrainerConfig(**kw), tplan)
    assert tr.device.type == "cpu"  # the model's device
    h = tr.run()
    np.testing.assert_allclose(h["train_loss"], h_ref["train_loss"], rtol=LOSS_RTOL)
    assert h["test_acc"] == h_ref["test_acc"]
    assert h["n_params"] == h_ref["n_params"]
    # the budget is below the in-core footprint, and the executor's audit
    # is within it once the port's own buffers are counted
    assert tplan.budget_bytes < txl.estimate_in_core_bytes(DIMS, [t.nnz for t in tm.topos], B)
    ex = tr.executor
    assert ex.measured_peak_bytes - ex.port_extra_bytes <= tplan.budget_bytes
    assert ex.measured_peak_bytes <= tplan.budget_bytes + ex.port_extra_bytes


# ---------------------------------------------------------------------------
# shard-wise evolution
# ---------------------------------------------------------------------------


def _trained_states():
    """Both packages' states holding the same trained values: the port's
    after one streamed step, copied into the reference's."""
    jst, tst, _ = states()
    x, y = batch(1)
    txl.StreamExecutor(tst, device="cpu").train_step(x, y, 0.05, momentum=0.9,
                                                    weight_decay=2e-4)
    for a, b in zip(jst.layers, tst.layers):
        for f in ("values", "velocity", "bias", "bias_vel"):
            getattr(a, f)[:] = getattr(b, f)
    return jst, tst


def test_streamed_thresholds_equal_reference():
    jst, tst = _trained_states()
    cap = tst.plan.shard_capacity
    for a, b in zip(jst.layers, tst.layers):
        for zeta in (0.1, 0.3):
            got = txl.streamed_sign_thresholds(b.values, cap, zeta)
            want = jxl.streamed_sign_thresholds(a.values, cap, zeta)
            for g, w in zip(got[:2], want[:2]):
                assert (g is None and w is None) or dataclasses.astuple(g) == dataclasses.astuple(w)
            assert got[2] == want[2]


def test_evolved_topology_equals_reference():
    jst, tst = _trained_states()
    t_stats = txl.evolve_model_streamed(tst, 0.3, np.random.default_rng(7))
    j_stats = jxl.evolve_model_streamed(jst, 0.3, np.random.default_rng(7))
    assert t_stats == j_stats
    assert tst.topo_version == jst.topo_version == 1
    assert_states(jst, tst)
    tst.check_invariants()


def test_evolution_invalidates_the_device_cache():
    _, tst, tm = states(GENEROUS_BUDGET)
    ex = txl.StreamExecutor(tst, device="cpu")
    x, _ = batch()
    ex.logits(x)
    assert ex._topo_cache  # populated
    txl.evolve_model_streamed(tst, 0.3, np.random.default_rng(0))
    got = ex.logits(x)
    topos = [tsp.ElementTopology(l.in_dim, l.out_dim, l.rows, l.cols) for l in tst.layers]
    m2 = tmlp.SparseMLP.from_state(tm.config, topos, [l.values for l in tst.layers],
                                   [l.bias for l in tst.layers], device="cpu")
    with torch.no_grad():
        want = tmlp.mlp_forward(m2.params(), m2.topo_arrays(), torch.as_tensor(x),
                                m2.config).numpy()
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# streamed checkpoints, across the packages
# ---------------------------------------------------------------------------


def _hook_saving(manager, epoch0_only=True):
    def hook(trainer, epoch):
        if epoch == 0 or not epoch0_only:
            trainer.save_checkpoint(manager)
    return hook


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(writer, data, tmp_path):
    """A trainer of one package saves after epoch 0 (with evolution); the
    other package's ``XLTrainer.from_checkpoint`` resumes it, with the
    state equal, and runs on in step with the writer's own resumed run."""
    kw = dict(epochs=2, batch_size=B, lr=0.01, zeta=0.3, seed=0, evolve=True, eval_every=1)
    jm, tm = models()
    jplan, tplan = plans(tm)
    mods = {"port": (ttrainer, tm, tplan, CheckpointManager),
            "reference": (jtrainer, jm, jplan, JManager)}
    w_mod, w_model, w_plan, w_mgr = mods[writer]
    r_mod, _, r_plan, r_mgr = mods["reference" if writer == "port" else "port"]
    w_tc = w_mod.TrainerConfig(**kw)
    tr = w_mod.XLTrainer(w_model, data, w_tc, w_plan)
    tr.epoch_end_hook = _hook_saving(w_mgr(str(tmp_path), async_write=False))
    h_full = tr.run()
    def cpu(mod):  # the port's trainer made from a state runs on the card unless told
        return {"device": "cpu"} if mod is ttrainer else {}

    res = r_mod.XLTrainer.from_checkpoint(r_mgr(str(tmp_path), async_write=False), data,
                                          r_mod.TrainerConfig(**kw), r_plan, **cpu(r_mod))
    own = w_mod.XLTrainer.from_checkpoint(w_mgr(str(tmp_path), async_write=False), data,
                                          w_tc, w_plan, **cpu(w_mod))
    assert res.start_epoch == own.start_epoch == 1 and res.gstep == own.gstep
    assert res.rng.bit_generator.state == own.rng.bit_generator.state
    assert_states(own.state, res.state)
    h_res, h_own = res.run(), own.run()
    assert h_own["train_loss"] == h_full["train_loss"]  # the writer resumes bit-equal
    np.testing.assert_allclose(h_res["train_loss"], h_own["train_loss"], rtol=LOSS_RTOL)
    assert h_res["test_acc"] == h_own["test_acc"]
    assert h_res["n_params"] == h_own["n_params"]


def test_port_resume_is_bit_equal(data, tmp_path):
    kw = dict(epochs=3, batch_size=B, lr=0.01, zeta=0.3, seed=0, evolve=True, eval_every=1)
    _, tm = models()
    _, tplan = plans(tm)
    tr = ttrainer.XLTrainer(tm, data, ttrainer.TrainerConfig(**kw), tplan)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tr.epoch_end_hook = _hook_saving(mgr)
    h = tr.run()
    tr2 = ttrainer.XLTrainer(txl.XLModelState.restore(mgr, tplan), data,
                             ttrainer.TrainerConfig(**kw), tplan, device="cpu")
    assert tr2.restore_checkpoint(mgr) == 10  # 10 steps an epoch
    h2 = tr2.run()
    for k in ("epoch", "train_loss", "test_acc", "n_params"):
        assert h2[k] == h[k]
    assert_states(tr.state, tr2.state)


def test_streamed_checkpoint_round_trip(tmp_path):
    _, tst, _ = states()
    tst.layers[0].velocity[:] = 0.5
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tst.save(mgr, 7)
    manifest = mgr.read_manifest(7)
    assert manifest["meta"]["kind"] == "xl_model"
    assert manifest["streamed_groups"] == [f"xl_layer{l}" for l in range(len(DIMS) - 1)]
    back = txl.XLModelState.restore(mgr, tst.plan, 7)
    assert_states(tst, back)
    x, y = batch()
    txl.StreamExecutor(back, device="cpu").train_step(x, y, 0.01, momentum=0.9,
                                                     weight_decay=2e-4)


def test_restore_refuses_out_of_range_indices(tmp_path):
    _, tst, _ = states()
    tst.layers[1].rows[3] = DIMS[1]  # one past the layer's inputs
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tst.save(mgr, 1)
    with pytest.raises(ValueError, match="xl_layer1/rows has indices outside"):
        txl.XLModelState.restore(mgr, tst.plan, 1)


# ---------------------------------------------------------------------------
# memmapped state, static buffers, refusals
# ---------------------------------------------------------------------------


def test_memmap_spooled_state_trains_evolves_and_cleans_up(tmp_path):
    _, tm = models()
    _, tplan = plans(tm, memmap_threshold_bytes=64)
    st = txl.XLModelState.from_model(tm, tplan, spool_dir=str(tmp_path))
    assert all(isinstance(l.values, np.memmap) for l in st.layers)
    ex = txl.StreamExecutor(st, device="cpu")
    x, y = batch()
    l0 = ex.train_step(x, y, 0.01, momentum=0.9, weight_decay=2e-4)
    txl.evolve_model_streamed(st, 0.3, np.random.default_rng(0))
    st.check_invariants()
    l1 = ex.train_step(x, y, 0.01, momentum=0.9, weight_decay=2e-4)
    assert np.isfinite(l0) and np.isfinite(l1)
    assert not list(tmp_path.glob("*.tmp"))  # the evolution's scratch went
    # a spool the package made itself goes with its state
    auto = txl.XLModelState.from_model(tm, tplan)
    spool = auto.spool_dir
    assert spool is not None and any(spool.iterdir())
    del auto
    gc.collect()
    assert not spool.exists()


def test_static_buffers(data):
    _, tm = models()
    _, tplan = plans(tm)
    kw = dict(epochs=2, batch_size=B, lr=0.01, zeta=0.3, seed=0, evolve=True, eval_every=1)
    tr = ttrainer.XLTrainer(tm, data, ttrainer.TrainerConfig(**kw), tplan)
    ex = tr.executor
    assert tplan.n_shards_total > len(DIMS) - 1  # genuinely multi-shard
    x, y = batch()
    ex.train_step(x, y, 0.01, momentum=0.9, weight_decay=2e-4)
    warm, allocations = txl.compile_counts(), dict(ex.allocations)
    buffers = {id(t) for t in (ex.xT, ex.acc, ex.dz, *ex.h, *ex.mask, *ex._dv)}
    tr.run()  # two epochs, an evolution and the evaluations
    assert txl.compile_counts() == warm
    assert set(allocations) <= set(warm)
    assert dict(ex.allocations) == allocations
    assert buffers == {id(t) for t in (ex.xT, ex.acc, ex.dz, *ex.h, *ex.mask, *ex._dv)}
    with pytest.raises(RuntimeError, match="allocates its device buffers once"):
        ex._alloc("late", (1,), torch.float32)


def test_refusals(data):
    _, tst, tm = states()
    ex = txl.StreamExecutor(tst, device="cpu")
    x, y = batch()
    with pytest.raises(ValueError, match="full batch"):
        ex.probe_stats(x[:5], y[:5])
    with pytest.raises(NotImplementedError, match="item 8"):
        tstream.analysis_programs()
    with pytest.raises(ValueError, match="full batch"):
        ex.train_step(x[:5], y[:5], 0.01, momentum=0.9, weight_decay=0.0)
    with pytest.raises(ValueError, match="exceeds the plan's batch"):
        ex.logits(np.zeros((B + 1, DIMS[0]), np.float32))
    plan = tst.plan
    tc = ttrainer.TrainerConfig(batch_size=B, epochs=1)
    with pytest.raises(ValueError, match="dropout"):
        ttrainer.XLTrainer(tmlp.SparseMLP(make_cfg(tmlp, dropout=0.3), device="cpu"), data,
                           tc, plan)
    with pytest.raises(ValueError, match="re-plan"):
        ttrainer.XLTrainer(tm, data, ttrainer.TrainerConfig(batch_size=8), plan)
    tr = ttrainer.XLTrainer(tst, data, tc, plan, device="cpu")
    tr.step_retries = 2
    with pytest.raises(NotImplementedError, match="item 5"):
        tr.run()


# ---------------------------------------------------------------------------
# K8: the plain versions against the reference's XLA passes
# ---------------------------------------------------------------------------


def _random_shard(rng, n_segments, src_dim, cap, n_real, lo_seg=0):
    """A canonical-order shard: ``n_real`` sorted segment ids from
    ``lo_seg`` on, random gather ids and values, the tail padded with the
    sentinel ``n_segments`` (and gather 0, value 0)."""
    seg = np.sort(rng.integers(lo_seg, n_segments, n_real)).astype(np.int32)
    gather = rng.integers(0, src_dim, n_real).astype(np.int32)
    vals = rng.standard_normal(n_real).astype(np.float32)
    return (ttopo.pad_shard(vals, cap, 0.0), ttopo.pad_shard(gather, cap, 0),
            ttopo.pad_shard(seg, cap, n_segments))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xl_shard_acc_plain_equals_reference(seed):
    """Two shards in a row into one carried buffer, the second starting in
    the segment the first ends in, and a padded tail; against the
    reference's K8 (its chunked sums run in another order). The chained
    shards give the bits of one call over their concatenation."""
    rng = np.random.default_rng(seed)
    n_seg, src_dim, batch_, cap = 37, 29, 6, 64
    a = _random_shard(rng, n_seg, src_dim, cap, cap, 0)
    b = _random_shard(rng, n_seg, src_dim, cap, 41, int(a[2][-1]))
    srcT = rng.standard_normal((src_dim, batch_)).astype(np.float32)
    acc0 = rng.standard_normal((n_seg, batch_)).astype(np.float32)
    j_acc = jnp.asarray(acc0)
    t_acc = torch.from_numpy(acc0.copy())
    for vals, gather, seg in (a, b):
        j_acc = jops.xl_shard_acc(j_acc, jnp.asarray(srcT), jnp.asarray(vals),
                                  jnp.asarray(gather), jnp.asarray(seg), n_segments=n_seg,
                                  chunk=16)
        out = tops.xl_shard_acc(t_acc, torch.from_numpy(srcT), torch.from_numpy(vals),
                                torch.from_numpy(gather), torch.from_numpy(seg),
                                n_segments=n_seg, chunk=16)
        assert out is t_acc  # in place
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), **LOGIT_TOL)
    # one call over both shards' real slots: the same bits
    cat = [np.concatenate([a[i], b[i][:41]]) for i in range(3)]
    whole = tsp.coo_matmul_T_plain(torch.from_numpy(srcT), torch.from_numpy(cat[0]),
                                   torch.from_numpy(cat[1]), torch.from_numpy(cat[2]), n_seg,
                                   acc=torch.from_numpy(acc0))
    assert torch.equal(whole, t_acc)
    # the non-donating factory leaves the carry alone
    keep = torch.from_numpy(acc0.copy())
    new = tops.make_xl_shard_acc(donate=False)(
        keep, torch.from_numpy(srcT), *(torch.from_numpy(t) for t in a), n_segments=n_seg)
    assert torch.equal(keep, torch.from_numpy(acc0)) and not torch.equal(new, keep)


@pytest.mark.parametrize("seed", [0, 1])
def test_xl_shard_dw_plain_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n_seg, src_dim, batch_, cap = 23, 31, 8, 64
    vals, rows, cols = _random_shard(rng, n_seg, src_dim, cap, 50)
    del vals
    xT = rng.standard_normal((src_dim, batch_)).astype(np.float32)
    dyT = rng.standard_normal((n_seg, batch_)).astype(np.float32)
    want = np.asarray(jops.xl_shard_dw(jnp.asarray(xT), jnp.asarray(dyT), jnp.asarray(rows),
                                       jnp.asarray(cols), chunk=16))
    got = tops.xl_shard_dw(torch.from_numpy(xT), torch.from_numpy(dyT), torch.from_numpy(rows),
                           torch.from_numpy(cols), chunk=16)
    np.testing.assert_allclose(got.numpy()[:50], want[:50], **LOGIT_TOL)
    assert (got.numpy()[50:] == 0).all()  # only the real extent is written
    assert tops.make_xl_shard_dw() is tops.xl_shard_dw
    # the window made on the host carries kernel F's runs: every real slot once
    w = tops.shard_window(torch.from_numpy(cols), n_seg, rows=torch.from_numpy(rows))
    runs = w.runs.numpy()[: w.n_runs]
    assert runs[:, 2].sum() == 50 and (runs[:, 0] >= 0).all() and (runs[:, 0] < w.n).all()


@pytest.mark.parametrize("layer_index", [1, 2])
def test_kernel_b_features_batch_pass_plain_equals_reference(layer_index):
    """Kernel B's (features, batch) entry, the stream's epilogue, on the CPU:
    the reference's Pallas ``bias_all_relu`` (interpret mode) on the
    transposed operand, bit for bit; into ``out`` and in place, with the
    branch mask; the bias alone for an output layer. G's standalone call
    writes into the buffers it is given."""
    from repro.kernels.all_relu_fused import bias_all_relu as j_bias_all_relu
    from repro_torch.kernels import all_relu_fused as taf
    from repro_torch.kernels.ref import slope_for

    rng = np.random.default_rng(layer_index)
    xT = rng.standard_normal((20, 6)).astype(np.float32)
    bias = rng.standard_normal(20).astype(np.float32)
    xT[::4, 0] = -bias[::4]  # pre-activations exactly 0
    want = np.asarray(j_bias_all_relu(jnp.asarray(xT.T), jnp.asarray(bias), alpha=0.6,
                                      layer_index=layer_index, interpret=True)).T
    x, b = torch.from_numpy(xT), torch.from_numpy(bias)
    slope = slope_for(0.6, layer_index)
    out, mask = torch.empty_like(x), torch.empty(x.shape, dtype=torch.uint8)
    y, m = taf.bias_all_relu_T(x, b, slope, out=out, mask=mask)
    assert y is out and m is mask and np.array_equal(y.numpy(), want)
    assert torch.equal(m.bool(), x + b[:, None] > 0)
    inplace = x.clone()
    taf.bias_all_relu_T(inplace, b, slope, out=inplace)
    assert np.array_equal(inplace.numpy(), want)
    assert np.array_equal(taf.bias_all_relu_T(x, b, None).numpy(), xT + bias[:, None])
    with pytest.raises(ValueError, match="needs the slope"):
        taf.bias_all_relu_T(x, b, None, mask=mask)
    dz_out, dbias_out = torch.empty_like(x), torch.empty(20)
    dz, dbias = taf.all_relu_bwd(x, mask, slope, dz_out=dz_out, dbias_out=dbias_out)
    pz, pb = taf.all_relu_bwd_plain(x, mask, slope)
    assert dz is dz_out and dbias is dbias_out
    assert torch.equal(dz, pz) and torch.equal(dbias, pb)


def test_shard_windows():
    """A shard's window from its sorted segment ids: offsets, first segment,
    width and longest segment; the padded reference operand's tail
    ignored; what does not fit refused."""
    seg = np.array([3, 3, 4, 6, 6, 6], np.int32)
    out = np.empty(7, np.int64)
    assert tops.window_offsets(seg, out) == (3, 4, 3)
    np.testing.assert_array_equal(out[:5], [0, 2, 3, 3, 6])
    with pytest.raises(ValueError):
        tops.window_offsets(np.array([5, 3], np.int32), out)
    with pytest.raises(ValueError):
        tops.window_offsets(seg, np.empty(3, np.int64))
    padded = torch.from_numpy(np.concatenate([seg, [9, 9]]).astype(np.int32))
    rows = torch.from_numpy(np.array([0, 1, 0, 0, 1, 2, 0, 0], np.int32))
    w = tops.shard_window(padded, 9, rows=rows)
    assert (w.lo, w.n, w.n_real, w.longest) == (3, 4, 6, 3)
    assert torch.equal(w.seg_ptr, torch.tensor([0, 2, 3, 3, 6]))
    assert sorted(map(tuple, w.runs[: w.n_runs].tolist())) == [(0, 0, 2), (1, 2, 1), (3, 3, 3)]
    assert torch.equal(tops._window_segments(w), torch.from_numpy(seg).long())
    with pytest.raises(ValueError, match="non-decreasing"):
        tops.shard_window(torch.tensor([4, 3, 9], dtype=torch.int32), 9)


def test_probe_stats_match_the_reference(data, tmp_path):
    """``StreamExecutor.probe_stats`` against the reference's on the same
    streamed state and batch: the device stats (saturation, pre-activation
    and dz norms) at rtol 1e-5, the host passes' value and importance stats
    equal; the weights are left as they were. Then a probed ``XLTrainer``
    epoch records one ``xl`` snapshot with the trainer's spans."""
    from repro_torch import obs
    from repro_torch.obs import probes, timeline

    jst, tst, tm = states()
    x, y = batch()
    want = jxl.StreamExecutor(jst).probe_stats(x, y)
    before = [np.array(layer.values) for layer in tst.layers]
    ex = txl.StreamExecutor(tst, device="cpu")
    n0 = probes.probe_compile_counts()["obs_padded_buffer_probe"]
    got = ex.probe_stats(x, y)
    assert probes.probe_compile_counts()["obs_padded_buffer_probe"] <= n0 + 1  # one shape
    assert len(got) == len(want) == len(DIMS) - 1
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k in ("saturation", "preact_l2", "grad_l2", "grad_zero_frac"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
            else:
                assert g[k] == w[k], k
    for b, layer in zip(before, tst.layers):
        np.testing.assert_array_equal(b, np.asarray(layer.values))
    plan = tst.plan
    tc = ttrainer.TrainerConfig(epochs=1, batch_size=plan.batch, probe=True, seed=0)
    trainer = ttrainer.XLTrainer(tm, data, tc, plan)
    with obs.trace_to(str(tmp_path / "t.jsonl")), \
            timeline.timeline_to(tmp_path / "tl.jsonl", run_id="xl"):
        trainer.run()
    snaps = timeline.snapshots(timeline.read_timeline(tmp_path / "tl.jsonl"), "xl")
    assert len(snaps) == 1 and len(snaps[0]["layers"]) == len(DIMS) - 1
    spans = {e["name"] for e in obs.read_events(str(tmp_path / "t.jsonl")) if e["ev"] == "span"}
    assert {"train.run", "train.epoch", "train.segment", "xl.train_step", "xl.forward",
            "xl.probe"} <= spans

