"""The twin of ``tests/test_topology.py`` on the port's ``core.topology`` and
``core.importance`` (SET evolution, RetainValidUpdates, importance pruning:
unit and hypothesis property tests), on the CPU.

Each test checks the reference test's invariants on the port and, where the
result is a deterministic function of numpy draws from the same seed,
holds it bit-equal to the reference's (topologies, values, momentum,
masks, importances and pruned neurons).
"""
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need hypothesis (requirements-dev.txt)")
pytest.importorskip("jax")  # the reference; the card's machine has none
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import topology as jtop  # noqa: E402
from repro_torch.core.importance import (  # noqa: E402
    PruningSchedule,
    importance_prune_block,
    importance_prune_element,
    neuron_importance_block,
    neuron_importance_element,
)
from repro_torch.core.sparsity import (  # noqa: E402
    BlockMeta,
    BlockTopology,
    ElementTopology,
    density_from_epsilon,
)
from repro_torch.core.topology import (  # noqa: E402
    evolve_block,
    evolve_element,
    prune_indices_by_magnitude,
    retain_valid_updates_block,
    retain_valid_updates_element,
)


def _vals(topo, rng):
    return topo.init_values(rng, device="cpu").numpy()


def _same_topology(a, b):
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)


def _same_result(got, want):
    _same_topology(got.topology, want.topology)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    if want.momentum is None:
        assert got.momentum is None
    else:
        np.testing.assert_array_equal(got.momentum, np.asarray(want.momentum))
    assert (got.n_pruned, got.n_grown) == (want.n_pruned, want.n_grown)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def test_epsilon_density_matches_set_formula():
    assert density_from_epsilon(10, 100, 200) == pytest.approx(10 * 300 / 20000)
    assert density_from_epsilon(1000, 10, 10) == 1.0  # clamped
    for args in ((10, 100, 200), (1000, 10, 10), (20, 3072, 4000)):
        assert density_from_epsilon(*args) == jsp.density_from_epsilon(*args)


@given(st.integers(2, 12), st.integers(2, 12), st.floats(0.2, 1.0), st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_block_topology_invariants(gm, gn, density, seed):
    meta = BlockMeta(in_dim=gm * 8, out_dim=gn * 8, block_m=8, block_n=8)
    topo = BlockTopology.erdos_renyi(meta, density, np.random.default_rng(seed))
    # sorted by (col,row); unique; full column coverage — checked in _check()
    assert np.unique(topo.cols).size == meta.grid_n
    assert topo.n_blocks >= meta.grid_n
    want = jsp.BlockTopology.erdos_renyi(jsp.BlockMeta(gm * 8, gn * 8, 8, 8), density,
                                         np.random.default_rng(seed))
    _same_topology(topo, want)


@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_element_topology_nnz(seed):
    topo = ElementTopology.erdos_renyi(100, 50, epsilon=5, rng=np.random.default_rng(seed))
    assert topo.nnz == int(round(5 * 150 / 5000 * 5000))
    flat = topo.rows.astype(np.int64) * 50 + topo.cols
    assert np.unique(flat).size == topo.nnz
    _same_topology(topo, jsp.ElementTopology.erdos_renyi(100, 50, 5, np.random.default_rng(seed)))


# ---------------------------------------------------------------------------
# SET pruning criterion
# ---------------------------------------------------------------------------


def test_prune_criterion_drops_low_magnitude_tails():
    v = np.array([-3.0, -0.1, -2.0, 0.05, 1.0, 0.2, 0.0])
    drop = prune_indices_by_magnitude(v, zeta=0.34)
    # zeros always dropped; smallest positive = 0.05; largest negative = -0.1
    assert 6 in drop and 3 in drop and 1 in drop
    assert 0 not in drop and 4 not in drop
    np.testing.assert_array_equal(drop, jtop.prune_indices_by_magnitude(v, zeta=0.34))


@given(st.integers(1, 9999), st.floats(0.0, 0.9))
@settings(max_examples=30, deadline=None)
def test_evolve_element_preserves_nnz_and_uniqueness(seed, zeta):
    rng = np.random.default_rng(seed)
    topo = ElementTopology.erdos_renyi(60, 40, epsilon=8, rng=rng)
    vals = _vals(topo, rng)
    mom = np.asarray(rng.standard_normal(topo.nnz), np.float32)
    res = evolve_element(topo, vals, zeta, rng, momentum=mom)
    assert res.topology.nnz == topo.nnz  # constant sparsity (paper §problem)
    assert res.n_pruned == res.n_grown
    flat = res.topology.rows.astype(np.int64) * 40 + res.topology.cols
    assert np.unique(flat).size == flat.size
    assert res.values.shape[0] == topo.nnz
    # survivors keep their values
    kept = np.setdiff1d(np.arange(topo.nnz), prune_indices_by_magnitude(vals, zeta))
    assert np.isin(vals[kept], res.values).all()
    jrng = np.random.default_rng(seed)
    jt = jsp.ElementTopology.erdos_renyi(60, 40, epsilon=8, rng=jrng)
    jv = np.asarray(jt.init_values(jrng))
    jm = np.asarray(jrng.standard_normal(jt.nnz), np.float32)
    _same_result(res, jtop.evolve_element(jt, jv, zeta, jrng, momentum=jm))


@given(st.integers(1, 9999), st.floats(0.0, 0.6))
@settings(max_examples=25, deadline=None)
def test_evolve_block_preserves_capacity_and_coverage(seed, zeta):
    rng = np.random.default_rng(seed)
    meta = BlockMeta(in_dim=64, out_dim=48, block_m=8, block_n=8)
    topo = BlockTopology.erdos_renyi(meta, 0.5, rng)
    vals = _vals(topo, rng)
    res = evolve_block(topo, vals, zeta, rng)
    new = res.topology
    assert new.n_blocks == topo.n_blocks
    assert np.unique(new.cols).size == meta.grid_n  # coverage survives
    # regrown blocks are zero-init
    assert res.n_grown == res.n_pruned
    jrng = np.random.default_rng(seed)
    jt = jsp.BlockTopology.erdos_renyi(jsp.BlockMeta(64, 48, 8, 8), 0.5, jrng)
    jv = np.asarray(jt.init_values(jrng))
    _same_result(res, jtop.evolve_block(jt, jv, zeta, jrng))


def test_evolve_block_resets_momentum_on_new_slots():
    rng = np.random.default_rng(3)
    meta = BlockMeta(in_dim=32, out_dim=32, block_m=8, block_n=8)
    topo = BlockTopology.erdos_renyi(meta, 0.6, rng)
    vals = _vals(topo, rng)
    mom = np.ones_like(vals)
    res = evolve_block(topo, vals, 0.4, rng, momentum=mom)
    # zero-value blocks are the regrown ones; their momentum must be zero
    new_blocks = np.abs(res.values).sum(axis=(1, 2)) == 0
    assert new_blocks.any() and res.momentum[new_blocks].sum() == 0
    jrng = np.random.default_rng(3)
    jt = jsp.BlockTopology.erdos_renyi(jsp.BlockMeta(32, 32, 8, 8), 0.6, jrng)
    jv = np.asarray(jt.init_values(jrng))
    _same_result(res, jtop.evolve_block(jt, jv, 0.4, jrng, momentum=np.ones_like(jv)))


# ---------------------------------------------------------------------------
# RetainValidUpdates
# ---------------------------------------------------------------------------


@given(st.integers(1, 9999))
@settings(max_examples=25, deadline=None)
def test_retain_valid_updates_element_semantics(seed):
    rng = np.random.default_rng(seed)
    old = ElementTopology.erdos_renyi(30, 20, epsilon=6, rng=rng)
    vals = _vals(old, rng)
    new = evolve_element(old, vals, 0.3, rng).topology
    upd = rng.standard_normal(old.nnz).astype(np.float32)
    mapped = retain_valid_updates_element(upd, old, new)
    old_map = {(int(r), int(c)): upd[i] for i, (r, c) in enumerate(zip(old.rows, old.cols))}
    for i, (r, c) in enumerate(zip(new.rows, new.cols)):
        assert mapped[i] == pytest.approx(old_map.get((int(r), int(c)), 0.0))
    jold = jsp.ElementTopology(30, 20, old.rows, old.cols)
    jnew = jsp.ElementTopology(30, 20, new.rows, new.cols)
    np.testing.assert_array_equal(mapped, jtop.retain_valid_updates_element(upd, jold, jnew))


def test_retain_valid_updates_block_semantics():
    rng = np.random.default_rng(11)
    meta = BlockMeta(in_dim=40, out_dim=40, block_m=8, block_n=8)
    old = BlockTopology.erdos_renyi(meta, 0.6, rng)
    vals = _vals(old, rng)
    new = evolve_block(old, vals, 0.3, rng).topology
    upd = rng.standard_normal((old.n_blocks, 8, 8)).astype(np.float32)
    mapped = retain_valid_updates_block(upd, old, new)
    old_map = {(int(r), int(c)): upd[i] for i, (r, c) in enumerate(zip(old.rows, old.cols))}
    for i, (r, c) in enumerate(zip(new.rows, new.cols)):
        expect = old_map.get((int(r), int(c)))
        if expect is None:
            assert np.all(mapped[i] == 0)
        else:
            np.testing.assert_array_equal(mapped[i], expect)
    jmeta = jsp.BlockMeta(40, 40, 8, 8)
    want = jtop.retain_valid_updates_block(upd, jsp.BlockTopology(jmeta, old.rows, old.cols),
                                           jsp.BlockTopology(jmeta, new.rows, new.cols))
    np.testing.assert_array_equal(mapped, np.asarray(want))


# ---------------------------------------------------------------------------
# Importance pruning
# ---------------------------------------------------------------------------


def test_neuron_importance_element_is_strength():
    rows, cols = np.array([0, 1, 2, 0]), np.array([0, 0, 1, 1])
    vals = np.array([1.0, -2.0, 3.0, -0.5], np.float32)
    imp = neuron_importance_element(ElementTopology(3, 2, rows=rows, cols=cols), vals)
    np.testing.assert_allclose(imp, [3.0, 3.5])
    np.testing.assert_array_equal(
        imp, jimp.neuron_importance_element(jsp.ElementTopology(3, 2, rows, cols), vals))


def test_importance_prune_element_removes_weak_neurons():
    rng = np.random.default_rng(0)
    topo = ElementTopology.erdos_renyi(50, 30, epsilon=8, rng=rng)
    vals = _vals(topo, rng)
    sched = PruningSchedule(tau=0, period=1, percentile=25.0)
    res = importance_prune_element(topo, vals, sched)
    assert res.topology.nnz < topo.nnz
    assert res.removed_params == topo.nnz - res.topology.nnz
    # pruned neurons have no incoming connections left
    assert not np.isin(res.topology.cols, res.pruned_neurons).any()
    # surviving importance >= threshold
    live = np.unique(res.topology.cols)
    imp_old = neuron_importance_element(topo, vals)
    t = np.percentile(imp_old[np.unique(topo.cols)], 25.0)
    assert (imp_old[live] >= t).all()
    jres = jimp.importance_prune_element(
        jsp.ElementTopology(50, 30, topo.rows, topo.cols), vals,
        jimp.PruningSchedule(tau=0, period=1, percentile=25.0))
    _same_topology(res.topology, jres.topology)
    np.testing.assert_array_equal(res.values, np.asarray(jres.values))
    np.testing.assert_array_equal(res.pruned_neurons, jres.pruned_neurons)
    assert res.removed_params == jres.removed_params


def test_importance_prune_block_frees_empty_blocks_keeps_coverage():
    rng = np.random.default_rng(5)
    meta = BlockMeta(in_dim=64, out_dim=64, block_m=8, block_n=8)
    topo = BlockTopology.erdos_renyi(meta, 0.7, rng)
    vals = _vals(topo, rng)
    sched = PruningSchedule(tau=0, period=1, percentile=40.0)
    res = importance_prune_block(topo, vals, sched)
    new = res.topology
    assert new.n_blocks <= topo.n_blocks
    assert np.unique(new.cols).size == meta.grid_n
    # pruned neurons' columns are zero everywhere
    imp = neuron_importance_block(new, res.values)
    assert np.all(imp[res.pruned_neurons] == 0)
    jres = jimp.importance_prune_block(
        jsp.BlockTopology(jsp.BlockMeta(64, 64, 8, 8), topo.rows, topo.cols), vals,
        jimp.PruningSchedule(tau=0, period=1, percentile=40.0))
    _same_topology(new, jres.topology)
    np.testing.assert_array_equal(res.values, np.asarray(jres.values))
    np.testing.assert_array_equal(res.pruned_neurons, jres.pruned_neurons)
    np.testing.assert_array_equal(imp, jimp.neuron_importance_block(jres.topology, jres.values))


def test_pruning_schedule_gates():
    s = PruningSchedule(tau=200, period=10, threshold=0.1)
    assert not s.should_prune(5)
    assert not s.should_prune(205)
    assert s.should_prune(210)
    assert not s.should_prune(211)
    j = jimp.PruningSchedule(tau=200, period=10, threshold=0.1)
    assert [s.should_prune(e) for e in range(400)] == [j.should_prune(e) for e in range(400)]
