"""The port's device-resident SET evolution against the JAX reference on the
CPU, at the reference's test sizes (element 120x80, epsilon 10; block
64x48 at 8x8 tiles). Everything here is exact.

The reference draws from ``jax.random``; the port's algorithm is fed
draws (``evolution_draws``), so each comparison makes the reference's
draws from its key as ``evolve_element_device`` / ``evolve_block_device``
make them and feeds the port those. Held: the drop flags; whole
evolutions slot for slot against the reference's device function and its
numpy reference, and the port's own numpy version; the vectorised block
drop rule against the reference's sequential scan given the reference's
scores; the device-made arrays and plans against the host-made ones; and
the invariants of ``tests/test_device_evolution.py`` on the port's own
generator.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def element_case(seed=0, in_dim=120, out_dim=80, epsilon=10):
    """The reference's test case: a seeded topology, its init values and a
    seeded momentum."""
    rng = np.random.default_rng(seed)
    topo = jsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    vals = np.asarray(topo.init_values(rng))
    mom = rng.standard_normal(topo.nnz).astype(np.float32)
    return topo, vals, mom


def jax_element_draws(key, nnz, in_dim, out_dim, scheme="he_uniform"):
    """The draws ``evolve_element_device`` makes from ``key``."""
    k_grow, k_init = jax.random.split(key)
    cand = jax.random.randint(k_grow, (2 * nnz,), 0, in_dim * out_dim, dtype=jnp.int32)
    init = jtopo._init_device(k_init, (nnz,), fan_in_dense=in_dim, scheme=scheme)
    return np.asarray(cand), np.asarray(init)


def jax_block_draws(key, nb, meta):
    """The candidates ``evolve_block_device`` draws from ``key``."""
    k_grow, _ = jax.random.split(key)
    return np.asarray(jax.random.randint(k_grow, (2 * nb,), 0, meta.total_blocks,
                                         dtype=jnp.int32))


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_same(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"{what}, output {i}")


# ---------------------------------------------------------------------------
# element granularity
# ---------------------------------------------------------------------------


def _flag_cases():
    rng = np.random.default_rng(0)
    seeded = rng.standard_normal(500).astype(np.float32)
    seeded[::9] = 0.0  # exact zeros always drop
    seeded[1::11] = -0.0
    # |v| ties across signs and within a sign: one stable sort must rank them
    ties = rng.choice(np.float32([0.5, 0.25, 0.125, 0.0]), 300) * rng.choice([-1, 1], 300)
    # 90 positives at zeta 0.7: f32 tail floor(0.7f * 90) = 63, f64 int(0.7 * 90) = 62
    boundary = np.concatenate([rng.uniform(0.1, 1, 90), -rng.uniform(0.1, 1, 180)])
    return [
        pytest.param(seeded, 0.3, id="seeded-zeros"),
        pytest.param(ties.astype(np.float32), 0.3, id="ties"),
        pytest.param(ties.astype(np.float32), 0.7, id="ties-wide"),
        pytest.param(rng.permutation(boundary).astype(np.float32), 0.7, id="f32-f64-boundary"),
        pytest.param(rng.permutation(boundary).astype(np.float32), 0.35, id="f32-f64-boundary-neg"),
        pytest.param(seeded, 0.0, id="zeta-0"),
    ]


@pytest.mark.parametrize("v,zeta", _flag_cases())
def test_drop_flags_match_reference(v, zeta):
    want = np.asarray(jtopo._element_drop_flags(jnp.asarray(v), zeta))
    got = ttopo._element_drop_flags(_t(v), zeta).numpy()
    np.testing.assert_array_equal(got, want)
    n_pos, n_neg = int((v > 0).sum()), int((v < 0).sum())
    k = [int(np.floor(np.float32(zeta) * np.float32(n))) for n in (n_pos, n_neg)]
    assert got.sum() == (v == 0).sum() + sum(k)
    if zeta in (0.7, 0.35) and len(v) == 270:  # the f32 tail, one past the host path's
        assert k[0 if zeta == 0.7 else 1] == int(zeta * (n_pos if zeta == 0.7 else n_neg)) + 1


@pytest.mark.parametrize("seed,zeta", [(0, 0.25), (1, 0.3), (2, 0.0), (3, 0.5)])
def test_element_device_fed_jax_draws_matches_reference(seed, zeta):
    """The reference's grid: the port fed the draws of the reference's key
    equals ``evolve_element_device`` and ``evolve_element_device_reference``
    on that key, and the port's numpy version, slot for slot."""
    topo, vals, mom = element_case(seed)
    key = jax.random.PRNGKey(100 + seed)
    dims = dict(in_dim=topo.in_dim, out_dim=topo.out_dim, zeta=zeta)
    cand, init = jax_element_draws(key, topo.nnz, topo.in_dim, topo.out_dim)
    want = jtopo.evolve_element_device(jnp.asarray(topo.rows), jnp.asarray(topo.cols),
                                       jnp.asarray(vals), jnp.asarray(mom), key, **dims)
    _assert_same(jtopo.evolve_element_device_reference(topo.rows, topo.cols, vals, mom, key,
                                                       **dims), want, "jax's two")
    got = ttopo.evolve_element_device(_t(topo.rows), _t(topo.cols), _t(vals), _t(mom), _t(cand),
                                      _t(init), **dims)
    _assert_same(got, want, "the port's device function")
    _assert_same(ttopo.evolve_element_device_reference(topo.rows, topo.cols, vals, mom, cand,
                                                       init, **dims), want,
                 "the port's numpy version")


@pytest.mark.parametrize("scheme", ["he_uniform", "normal"])
def test_element_device_small_total_duplicates_occupied_and_fallback(scheme):
    """A 12x9 layer at 80% density: the candidates repeat, many land on
    occupied positions, and the valid supply runs out, so some dropped
    slots keep their old position (the fallback) — the dense output
    layer's case. Held to the reference's numpy oracle, which draws its
    init values outside jit as this test does; the jitted
    ``evolve_element_device`` computes the normal scheme's ``* 0.05``
    inside its program, where XLA may round it otherwise, so its values
    are held to it for he_uniform only."""
    in_dim, out_dim = 12, 9
    rng = np.random.default_rng(5)
    flat = rng.choice(in_dim * out_dim, 86, replace=False)
    topo = jsp.ElementTopology(in_dim, out_dim, flat // out_dim, flat % out_dim)
    vals = rng.standard_normal(topo.nnz).astype(np.float32)
    mom = rng.standard_normal(topo.nnz).astype(np.float32)
    key = jax.random.PRNGKey(7)
    dims = dict(in_dim=in_dim, out_dim=out_dim, zeta=0.5)
    cand, init = jax_element_draws(key, topo.nnz, in_dim, out_dim, scheme)
    old = set((topo.rows.astype(np.int64) * out_dim + topo.cols).tolist())
    assert len(np.unique(cand)) < cand.size  # duplicates
    assert any(int(c) in old for c in cand)  # occupied
    valid = {int(c) for c in cand} - old
    want = jtopo.evolve_element_device_reference(topo.rows, topo.cols, vals, mom, key,
                                                 init_scheme=scheme, **dims)
    jitted = jtopo.evolve_element_device(jnp.asarray(topo.rows), jnp.asarray(topo.cols),
                                         jnp.asarray(vals), jnp.asarray(mom), key,
                                         init_scheme=scheme, **dims)
    _assert_same(want[:2] + want[3:], jitted[:2] + jitted[3:], "jax's two")
    if scheme == "he_uniform":
        _assert_same(want[2:3], jitted[2:3], "jax's two")
    assert len(valid) < int(want[4])  # the fallback: fewer vacancies drawn than drops
    got = ttopo.evolve_element_device(_t(topo.rows), _t(topo.cols), _t(vals), _t(mom), _t(cand),
                                      _t(init), **dims)
    _assert_same(got, want, "the port's device function")
    _assert_same(ttopo.evolve_element_device_reference(topo.rows, topo.cols, vals, mom, cand,
                                                       init, **dims), want,
                 "the port's numpy version")
    # a fallback slot keeps an old position with a fresh value and momentum 0
    new = {(int(r), int(c)): (v, m) for r, c, v, m in zip(*(g.numpy() for g in got[:4]))}
    kept_old = [p for p in new if p[0] * out_dim + p[1] in old and new[p][1] == 0]
    assert kept_old


def test_dense_layer_keeps_its_positions_and_column_lengths():
    """The output layer is dense (every position taken): every dropped slot
    falls back to its own position, so the topology, its column lengths and
    kernel A's route on it stay as they were."""
    in_dim, out_dim = 40, 10
    flat = np.arange(in_dim * out_dim)
    topo = tsp.ElementTopology(in_dim, out_dim, flat // out_dim, flat % out_dim)
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(topo.nnz).astype(np.float32)
    mom = rng.standard_normal(topo.nnz).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    arrays = topo.device_arrays(torch.device("cpu"))
    (new,), (v,), (m,), pruned = ttopo.evolve_element_layers_device(
        [arrays], [_t(vals)], [_t(mom)], gen, layer_dims=(in_dim, out_dim), zeta=0.3)
    k = sum(int(np.floor(np.float32(0.3) * np.float32(n)))
            for n in ((vals > 0).sum(), (vals < 0).sum()))
    assert int(pruned[0]) == k
    np.testing.assert_array_equal(new.rows.numpy(), topo.rows)
    np.testing.assert_array_equal(new.cols.numpy(), topo.cols)
    dropped = (v.numpy() != vals)
    assert dropped.sum() == int(pruned[0]) and (m.numpy()[dropped] == 0).all()
    assert tsp.route_hints(new, in_dim, out_dim) == tsp.route_hints(arrays, in_dim, out_dim)
    assert tsp.coo_route(tsp.route_hints(new, in_dim, out_dim)[0]) == tsp.COO_THREAD


@pytest.mark.parametrize("seed,zeta", [(0, 0.3), (5, 0.5), (9, 0.1)])
def test_element_device_invariants_on_the_ports_generator(seed, zeta):
    """The reference's invariant test, on draws from a torch.Generator."""
    topo, vals, mom = element_case(seed)
    cand, init = ttopo.evolution_draws(torch.Generator().manual_seed(seed), topo.nnz,
                                       topo.in_dim * topo.out_dim, fan_in_dense=topo.in_dim,
                                       scheme="he_uniform")
    assert cand.dtype == torch.int32 and cand.shape == (2 * topo.nnz,)
    assert int(cand.min()) >= 0 and int(cand.max()) < topo.in_dim * topo.out_dim
    limit = np.sqrt(6.0 / topo.in_dim)
    assert init.shape == (topo.nnz,) and float(init.abs().max()) <= limit
    dr, dc, dv, dm, n_pruned = (t.numpy() for t in ttopo.evolve_element_device(
        _t(topo.rows), _t(topo.cols), _t(vals), _t(mom), cand, init,
        in_dim=topo.in_dim, out_dim=topo.out_dim, zeta=zeta))
    assert dr.shape[0] == topo.nnz  # constant capacity
    flat = dr.astype(np.int64) * topo.out_dim + dc
    assert np.unique(flat).size == flat.size  # unique positions
    skey = dc.astype(np.int64) * topo.in_dim + dr
    assert (np.diff(skey) > 0).all()  # canonical (col, row) order
    assert (0 <= dr).all() and (dr < topo.in_dim).all()
    assert (0 <= dc).all() and (dc < topo.out_dim).all()
    old = {(int(r), int(c)) for r, c in zip(topo.rows, topo.cols)}
    grown = np.array([(int(r), int(c)) not in old for r, c in zip(dr, dc)])
    assert dm[grown].sum() == 0  # momentum reset on regrown slots
    assert grown.sum() <= int(n_pruned)
    assert grown.sum() > 0 or zeta == 0


# ---------------------------------------------------------------------------
# block granularity
# ---------------------------------------------------------------------------


def block_case(seed, density=0.5):
    rng = np.random.default_rng(seed)
    meta = jsp.BlockMeta(in_dim=64, out_dim=48, block_m=8, block_n=8)
    topo = jsp.BlockTopology.erdos_renyi(meta, density, rng)
    vals = np.asarray(topo.init_values(rng))
    return meta, topo, vals, rng


def _tmeta(meta):
    return tsp.BlockMeta(meta.in_dim, meta.out_dim, meta.block_m, meta.block_n)


def _reference_dropped(topo, meta, out):
    """The blocks the reference's scan dropped, read from its output: a
    dropped block's position is gone or, where the regrowth fell back to it,
    its momentum (all ones before) is 0."""
    new = {(int(r), int(c)): float(np.asarray(m).max())
           for r, c, m in zip(np.asarray(out[0]), np.asarray(out[1]), np.asarray(out[3]))}
    return np.array([new.get((int(r), int(c)), 0.0) == 0.0
                     for r, c in zip(topo.rows, topo.cols)])


@pytest.mark.parametrize("seed,zeta,levels", [
    (0, 0.3, None), (3, 0.5, None), (5, 0.1, None),
    (1, 0.5, 3),    # tiles of 3 constant levels: ties in score keep slot order
    (2, 0.9, 2),    # k past the droppable blocks: coverage stops the scan
    (4, 0.7, 1),    # every score equal
])
def test_block_drop_rule_matches_the_scan(seed, zeta, levels):
    """The vectorised rule, given the reference's scores, drops exactly the
    blocks the reference's scan drops; with ``levels`` each tile is one
    constant of that many levels, so its mean |w| is exact and scores tie."""
    meta, topo, vals, rng = block_case(seed, density=0.3 if levels == 2 else 0.5)
    if levels is not None:
        tile = rng.choice(np.float32([0.25, -0.5, 0.125][:levels]), topo.n_blocks)
        vals = np.broadcast_to(tile[:, None, None], vals.shape).astype(np.float32).copy()
    mom = np.ones_like(vals)
    scores = np.asarray(jnp.abs(jnp.asarray(vals)).mean(axis=(1, 2)))
    k = int(zeta * topo.n_blocks)
    drop, n_drop = ttopo._block_drop_flags(_t(scores), _t(topo.cols), k)
    out = jtopo.evolve_block_device(jnp.asarray(topo.rows), jnp.asarray(topo.cols),
                                    jnp.asarray(vals), jnp.asarray(mom), jax.random.PRNGKey(seed),
                                    meta=meta, zeta=zeta)
    np.testing.assert_array_equal(drop.numpy(), _reference_dropped(topo, meta, out))
    assert int(n_drop) == int(out[4]) == int(drop.sum())
    if levels == 2:
        assert int(n_drop) < k  # coverage held some blocks back
    # the port's numpy version's scan, given the same scores, agrees
    ref = ttopo.evolve_block_device_reference(
        topo.rows, topo.cols, vals, mom, jax_block_draws(jax.random.PRNGKey(seed),
                                                         topo.n_blocks, meta),
        meta=_tmeta(meta), zeta=zeta, scores=scores)
    assert ref[4] == int(n_drop)


@pytest.mark.parametrize("seed,zeta", [(0, 0.3), (3, 0.5), (5, 0.1), (7, 0.0)])
def test_block_device_fed_jax_draws_matches_reference(seed, zeta):
    """``evolve_block_device`` fed the candidates of the reference's key
    equals the reference's on that key, slot for slot, and so does the
    port's numpy version; the scores agree to rtol 1e-6."""
    meta, topo, vals, rng = block_case(seed)
    mom = rng.standard_normal(vals.shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    cand = jax_block_draws(key, topo.n_blocks, meta)
    want = jtopo.evolve_block_device(jnp.asarray(topo.rows), jnp.asarray(topo.cols),
                                     jnp.asarray(vals), jnp.asarray(mom), key, meta=meta,
                                     zeta=zeta)
    tmeta = _tmeta(meta)
    got = ttopo.evolve_block_device(_t(topo.rows), _t(topo.cols), _t(vals), _t(mom), _t(cand),
                                    meta=tmeta, zeta=zeta)
    _assert_same(got, want, "the port's device function")
    _assert_same(ttopo.evolve_block_device_reference(topo.rows, topo.cols, vals, mom, cand,
                                                     meta=tmeta, zeta=zeta), want,
                 "the port's numpy version")
    np.testing.assert_allclose(_t(vals).abs().mean(dim=(1, 2)).numpy(),
                               np.asarray(jnp.abs(jnp.asarray(vals)).mean(axis=(1, 2))),
                               rtol=1e-6)


@pytest.mark.parametrize("seed,zeta", [(0, 0.3), (3, 0.5), (5, 0.1)])
def test_block_device_invariants_on_the_ports_generator(seed, zeta):
    meta, topo, vals, rng = block_case(seed)
    mom = np.ones_like(vals)
    tmeta = _tmeta(meta)
    cand, init = ttopo.evolution_draws(torch.Generator().manual_seed(seed), topo.n_blocks,
                                       tmeta.total_blocks, fan_in_dense=64, scheme=None)
    assert init is None
    br, bc, bv, bm, n_pruned = (t.numpy() for t in ttopo.evolve_block_device(
        _t(topo.rows), _t(topo.cols), _t(vals), _t(mom), cand, meta=tmeta, zeta=zeta))
    assert br.shape[0] == topo.n_blocks  # capacity
    flat = br.astype(np.int64) * tmeta.grid_n + bc
    assert np.unique(flat).size == flat.size  # unique
    assert np.unique(bc).size == tmeta.grid_n  # coverage survives pruning
    skey = bc.astype(np.int64) * tmeta.grid_m + br
    assert (np.diff(skey) > 0).all()  # canonical order
    grown = np.abs(bv).sum(axis=(1, 2)) == 0
    assert bm[grown].sum() == 0  # regrown blocks: zero-init, zero momentum
    assert 0 < int(n_pruned) <= int(zeta * topo.n_blocks)
    tsp.BlockTopology(tmeta, br, bc)  # the host mirror accepts it


def test_block_layers_device_registers_checked_arrays():
    """The layer loop returns the arrays ``block_device_arrays`` makes, and
    registers them as checked for kernels C, D and E."""
    from repro_torch.kernels import block_sparse_matmul as bsm

    meta, topo, vals, _ = block_case(1)
    tmeta = _tmeta(meta)
    host = tsp.BlockTopology(tmeta, topo.rows, topo.cols)
    arrays = host.device_arrays(torch.device("cpu"))
    (new,), _, _, pruned = ttopo.evolve_block_layers_device(
        [arrays], [_t(vals)], [torch.zeros(vals.shape)], torch.Generator().manual_seed(0),
        metas=[tmeta], zeta=0.3)
    want = ttopo.block_device_arrays(new.rows, new.cols, meta=tmeta)
    for a, b in zip(new, want):
        assert torch.equal(a, b)
    grid = (tmeta.grid_m, tmeta.grid_n)
    for what, g, ts in (("fwd", grid, (new.rows, new.cols)), ("dw", grid, (new.rows, new.cols)),
                        ("dx", grid + (host.n_blocks,), (new.rows_r, new.cols_r, new.perm_r))):
        key = (what, g) + tuple(id(t) for t in ts)
        assert key in bsm._CHECKED, what
    assert pruned.shape == (1,) and int(pruned[0]) > 0


# ---------------------------------------------------------------------------
# device arrays and the kernels' plans, made on the device
# ---------------------------------------------------------------------------


def _element_topologies():
    rng = np.random.default_rng(11)
    er = jsp.ElementTopology.erdos_renyi(120, 80, 10, rng)
    keep = er.cols % 4 != 1  # emptied columns, as importance pruning leaves them
    flat = rng.choice(60 * 7, 300, replace=False)  # long columns: several runs each
    dense = np.arange(40 * 10)
    return [
        pytest.param(120, 80, er.rows, er.cols, id="erdos-renyi"),
        pytest.param(120, 80, er.rows[keep], er.cols[keep], id="emptied-columns"),
        pytest.param(60, 7, flat // 7, flat % 7, id="long-columns"),
        pytest.param(40, 10, dense // 10, dense % 10, id="dense"),
    ]


@pytest.mark.parametrize("in_dim,out_dim,rows,cols", _element_topologies())
def test_element_device_arrays_and_plans_match_host(in_dim, out_dim, rows, cols):
    """``element_device_arrays`` on CPU tensors equals the reference's and
    the port's host-made ``device_arrays``; its registered offsets equal
    ``col_ptr()``/``row_ptr()`` (end = nnz, known without a read) with the
    route hint it was given; F's device plan, padding stripped, is exactly
    ``dw_runs``; ``rows`` is trusted for F."""
    host = tsp.ElementTopology(in_dim, out_dim, rows, cols)
    jhost = jsp.ElementTopology(in_dim, out_dim, rows, cols)
    made = host.device_arrays(torch.device("cpu"))
    hint = (1234, 56)
    dev = ttopo.element_device_arrays(_t(host.rows), _t(host.cols), in_dim=in_dim,
                                      out_dim=out_dim, longest=hint)
    jdev = jtopo.element_device_arrays(jnp.asarray(host.rows), jnp.asarray(host.cols),
                                       in_dim=in_dim, out_dim=out_dim)
    for a, b, c in zip(dev, made, jdev):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for a, c in zip(dev, jhost.device_arrays()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    col_ptr, row_ptr = tsp.registered_offsets(dev.cols), tsp.registered_offsets(dev.rows_r)
    np.testing.assert_array_equal(col_ptr.numpy(), host.col_ptr())
    np.testing.assert_array_equal(row_ptr.numpy(), host.row_ptr())
    assert tsp.route_hints(dev, in_dim, out_dim) == hint
    for ptr in (col_ptr, row_ptr):
        assert tsp._LONGEST[id(ptr)][2] == host.nnz  # the end, for _check_seg_ptr
        tsp._check_seg_ptr(ptr, host.nnz)
    assert tsp._recall(tsp._TRUSTED_INDICES, dev.rows) == in_dim
    plan = tsp.dw_plan(dev.rows, dev.cols, out_dim)  # the registered one: no device work
    runs, n_slot_runs = tsp.dw_runs(host.rows, host.col_ptr())
    cap = tsp.dw_runs_capacity(host.nnz, out_dim)
    assert plan.n_slot_runs == cap >= n_slot_runs and plan.n_cols == out_dim
    got = plan.runs.numpy()
    assert got.dtype == np.int32 and got.shape == (cap + out_dim, 3)
    np.testing.assert_array_equal(got[:n_slot_runs], runs[:n_slot_runs])
    np.testing.assert_array_equal(got[n_slot_runs:cap], np.tile([-1, 0, 0], (cap - n_slot_runs, 1)))
    np.testing.assert_array_equal(got[cap:], runs[n_slot_runs:])


def test_element_device_arrays_hint_defaults_to_the_mean():
    rng = np.random.default_rng(2)
    host = tsp.ElementTopology.erdos_renyi(120, 80, 10, rng)
    dev = ttopo.element_device_arrays(_t(host.rows), _t(host.cols), in_dim=120, out_dim=80)
    assert tsp.route_hints(dev, 120, 80) == (-(-host.nnz // 80), -(-host.nnz // 120))


def test_element_layers_device_chains_layers_on_one_stream():
    """The layer loop equals each layer evolved alone on the same draws,
    taken from one generator in layer order; A's route hint is carried from
    the old arrays; ``probe`` is refused."""
    rng = np.random.default_rng(4)
    dims = (50, 40, 30, 10)
    topos = [tsp.ElementTopology.erdos_renyi(a, b, 8, rng) for a, b in zip(dims, dims[1:])]
    arrays = [t.device_arrays(torch.device("cpu")) for t in topos]
    vals = [_t(rng.standard_normal(t.nnz).astype(np.float32)) for t in topos]
    mom = [_t(rng.standard_normal(t.nnz).astype(np.float32)) for t in topos]
    new, nv, nm, pruned = ttopo.evolve_element_layers_device(
        arrays, vals, mom, torch.Generator().manual_seed(9), layer_dims=dims, zeta=0.3,
        init_scheme="normal")
    gen = torch.Generator().manual_seed(9)
    for l, t in enumerate(topos):
        cand, init = ttopo.evolution_draws(gen, t.nnz, dims[l] * dims[l + 1],
                                           fan_in_dense=dims[l], scheme="normal")
        want = ttopo.evolve_element_device(arrays[l].rows, arrays[l].cols, vals[l], mom[l],
                                           cand, init, in_dim=dims[l], out_dim=dims[l + 1],
                                           zeta=0.3)
        for a, b in zip((new[l].rows, new[l].cols, nv[l], nm[l], pruned[l]), want):
            assert torch.equal(a, b.to(a.dtype))
        assert tsp.route_hints(new[l], dims[l], dims[l + 1]) == tsp.route_hints(
            arrays[l], dims[l], dims[l + 1])
    assert pruned.shape == (3,) and pruned.dtype == torch.int64
    with pytest.raises(NotImplementedError, match="probes"):
        ttopo.evolve_element_layers_device(arrays, vals, mom, gen, layer_dims=dims, zeta=0.3,
                                           probe=True)


def test_flat_positions_must_fit_int32():
    with pytest.raises(ValueError, match="2\\*\\*31"):
        ttopo.element_device_arrays(torch.zeros(1, dtype=torch.int32),
                                    torch.zeros(1, dtype=torch.int32),
                                    in_dim=1 << 16, out_dim=1 << 15)
