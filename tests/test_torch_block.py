"""The port's block-sparse path against the JAX reference on the CPU: block
topology and init (bit-equal), the plain versions of kernels C, D and E
against the Pallas kernels in interpret mode and the dense oracles, the
autograd Function against JAX's ``value_and_grad``, the block
``mlp_forward`` and its gradients, and host block evolution and importance
pruning (equal on the same inputs and rng).

Tolerance: f32 products at rtol = atol = 1e-5, as ``tests/test_kernels.py``
holds the Pallas kernels; topology, init, evolution and pruning are exact.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import importance as jimp  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.kernels import block_sparse_matmul as jbk  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as tbk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# B, gm, gn, bm, bn, density: the reference's kernel sweep (tests/test_kernels.py)
# plus a case with most input block-rows uncovered
SHAPES = [
    (8, 2, 3, 8, 16, 0.7),
    (16, 4, 4, 16, 16, 0.4),
    (32, 3, 5, 8, 8, 0.9),
    (8, 1, 2, 16, 8, 1.0),
    (24, 5, 2, 8, 16, 0.5),
    (16, 8, 3, 8, 8, 0.1),
]


def _case(seed, B, gm, gn, bm, bn, density):
    """The same tiles, values and input from the same seed, in both packages."""
    rng = np.random.default_rng(seed)
    jmeta = jsp.BlockMeta(gm * bm, gn * bn, bm, bn)
    jtopo_ = jsp.BlockTopology.erdos_renyi(jmeta, density, rng)
    values = np.array(jtopo_.init_values(rng))
    x = rng.standard_normal((B, jmeta.in_dim)).astype(np.float32)
    dy = rng.standard_normal((B, jmeta.padded_out)).astype(np.float32)
    ttopo_ = tsp.BlockTopology(tsp.BlockMeta(gm * bm, gn * bn, bm, bn), jtopo_.rows, jtopo_.cols)
    return jmeta, jtopo_, ttopo_, values, x, dy


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fields", [
    dict(layer_dims=(64, 48, 32, 4), epsilon=6, block_m=8, block_n=8),
    dict(layer_dims=(64, 48, 32, 4), epsilon=4, block_m=16, block_n=8, init="normal"),
    dict(layer_dims=(50, 40, 10), epsilon=3, block_m=16, block_n=16),
])
def test_block_topology_and_init_bit_equal(seed, fields):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(impl="block", **fields), seed=seed)
    tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(impl="block", **fields), seed=seed, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    for l in range(jm.config.n_layers):
        jt, tt = jm.topos[l], tm.topos[l]
        assert dataclasses.asdict(tt.meta) == dataclasses.asdict(jt.meta)
        np.testing.assert_array_equal(tt.rows, jt.rows)
        np.testing.assert_array_equal(tt.cols, jt.cols)
        np.testing.assert_array_equal(tm.values[l].numpy(), np.asarray(jm.values[l]))
        assert tt.n_blocks == jt.n_blocks and tt.density == jt.density
        assert tt.n_params == jt.n_params
        np.testing.assert_array_equal(tt.to_dense(tm.values[l]).numpy(),
                                      np.asarray(jt.to_dense(jm.values[l])))
        for a, b in zip(tt.device_arrays(CPU), jt.device_arrays()):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tm.n_params == jm.n_params


@pytest.mark.parametrize("seed", range(6))
def test_ensure_coverage_bit_equal(seed):
    """Sparse enough that the draw leaves block-columns empty, so the
    coverage swap (and its row redraws) runs."""
    meta_j, meta_t = jsp.BlockMeta(48, 160, 8, 8), tsp.BlockMeta(48, 160, 8, 8)
    a = jsp.BlockTopology.erdos_renyi(meta_j, 0.12, np.random.default_rng(seed))
    b = tsp.BlockTopology.erdos_renyi(meta_t, 0.12, np.random.default_rng(seed))
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    assert np.unique(b.cols).size == meta_t.grid_n


def test_block_topology_rejects_bad_tiles():
    meta = tsp.BlockMeta(16, 16, 8, 8)
    with pytest.raises(ValueError, match="out of range"):
        tsp.BlockTopology(meta, np.array([0, 2]), np.array([0, 1]))
    with pytest.raises(ValueError, match="duplicate"):
        tsp.BlockTopology(meta, np.array([0, 0, 1]), np.array([0, 0, 1]))
    with pytest.raises(ValueError, match="coverage"):
        tsp.BlockTopology(meta, np.array([0, 1]), np.array([0, 0]))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_plain_versions_match_pallas_and_ref(shape):
    B, gm, gn, bm, bn, density = shape
    jmeta, jt, tt, values, x, dy = _case(3, *shape)
    ja, ta = jt.device_arrays(), tt.device_arrays(CPU)
    v, xt, dyt = _t(values), _t(x), _t(dy)

    y = tbk.bsmm_fwd(xt, v, ta.rows, ta.cols, ta.first_col, grid_n=gn)  # CPU: plain
    y_pallas = jax.jit(functools.partial(jbk.bsmm_fwd, grid_n=gn, block_b=8, interpret=True))(
        jnp.asarray(x), jnp.asarray(values), ja.rows, ja.cols, ja.first_col)
    y_ref = jref.bsmm_ref(jnp.asarray(x), jnp.asarray(values), ja.rows, ja.cols,
                          grid_m=gm, grid_n=gn)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(
        tref.bsmm_ref(xt, v, ta.rows, ta.cols, grid_m=gm, grid_n=gn).numpy(),
        np.asarray(y_ref), **TOL)

    dx = tbk.bsmm_dx(dyt, v, ta.rows_r, ta.cols_r, ta.first_row, ta.perm_r, grid_m=gm)
    dx_pallas = jax.jit(functools.partial(jbk.bsmm_dx, grid_m=gm, block_b=8, interpret=True))(
        jnp.asarray(dy), jnp.asarray(values), ja.rows_r, ja.cols_r, ja.first_row, ja.perm_r)
    dx_ref = jref.bsmm_dx_ref(jnp.asarray(dy), jnp.asarray(values), ja.rows, ja.cols,
                              grid_m=gm, grid_n=gn)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), **TOL)
    np.testing.assert_allclose(
        tref.bsmm_dx_ref(dyt, v, ta.rows, ta.cols, grid_m=gm, grid_n=gn).numpy(),
        np.asarray(dx_ref), **TOL)
    covered = np.unique(tt.rows)
    for r in range(gm):
        sl = slice(r * bm, (r + 1) * bm)
        if r in covered:  # Pallas never visits an uncovered row tile
            np.testing.assert_allclose(dx[:, sl].numpy(), np.asarray(dx_pallas[:, sl]), **TOL)
        else:
            assert not dx[:, sl].any(), f"uncovered block-row {r} must be exactly 0"

    dw = tbk.bsmm_dw(xt, dyt, ta.rows, ta.cols, block_m=bm, block_n=bn)
    dw_pallas = jax.jit(functools.partial(
        jbk.bsmm_dw, n_blocks=tt.n_blocks, block_m=bm, block_n=bn, block_b=8, interpret=True,
    ))(jnp.asarray(x), jnp.asarray(dy), ja.rows, ja.cols)
    dw_ref = jref.bsmm_dw_ref(jnp.asarray(x), jnp.asarray(dy), ja.rows, ja.cols,
                              block_m=bm, block_n=bn)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_pallas), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_ref), **TOL)
    np.testing.assert_allclose(
        tref.bsmm_dw_ref(xt, dyt, ta.rows, ta.cols, block_m=bm, block_n=bn).numpy(),
        np.asarray(dw_ref), **TOL)


def test_uncovered_rows_are_zero_at_full_width_layer_shape():
    """Layer 1 of the full-width CIFAR-10 block model at seed 0 (4000 ->
    1000, 32 x 8 block grid, 8 tiles) leaves 27 of its 32 input block-rows
    uncovered."""
    from repro_torch.configs.set_mlp import mlp_config

    model = tmlp.SparseMLP(mlp_config("cifar10", impl="block"), seed=0, device="cpu")
    assert [t.n_blocks for t in model.topos] == [32, 8, 32, 32]
    assert model.n_params == 1_712_946
    topo = model.topos[1]
    covered = np.unique(topo.rows)
    assert 32 - covered.size == 27
    t = topo.device_arrays(CPU)
    dx = tbk.bsmm_dx(torch.randn((3, 1024)), model.values[1], t.rows_r, t.cols_r,
                     t.first_row, t.perm_r, grid_m=32).reshape(3, 32, 128)
    assert not dx[:, np.setdiff1d(np.arange(32), covered)].any()
    assert dx[:, covered].any()


# in_dim, out_dim, bm, bn, lead: padded features, ragged batch, leading dims
OPS_CASES = [
    (24, 40, 8, 16, (8,)),
    (30, 21, 8, 8, (5,)),
    (64, 48, 16, 16, (2, 3)),
    (50, 10, 16, 16, (7,)),
]


@pytest.mark.parametrize("case", OPS_CASES)
def test_autograd_function_matches_jax_value_and_grad(case):
    in_dim, out_dim, bm, bn, lead = case
    rng = np.random.default_rng(11)
    jmeta = jsp.BlockMeta(in_dim, out_dim, bm, bn)
    jt = jsp.BlockTopology.from_epsilon(jmeta, 4, rng)
    values = np.array(jt.init_values(rng))
    x = rng.standard_normal((*lead, in_dim)).astype(np.float32)
    g = rng.standard_normal((*lead, out_dim)).astype(np.float32)  # the cotangent
    ja = jt.device_arrays()
    tmeta = tsp.BlockMeta(in_dim, out_dim, bm, bn)
    ta = tsp.BlockTopology(tmeta, jt.rows, jt.cols).device_arrays(CPU)
    covered = np.isin(np.arange(in_dim) // bm, jt.rows)  # input features some tile reads

    def jloss(fn):
        return jax.jit(jax.value_and_grad(lambda xx, vv: (fn(xx, vv) * jnp.asarray(g)).sum(),
                                          argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(values))

    want_xla = jloss(lambda xx, vv: jops.bsmm_xla(xx, vv, ja, jmeta))
    want_pallas = jloss(lambda xx, vv: jops.bsmm_pallas(xx, vv, ja, jmeta, block_b=8,
                                                         interpret=True))
    for impl in ("kernel", "xla"):
        xt = torch.tensor(x, requires_grad=True)
        vt = torch.tensor(values, requires_grad=True)
        y = tops.bsmm(xt, vt, ta, tmeta, impl=impl)
        assert y.shape == (*lead, out_dim)
        loss = (y * torch.as_tensor(g)).sum()
        loss.backward()
        gx_port = xt.grad.numpy().reshape(-1, in_dim)
        for want in (want_xla, want_pallas):
            (val, (gx, gv)) = want
            gx = np.asarray(gx).reshape(-1, in_dim)
            np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5, atol=1e-4)
            # the Pallas dX kernel never visits an uncovered input block-row
            # and leaves it unwritten; the port writes exact zeros there
            np.testing.assert_allclose(gx_port[:, covered], gx[:, covered], **TOL)
            np.testing.assert_allclose(vt.grad.numpy(), np.asarray(gv), **TOL)
        assert not gx_port[:, ~covered].any()
        np.testing.assert_allclose(gx_port, np.asarray(want_xla[1][0]).reshape(-1, in_dim),
                                   **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(
            tops.bsmm_infer(torch.as_tensor(x), torch.as_tensor(values), ta, tmeta).numpy(),
            np.asarray(jops.bsmm_infer(jnp.asarray(x), jnp.asarray(values), ja, jmeta)), **TOL)


def test_autograd_function_skips_dx_when_the_input_needs_none(monkeypatch):
    calls = []
    real = tbk.bsmm_dx
    monkeypatch.setattr(tbk, "bsmm_dx", lambda *a, **k: calls.append(1) or real(*a, **k))
    meta = tsp.BlockMeta(16, 16, 8, 8)
    t = tsp.BlockTopology(meta, np.array([0, 1]), np.array([0, 1])).device_arrays(CPU)
    v = torch.randn((2, 8, 8), requires_grad=True)
    tops.bsmm_kernel(torch.randn((4, 16)), v, t, meta).sum().backward()
    assert calls == [] and v.grad is not None
    tops.bsmm_kernel(torch.randn((4, 16), requires_grad=True), v, t, meta).sum().backward()
    assert calls == [1]
    with pytest.raises(ValueError, match="impl"):
        tops.bsmm(torch.randn((4, 16)), v, t, meta, impl="pallas")


@pytest.mark.parametrize("fields", [
    dict(layer_dims=(64, 48, 32, 4), epsilon=6, block_m=8, block_n=8),
    dict(layer_dims=(64, 48, 32, 4), epsilon=6, block_m=16, block_n=8),
    dict(layer_dims=(50, 40, 10), epsilon=4, block_m=16, block_n=16, activation="relu"),
])
def test_block_mlp_forward_and_grads_match_reference(fields):
    cfg = dict(fields, impl="block", dropout=0.0)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**cfg), seed=4)
    rng = np.random.default_rng(5)
    biases = [rng.standard_normal(b.shape).astype(np.float32) for b in jm.biases]
    jm.biases = [jnp.asarray(b) for b in biases]
    x = rng.standard_normal((9, cfg["layer_dims"][0])).astype(np.float32)
    y = rng.integers(0, cfg["layer_dims"][-1], size=9).astype(np.int32)

    def jloss(p):
        logits = jmlp.mlp_forward(p, jm.topo_arrays(), jnp.asarray(x), jm.config, train=True)
        return jmlp.cross_entropy_loss(logits, jnp.asarray(y)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jm.params())
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], biases, device="cpu")
    params = {k: tuple(t.clone().requires_grad_(True) for t in ts)
              for k, ts in tm.params().items()}
    logits = tmlp.mlp_forward(params, tm.topo_arrays(), torch.as_tensor(x), tm.config,
                              train=True)
    loss = tmlp.cross_entropy_loss(logits, torch.as_tensor(y))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    for k in ("values", "biases"):
        for got, want in zip(params[k], jg[k]):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **TOL)
    # the serving entry and the evaluation forward give the same logits
    for kwargs in (dict(infer=True), dict()):
        with torch.no_grad():
            np.testing.assert_allclose(
                tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x), tm.config,
                                 **kwargs).numpy(), np.asarray(jlogits), **TOL)


def test_block_dropout_draws_from_the_generator():
    cfg = tmlp.SparseMLPConfig(layer_dims=(64, 48, 32, 4), epsilon=6, block_m=8, block_n=8,
                               impl="block", dropout=0.5)
    tm = tmlp.SparseMLP(cfg, seed=0, device="cpu")
    x = torch.randn((6, 64))
    fwd = lambda g: tmlp.mlp_forward(tm.params(), tm.topo_arrays(), x, cfg, train=True, rng=g)
    a = fwd(torch.Generator().manual_seed(1))
    assert torch.equal(a, fwd(torch.Generator().manual_seed(1)))
    assert not torch.equal(a, fwd(torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="rng"):
        fwd(None)


def _evolution_inputs(seed, meta_args=(48, 40, 8, 8), eps=3):
    rng = np.random.default_rng(seed)
    jt = jsp.BlockTopology.from_epsilon(jsp.BlockMeta(*meta_args), eps, rng)
    values = np.array(jt.init_values(rng))
    values[rng.random(values.shape[0]) < 0.2] = 0.0  # some tiles empty
    mom = rng.standard_normal(values.shape).astype(np.float32)
    tt = tsp.BlockTopology(tsp.BlockMeta(*meta_args), jt.rows, jt.cols)
    return jt, tt, values, mom


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("protect", [True, False])
def test_evolve_block_matches_reference(seed, protect):
    jt, tt, values, mom = _evolution_inputs(seed)
    try:
        a = jtopo.evolve_block(jt, values, 0.3, np.random.default_rng(seed), momentum=mom,
                               protect_coverage=protect)
    except AssertionError:  # without protection a column may go empty
        assert not protect
        with pytest.raises(ValueError, match="coverage"):
            ttopo.evolve_block(tt, values, 0.3, np.random.default_rng(seed), momentum=mom,
                               protect_coverage=protect)
        return
    b = ttopo.evolve_block(tt, values, 0.3, np.random.default_rng(seed), momentum=mom,
                           protect_coverage=protect)
    np.testing.assert_array_equal(a.topology.rows, b.topology.rows)
    np.testing.assert_array_equal(a.topology.cols, b.topology.cols)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.momentum, b.momentum)
    assert (a.n_pruned, a.n_grown) == (b.n_pruned, b.n_grown)
    np.testing.assert_array_equal(
        ttopo.retain_valid_updates_block(mom, tt, b.topology),
        jtopo.retain_valid_updates_block(mom, jt, a.topology))
    flat = values.reshape(-1)
    np.testing.assert_array_equal(ttopo.prune_indices_by_magnitude(flat, 0.3),
                                  jtopo.prune_indices_by_magnitude(flat, 0.3))


def test_sample_vacant_both_regimes_match_reference():
    for total, occ, k in ((100, 60, 10), (10_000, 50, 40)):
        occupied = np.random.default_rng(total).choice(total, occ, replace=False)
        np.testing.assert_array_equal(
            ttopo._sample_vacant(total, occupied, k, np.random.default_rng(3)),
            jtopo._sample_vacant(total, occupied, k, np.random.default_rng(3)))


@pytest.mark.parametrize("percentile", [5.0, 30.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_importance_prune_block_matches_reference(percentile, seed):
    jt, tt, values, mom = _evolution_inputs(seed, (48, 44, 8, 8), 4)  # padded out_dim
    sched_j = jimp.PruningSchedule(tau=0, period=1, percentile=percentile)
    sched_t = timp.PruningSchedule(tau=0, period=1, percentile=percentile)
    np.testing.assert_array_equal(timp.neuron_importance_block(tt, values),
                                  jimp.neuron_importance_block(jt, values))
    a = jimp.importance_prune_block(jt, values, sched_j, momentum=mom)
    b = timp.importance_prune_block(tt, values, sched_t, momentum=mom)
    np.testing.assert_array_equal(a.topology.rows, b.topology.rows)
    np.testing.assert_array_equal(a.topology.cols, b.topology.cols)
    np.testing.assert_array_equal(a.values, b.values)
    np.testing.assert_array_equal(a.momentum, b.momentum)
    np.testing.assert_array_equal(a.pruned_neurons, b.pruned_neurons)
    assert a.removed_params == b.removed_params > 0


@pytest.mark.parametrize("seed", [0, 5])
def test_block_device_arrays_match_host_views(seed):
    _, tt, _, _ = _evolution_inputs(seed)
    host = tt.device_arrays(CPU)
    dev = ttopo.block_device_arrays(host.rows, host.cols, meta=tt.meta)
    for a, b in zip(dev, host):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
