"""Kernel F's run plan and its plain backward, on the CPU.

Kernel F (``csrc/coo_dw.cu``) gives one warp a run of at most ``DW_RUN``
consecutive slots of one column, and computes the backward of kernel A's
training epilogue (dz and the bias's gradient, kernel G's work) in the same
pass. Here: the plan (``core.sparsity.dw_runs``/``dw_plan``) on the
full-width CIFAR-10 element model's four layers (3072-4000-1000-4000-10,
epsilon 20, seed 0) as made, after a SET step, and after an importance
prune whose cascade empties columns, then on edge cases; and the plain
backward of ``_EspmmT`` in its three epilogue modes (no bias, the bias
alone, bias + All-ReLU of either slope sign) against the reference's
``coo_dw`` and ``jax.grad`` of ``all_relu(z + b)``, with pre-activations
exactly 0.

Tolerance: the plan is integers, held exactly. Gradients at rtol 1e-4, atol
1e-5, the reference's own (``tests/test_espmm_grad.py``): both sides sum in
f32, in other orders. The kernel itself is held against this plain version
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core.all_relu import all_relu as j_all_relu  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.set_mlp import mlp_config  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.kernels import all_relu_fused, ops as tops  # noqa: E402
from repro_torch.kernels.ref import slope_for  # noqa: E402
from repro_torch.models.mlp import SparseMLP  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
R = tsp.DW_RUN


@pytest.fixture(scope="module")
def full_width_topologies():
    """The full-width element model's four topologies: as made, after one
    SET step (zeta 0.3), and after an importance prune of the hidden layers
    at the 30th percentile with the element cascade (connections out of a
    pruned neuron die in the next layer), as the trainer runs them."""
    model = SparseMLP(mlp_config("cifar10"), seed=0, device=CPU)
    made = list(model.topos)
    rng = np.random.default_rng(1)
    evolved = [ttopo.evolve_element(t, v.numpy(), 0.3, rng, init_scheme="he_uniform")
               for t, v in zip(made, model.values)]
    pruned, dead = [], None
    for l, res in enumerate(evolved):
        t, vals = res.topology, res.values
        if dead is not None:
            keep = ~np.isin(t.rows, dead)
            t, vals = tsp.ElementTopology(t.in_dim, t.out_dim, t.rows[keep], t.cols[keep]), vals[keep]
        if l < len(evolved) - 1:
            res = timp.importance_prune_element(t, vals, timp.PruningSchedule(percentile=30.0))
            t, dead = res.topology, res.pruned_neurons
        pruned.append(t)
    return {"made": made, "set": [res.topology for res in evolved], "pruned": pruned}


def _check_plan(topo: tsp.ElementTopology, plan: tsp.DwRuns) -> None:
    runs = plan.runs.numpy()
    assert runs.dtype == np.int32 and runs.shape[1] == 3 and plan.n_cols == topo.out_dim
    slot, empty = runs[:plan.n_slot_runs], runs[plan.n_slot_runs:]
    col, lo, n = slot.T.astype(np.int64)
    # no run is empty or longer than R, and none crosses a column
    assert ((n >= 1) & (n <= R)).all()
    within = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    idx = np.repeat(lo, n) + within
    np.testing.assert_array_equal(topo.cols[idx], np.repeat(col, n))
    # every slot lies in exactly one run
    np.testing.assert_array_equal(np.sort(idx), np.arange(topo.nnz))
    # each column cut from its start into as few runs as R allows
    counts = np.bincount(topo.cols, minlength=topo.out_dim)
    np.testing.assert_array_equal(np.bincount(col, minlength=topo.out_dim), -(-counts // R))
    # the slot runs in order of their first slot's row, then column
    key = topo.rows[lo].astype(np.int64) * topo.out_dim + col
    assert (np.diff(key) > 0).all()
    # then every column's own empty run, in column order (its epilogue's):
    # every column has at least one run, an empty one where it has no slot
    np.testing.assert_array_equal(empty[:, 0], np.arange(topo.out_dim))
    assert (empty[:, 2] == 0).all()


@pytest.mark.parametrize("layer", range(4))
@pytest.mark.parametrize("state", ["made", "set", "pruned"])
def test_run_plan_on_the_full_width_model(full_width_topologies, state, layer):
    topo = full_width_topologies[state][layer]
    ta = topo.device_arrays(CPU)
    _check_plan(topo, tsp.dw_plan(ta.rows, ta.cols, topo.out_dim))
    if state == "pruned" and layer < 3:  # the prune empties hidden columns
        assert (np.bincount(topo.cols, minlength=topo.out_dim) == 0).sum() > 0


def test_run_plan_is_made_once_per_cols_tensor_with_no_device_work(
        full_width_topologies, monkeypatch):
    """``device_arrays`` registers the plan to ``cols``, made from the host's
    offsets: ``dw_plan`` finds it with no check and no sync. An index tensor
    it did not make is checked and planned once, then found."""
    topo = full_width_topologies["pruned"][0]
    ta = topo.device_arrays(CPU)
    checks = []
    real = tsp._checked_offsets
    monkeypatch.setattr(tsp, "_checked_offsets",
                        lambda *a: checks.append(1) or real(*a))
    first = tsp.dw_plan(ta.rows, ta.cols, topo.out_dim)
    assert tsp.dw_plan(ta.rows, ta.cols, topo.out_dim) is first and checks == []
    other = ta.cols.clone()
    made = tsp.dw_plan(ta.rows, other, topo.out_dim)
    assert tsp.dw_plan(ta.rows, other, topo.out_dim) is made and len(checks) == 1
    assert torch.equal(made.runs, first.runs) and made[1:] == first[1:]
    with pytest.raises(ValueError, match="planned for"):
        tsp.dw_plan(ta.rows, ta.cols, topo.out_dim + 1)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp.dw_plan(ta.rows, other.flip(0), topo.out_dim)
    key = id(other)
    del other, made
    assert key not in tsp._DW_RUNS


@pytest.mark.parametrize("counts, lens", [
    ([0, 0, 0], []),                                  # nnz 0: the empty runs alone
    ([4000], [R] * (4000 // R)),                      # one 4,000-slot column: 125 full runs
    ([R, R + 1, 2 * R], [R, R, 1, R, R]),             # exactly R long, one past it, two runs
    ([0, 5, 0, R - 1, 0], [5, R - 1]),                # empty columns between and at both ends
])
def test_run_plan_edge_cases(counts, lens):
    """The slot runs' lengths column by column (``lens``), after the
    checks every plan passes."""
    counts = np.asarray(counts)
    cols = np.repeat(np.arange(counts.size), counts).astype(np.int32)
    rows = np.concatenate([np.arange(c) for c in counts]).astype(np.int32)
    topo = tsp.ElementTopology(4000, counts.size, rows, cols)
    ta = topo.device_arrays(CPU)
    plan = tsp.dw_plan(ta.rows, ta.cols, counts.size)
    _check_plan(topo, plan)
    slot = plan.runs.numpy()[:plan.n_slot_runs]
    np.testing.assert_array_equal(slot[np.lexsort((slot[:, 1], slot[:, 0])), 2], lens)
    runs, n_slot = tsp.dw_runs(topo.rows, np.cumsum([0, *counts]))
    np.testing.assert_array_equal(runs, plan.runs.numpy())
    assert n_slot == plan.n_slot_runs == len(lens)


def _exact_case(seed=5, in_dim=48, out_dim=40, epsilon=6, batch=13):
    """A layer whose products are exact in f32 in any order (small integers
    times multiples of 1/8), so that a bias of minus one batch column's
    product makes the pre-activation exactly 0 there on both packages."""
    rng = np.random.default_rng(seed)
    j_topo = jsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    vals = (rng.integers(-8, 9, j_topo.nnz) / 8).astype(np.float32)
    x = rng.integers(-3, 4, (batch, in_dim)).astype(np.float32)
    prod = np.zeros((batch, out_dim), np.float32)
    np.add.at(prod.T, j_topo.cols, x[:, j_topo.rows].T * vals[:, None])
    b = (rng.integers(-8, 9, out_dim) / 4).astype(np.float32)
    b[::2] = -prod[0, ::2]  # z + b == 0 exactly at batch row 0 of every other column
    co = rng.standard_normal((batch, out_dim)).astype(np.float32)
    return j_topo, vals, x, b, co


@pytest.mark.parametrize("needs_dx", [True, False])
@pytest.mark.parametrize("mode", ["none", "bias", "all_relu_odd", "all_relu_even"])
def test_plain_backward_modes_match_reference(mode, needs_dx):
    """``_EspmmT``'s backward on the CPU in kernel F's three epilogue modes
    (no bias: ``espmm_custom``; the bias alone; bias + All-ReLU, slope
    +alpha and -alpha) against ``jax.grad`` of the reference's layer, whose
    dv is its ``coo_dw`` on dz; with pre-activations exactly 0, where the
    slope branch is taken."""
    j_topo, vals, x, b, co = _exact_case()
    out_dim, alpha = j_topo.out_dim, 0.75
    layer_index = {"all_relu_odd": 1, "all_relu_even": 2}.get(mode)
    ja = j_topo.device_arrays()
    ta = tsp.ElementTopology(j_topo.in_dim, out_dim, j_topo.rows, j_topo.cols).device_arrays(CPU)

    def f_ref(xx, v, bb):
        y = jops.espmm(xx, v, ja, out_dim, impl="custom")
        if mode != "none":
            y = y + bb
        if layer_index is not None:
            y = j_all_relu(y, alpha, layer_index)
        return (y * jnp.asarray(co)).sum()

    g_ref = jax.grad(f_ref, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(vals), jnp.asarray(b))
    if mode != "none":
        pre = np.asarray(jops.espmm(jnp.asarray(x), jnp.asarray(vals), ja, out_dim)) + b
        assert (pre == 0).sum() >= out_dim // 2
    hT = torch.as_tensor(x.T.copy()).requires_grad_(needs_dx)
    v = torch.as_tensor(vals).requires_grad_(True)
    bias = torch.as_tensor(b).requires_grad_(True)
    if mode == "none":
        y = tops.espmm_custom(hT.T, v, ta, out_dim)
        loss = (y * torch.as_tensor(co)).sum()
    else:
        slope = None if layer_index is None else slope_for(alpha, layer_index)
        yT = tops.espmm_train_T(hT, v, ta, out_dim, bias=bias, slope=slope)
        loss = (yT * torch.as_tensor(co.T.copy())).sum()
    loss.backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_ref[1]), **TOL)
    if mode == "none":
        assert bias.grad is None
    else:
        np.testing.assert_allclose(bias.grad.numpy(), np.asarray(g_ref[2]), **TOL)
    if needs_dx:
        np.testing.assert_allclose(hT.grad.numpy().T, np.asarray(g_ref[0]), **TOL)
    else:
        assert hT.grad is None


@pytest.mark.parametrize("layer_index", [1, 2, None])
def test_coo_dw_epilogue_is_all_relu_backward_then_coo_dw(layer_index):
    """``coo_dw(..., with_dbias=True)`` on the CPU returns the reference's dz
    (bit-equal: one multiply) and dbias (``jax.grad`` of ``all_relu(z +
    b)``) and the reference's ``coo_dw`` on that dz; without a mask dz is
    dy itself; a mask without the bias, or without a slope, is refused."""
    j_topo, vals, x, b, co = _exact_case(seed=8)
    alpha = 0.75
    prod = np.asarray(jops.espmm(jnp.asarray(x), jnp.asarray(vals), j_topo.device_arrays(),
                                 j_topo.out_dim))
    z = jnp.asarray(prod.T)

    def f(zz, bb):
        v = zz + bb[:, None]
        out = v if layer_index is None else j_all_relu(v, alpha, layer_index)
        return (out * jnp.asarray(co.T)).sum()

    gz, gb = jax.grad(f, argnums=(0, 1))(z, jnp.asarray(b))
    dv_ref = jsp.coo_dw(jnp.asarray(x.T), gz, jnp.asarray(j_topo.rows), jnp.asarray(j_topo.cols))
    ta = tsp.ElementTopology(j_topo.in_dim, j_topo.out_dim, j_topo.rows,
                             j_topo.cols).device_arrays(CPU)
    mask = None if layer_index is None else torch.as_tensor(prod.T + b[:, None] > 0).to(torch.uint8)
    slope = None if layer_index is None else slope_for(alpha, layer_index)
    dy = torch.as_tensor(co.T.copy())
    dv, dz, dbias = tsp.coo_dw(torch.as_tensor(x.T.copy()), dy, ta.rows, ta.cols,
                               with_dbias=True, mask=mask, slope=slope)
    np.testing.assert_array_equal(dz.numpy(), np.asarray(gz))
    np.testing.assert_allclose(dbias.numpy(), np.asarray(gb), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_ref), **TOL)
    assert (mask is not None) or dz is dy
    g = all_relu_fused.all_relu_bwd(dy, mask, slope)
    assert torch.equal(g[0], dz) and torch.equal(g[1], dbias)
    with pytest.raises(ValueError, match="with_dbias"):
        tsp.coo_dw(torch.as_tensor(x.T.copy()), dy, ta.rows, ta.cols,
                   mask=torch.ones_like(dy, dtype=torch.uint8), slope=0.5)
    with pytest.raises(ValueError, match="slope"):
        tsp.coo_dw(torch.as_tensor(x.T.copy()), dy, ta.rows, ta.cols, with_dbias=True,
                   mask=torch.ones_like(dy, dtype=torch.uint8))
