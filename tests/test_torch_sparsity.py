"""Parity of the port's element sparsity (``repro_torch.core.sparsity``,
``repro_torch.kernels.ops``) with the JAX reference, on the CPU.

Seeded numpy inputs go through both packages. Topology and init are held
bit-equal; the products are held at rtol 1e-5 / atol 1e-6 (the plain version
adds in slot order, XLA's segment sum per chunk). Kernel A itself is held
against its plain version on the card in ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp
from repro.kernels import ops as jops
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import ops as tops

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def _case(seed, in_dim, out_dim, epsilon, batch):
    rng = np.random.default_rng(seed)
    j_topo = jsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    vals = np.array(j_topo.init_values(rng))
    x = rng.standard_normal((batch, in_dim)).astype(np.float32)
    t_topo = tsp.ElementTopology(in_dim, out_dim, j_topo.rows, j_topo.cols)
    return j_topo, t_topo, vals, x


@pytest.mark.parametrize("dims", [(64, 32, 8), (3072, 4000, 20), (7, 5, 100)])
def test_density_and_nnz_match(dims):
    n_in, n_out, eps = dims
    assert tsp.density_from_epsilon(eps, n_in, n_out) == jsp.density_from_epsilon(eps, n_in, n_out)
    assert tsp.erdos_renyi_nnz(eps, n_in, n_out) == jsp.erdos_renyi_nnz(eps, n_in, n_out)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dims", [(64, 32, 8), (32, 24, 6), (5, 3, 50)])
def test_topology_and_device_arrays_bit_equal(seed, dims):
    n_in, n_out, eps = dims
    j = jsp.ElementTopology.erdos_renyi(n_in, n_out, eps, np.random.default_rng(seed))
    t = tsp.ElementTopology.erdos_renyi(n_in, n_out, eps, np.random.default_rng(seed))
    np.testing.assert_array_equal(t.rows, j.rows)
    np.testing.assert_array_equal(t.cols, j.cols)
    assert t.nnz == j.nnz and t.density == j.density
    for name, jt, tt in zip(jsp.ElemTopoArrays._fields, j.device_arrays(),
                            t.device_arrays(torch.device("cpu"))):
        assert tt.dtype == torch.int32, name
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt), err_msg=name)
    np.testing.assert_array_equal(t.col_ptr(), np.searchsorted(j.cols, np.arange(n_out + 1)))
    np.testing.assert_array_equal(
        tsp.segment_offsets(torch.as_tensor(t.cols), n_out).numpy(), t.col_ptr()
    )


@pytest.mark.parametrize("scheme", ["normal", "he_uniform", "xavier", "zeros"])
def test_init_numpy_bit_equal(scheme):
    a = jsp._init_numpy(np.random.default_rng(3), (17, 5), fan_in_dense=40, scheme=scheme)
    b = tsp._init_numpy(np.random.default_rng(3), (17, 5), fan_in_dense=40, scheme=scheme)
    np.testing.assert_array_equal(a, b)
    rng_j, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    j = jsp.ElementTopology.erdos_renyi(40, 12, 4, rng_j)
    t = tsp.ElementTopology.erdos_renyi(40, 12, 4, rng_t)
    np.testing.assert_array_equal(
        t.init_values(rng_t, scheme=scheme, device=torch.device("cpu")).numpy(),
        np.asarray(j.init_values(rng_j, scheme=scheme)),
    )


def test_first_flags_and_chunk_policy_match():
    keys = np.array([0, 0, 1, 3, 3, 3, 4], np.int32)
    np.testing.assert_array_equal(tsp._first_flags(keys), jsp._first_flags(keys))
    for batch, nnz, chunk in [(1, 10, None), (256, 100_000, None), (8, 3, None),
                              (4, 1000, 13), (4, 0, None), (1024, 10**7, None)]:
        assert tsp.spmm_chunk_for(batch, nnz, chunk) == jsp.spmm_chunk_for(batch, nnz, chunk)
    for name in ("SPMM_TEMP_BUDGET_ELEMS", "SPMM_CHUNK_MIN", "SPMM_AUTO_NNZ",
                 "SPMM_AUTO_ELEMS", "SPMM_INFER_NNZ", "SPMM_INFER_ELEMS"):
        assert getattr(tsp, name) == getattr(jsp, name), name


# (seed, in_dim, out_dim, epsilon, batch, chunk): chunk sweep, batch 1,
# nnz < chunk, a ragged last chunk
COO_CASES = [
    (0, 96, 72, 9, 11, None),
    (1, 50, 40, 5, 1, 7),
    (2, 33, 77, 3, 4, 1),
    (3, 64, 64, 6, 8, 10_000),
    (4, 128, 16, 2, 3, 13),
]


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("case", COO_CASES)
def test_coo_matmul_T_matches_reference(case, with_acc):
    seed, in_dim, out_dim, eps, batch, chunk = case
    j_topo, t_topo, vals, x = _case(seed, in_dim, out_dim, eps, batch)
    acc = (np.random.default_rng(seed + 100).standard_normal((out_dim, batch))
           .astype(np.float32) if with_acc else None)
    want = jsp.coo_matmul_T(
        jnp.asarray(x.T), jnp.asarray(vals), jnp.asarray(j_topo.rows),
        jnp.asarray(j_topo.cols), out_dim, chunk=chunk,
        acc=None if acc is None else jnp.asarray(acc),
    )
    got = tsp.coo_matmul_T(
        torch.as_tensor(np.ascontiguousarray(x.T)), torch.as_tensor(vals),
        torch.as_tensor(t_topo.rows), torch.as_tensor(t_topo.cols), out_dim,
        chunk=chunk, acc=None if acc is None else torch.as_tensor(acc),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_acc", [False, True])
def test_coo_matmul_T_no_connections(with_acc):
    src = torch.ones((6, 3))
    acc = torch.arange(12, dtype=torch.float32).reshape(4, 3) if with_acc else None
    empty = torch.empty((0,), dtype=torch.int32)
    got = tsp.coo_matmul_T(src, torch.empty((0,)), empty, empty, 4, acc=acc)
    want = jsp.coo_matmul_T(
        jnp.ones((6, 3)), jnp.zeros((0,)), jnp.zeros((0,), jnp.int32),
        jnp.zeros((0,), jnp.int32), 4, acc=None if acc is None else jnp.asarray(acc.numpy()),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [None, 1, 13, 10_000])
def test_element_spmm_segment_matches_reference(chunk):
    j_topo, t_topo, vals, x = _case(5, 96, 72, 9, 11)
    x3 = np.repeat(x[:, None, :], 2, axis=1)  # leading dims
    want = jsp.element_spmm_segment(
        jnp.asarray(x3), jnp.asarray(vals), jnp.asarray(j_topo.rows),
        jnp.asarray(j_topo.cols), 72, chunk=chunk,
    )
    got = tsp.element_spmm_segment(
        torch.as_tensor(x3), torch.as_tensor(vals), torch.as_tensor(t_topo.rows),
        torch.as_tensor(t_topo.cols), 72, chunk=chunk,
    )
    assert got.shape == (11, 2, 72)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_element_spmm_scatter_matches_reference():
    j_topo, t_topo, vals, x = _case(6, 40, 30, 4, 5)
    want = jsp.element_spmm(jnp.asarray(x), jnp.asarray(vals), jnp.asarray(j_topo.rows),
                            jnp.asarray(j_topo.cols), 30)
    got = tsp.element_spmm(torch.as_tensor(x), torch.as_tensor(vals),
                           torch.as_tensor(t_topo.rows), torch.as_tensor(t_topo.cols), 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# small problems take the scatter formulation in both packages; the
# 400x400 layer (80,000 connections) crosses SPMM_INFER_NNZ at batch 8, so
# the reference takes its chunked segment path
@pytest.mark.parametrize("case", [(7, 64, 32, 8, 5), (8, 400, 400, 100, 8), (9, 50, 40, 5, 1)])
def test_espmm_infer_matches_reference(case):
    seed, in_dim, out_dim, eps, batch = case
    j_topo, t_topo, vals, x = _case(seed, in_dim, out_dim, eps, batch)
    want = jops.espmm_infer(jnp.asarray(x), jnp.asarray(vals), j_topo.device_arrays(), out_dim)
    t = t_topo.device_arrays(torch.device("cpu"))
    got = tops.espmm_infer(torch.as_tensor(x), torch.as_tensor(vals), t, out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # the column offsets the engine freezes give the same answer
    got_ptr = tops.espmm_infer(torch.as_tensor(x), torch.as_tensor(vals), t, out_dim,
                               col_ptr=torch.as_tensor(t_topo.col_ptr()))
    np.testing.assert_array_equal(got_ptr.numpy(), got.numpy())


def test_topology_rejects_bad_connections():
    with pytest.raises(ValueError, match="out of range"):
        tsp.ElementTopology(4, 3, np.array([0, 4]), np.array([0, 1]))
    with pytest.raises(ValueError, match="out of range"):
        tsp.ElementTopology(4, 3, np.array([0, 1]), np.array([-1, 1]))
    with pytest.raises(ValueError, match="duplicate"):
        tsp.ElementTopology(4, 3, np.array([1, 1]), np.array([2, 2]))


@pytest.mark.parametrize("seg_ptr,ok", [
    ([0, 2, 2, 5], True),
    ([0, 2, 2, 6], False),  # ends past nnz: kernel A would read past the slots
    ([0, 2, 2, 4], False),  # ends short of nnz: slots left out
    ([1, 2, 2, 5], False),
    ([0, 3, 2, 5], False),  # decreasing
])
def test_seg_ptr_check_keeps_kernel_a_inside_the_slots(seg_ptr, ok):
    t = torch.tensor(seg_ptr, dtype=torch.int64)
    if ok:
        tsp._check_seg_ptr(t, 5)
        assert tsp._CHECKED_SEG_PTRS[id(t)]() is t  # checked once, then remembered
        del t
    else:
        with pytest.raises(ValueError, match="seg_ptr"):
            tsp._check_seg_ptr(t, 5)
        assert id(t) not in tsp._CHECKED_SEG_PTRS


@pytest.mark.parametrize("seed", [0, 3])
def test_checked_offsets_are_the_column_offsets(seed):
    topo = tsp.ElementTopology.erdos_renyi(30, 20, 4, np.random.default_rng(seed))
    cols = topo.device_arrays(torch.device("cpu")).cols
    got = tsp._checked_offsets(cols, topo.out_dim)
    np.testing.assert_array_equal(got.numpy(), topo.col_ptr())
    tsp._check_seg_ptr(got, topo.nnz)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp._checked_offsets(cols.flip(0), topo.out_dim)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp._checked_offsets(cols, topo.out_dim - 1)  # the last column is out of range


def test_coo_matmul_T_rejects_other_devices():
    """Kernel A's wrapper raises for a device it does not take (the
    TorchScript lazy backend, which needs no hardware). A ``meta`` tensor
    takes the plain version (the dry run's route) and launches nothing."""
    import torch._lazy.ts_backend

    try:
        torch._lazy.ts_backend.init()
    except RuntimeError as e:  # it registers once a process
        if "multiple backend fallbacks" not in str(e):
            raise
    lazy = torch.empty((4, 2), device="lazy")
    empty = torch.empty((0,), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsp.coo_matmul_T(lazy, torch.empty((0,), device="lazy"), empty.to("lazy"),
                         empty.to("lazy"), 3)
    meta = torch.empty((4, 2), device="meta")
    before = tsp.coo_matmul_T.launches
    y = tsp.coo_matmul_T(meta, torch.empty((0,), device="meta"), empty.to("meta"),
                         empty.to("meta"), 3)
    assert y.device.type == "meta" and y.shape == (3, 2)
    assert tsp.coo_matmul_T.launches == before


@pytest.mark.parametrize("with_dbias", [False, True])
@pytest.mark.parametrize("chunk", [None, 7])
def test_coo_dw_plain_untracked_and_tracked_products_bit_equal(with_dbias, chunk):
    """``coo_dw_plain`` takes a chunk's slab product in place when autograd
    records nothing and out of place when it does: both give the same bits,
    at the reference's ``coo_dw`` within the stated tolerance, and the
    tracked one still differentiates."""
    j_topo, t_topo, _, x = _case(5, 40, 24, 6, 9)
    rng = np.random.default_rng(6)
    dy = rng.standard_normal((9, 24)).astype(np.float32)
    mask = (rng.standard_normal((24, 9)) > 0) if with_dbias else None
    kw = dict(chunk=chunk, with_dbias=with_dbias,
              mask=None if mask is None else torch.as_tensor(mask),
              slope=0.3 if with_dbias else None)
    xT, dyT = torch.as_tensor(x.T.copy()), torch.as_tensor(dy.T.copy())
    rows, cols = torch.as_tensor(t_topo.rows), torch.as_tensor(t_topo.cols)
    untracked = tsp.coo_dw_plain(xT, dyT, rows, cols, **kw)
    xT_g, dyT_g = xT.clone().requires_grad_(), dyT.clone().requires_grad_()
    tracked = tsp.coo_dw_plain(xT_g, dyT_g, rows, cols, **kw)
    for a, b in zip(untracked if with_dbias else (untracked,),
                    tracked if with_dbias else (tracked,)):
        assert not a.requires_grad and b.requires_grad
        assert torch.equal(a, b.detach())
    dv = tracked[0] if with_dbias else tracked
    dv.sum().backward()
    assert xT_g.grad is not None and dyT_g.grad is not None
    if not with_dbias:
        ref = jsp.coo_dw(jnp.asarray(x.T), jnp.asarray(dy.T),
                         jnp.asarray(j_topo.rows), jnp.asarray(j_topo.cols))
        np.testing.assert_allclose(untracked.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
