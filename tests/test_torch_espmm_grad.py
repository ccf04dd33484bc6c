"""The port's element (COO) product gradients against the JAX reference, on
the CPU: ``tests/test_espmm_grad.py``'s grids run through the reference's
``espmm`` and the port's, with the same numpy-seeded inputs, for every
impl; then the pieces of the training layer one by one: ``coo_dw`` against
the reference's, ``all_relu_bwd_plain`` against ``jax.grad`` of
``all_relu(z + b)`` (``z == 0`` included), kernel A's training epilogue
(the mask) and the whole layer ``espmm_train_T``.

Tolerance: rtol 1e-4, atol 1e-5 on values and gradients, the reference's own
(``tests/test_espmm_grad.py``): both sides sum in f32, in other orders
(index_add_ in slot order against XLA's segment sums and reductions).
Kernels A, F and G themselves are held against these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core.all_relu import all_relu as j_all_relu  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import all_relu_fused, ops as tops  # noqa: E402
from repro_torch.kernels.ref import slope_for  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
# the reference's impls, and "auto", which picks among them by size
IMPLS = ("custom", "segment", "scatter", "auto")
# (in_dim, out_dim, epsilon, batch, chunk): tests/test_espmm_grad.py's SHAPES
SHAPES = [
    (96, 72, 9, 11, None),     # generic rectangular
    (50, 40, 5, 1, 7),         # batch == 1, several chunks
    (33, 77, 3, 4, 1),         # chunk == 1
    (64, 64, 6, 8, 10_000),    # nnz < chunk
    (128, 16, 2, 3, 13),       # wide-in / narrow-out, ragged last chunk
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def element_case(in_dim, out_dim, epsilon, batch, seed=0):
    """The reference's topology and values, the port's twin of it, and
    seeded inputs and output cotangents."""
    rng = np.random.default_rng(seed)
    j_topo = jsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    vals = np.array(j_topo.init_values(rng))
    x = rng.standard_normal((batch, in_dim)).astype(np.float32)
    co = rng.standard_normal((batch, out_dim)).astype(np.float32)
    t_topo = tsp.ElementTopology(in_dim, out_dim, j_topo.rows, j_topo.cols)
    return j_topo, t_topo, vals, x, co


def _grads(fn, *args):
    """fn(*tensors) -> scalar; returns (value, [grad per arg]), a zero
    gradient where an argument does not reach the value."""
    leaves = [torch.tensor(np.asarray(a)).requires_grad_(True) for a in args]
    out = fn(*leaves)
    if not out.requires_grad:  # a constant (no connections): every gradient is 0
        return out.detach(), [torch.zeros_like(l) for l in leaves]
    grads = torch.autograd.grad(out, leaves, allow_unused=True)
    return out.detach(), [torch.zeros_like(l) if g is None else g for l, g in zip(leaves, grads)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_value_and_grad_match_reference(impl, shape):
    in_dim, out_dim, epsilon, batch, chunk = shape
    j_topo, t_topo, vals, x, co = element_case(in_dim, out_dim, epsilon, batch)
    ja, ta = j_topo.device_arrays(), t_topo.device_arrays(CPU)
    jco, tco = jnp.asarray(co), torch.as_tensor(co)

    def f_ref(xx, v):
        return (jops.espmm(xx, v, ja, out_dim, impl=impl, chunk=chunk) * jco).sum()

    loss_ref, (gx_ref, gv_ref) = jax.value_and_grad(f_ref, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(vals))
    loss, (gx, gv) = _grads(
        lambda xx, v: (tops.espmm(xx, v, ta, out_dim, impl=impl, chunk=chunk) * tco).sum(),
        x, vals)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_ref), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_ref), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_two_layer_mlp_upstream_grads(impl):
    """Gradients through an espmm layer (its dX feeding the previous layer's
    dW) against the reference's, on its inputs."""
    rng = np.random.default_rng(3)
    t1 = jsp.ElementTopology.erdos_renyi(48, 32, 6, rng)
    t2 = jsp.ElementTopology.erdos_renyi(32, 10, 4, rng)
    v1, v2 = np.asarray(t1.init_values(rng)), np.asarray(t2.init_values(rng))
    x = rng.standard_normal((9, 48)).astype(np.float32)
    y = rng.integers(0, 10, size=9).astype(np.int32)
    ja = (t1.device_arrays(), t2.device_arrays())
    ta = tuple(tsp.ElementTopology(t.in_dim, t.out_dim, t.rows, t.cols).device_arrays(CPU)
               for t in (t1, t2))

    def j_loss(a, b):
        h = jax.nn.relu(jops.espmm(jnp.asarray(x), a, ja[0], 32, impl=impl, chunk=11))
        logp = jax.nn.log_softmax(jops.espmm(h, b, ja[1], 10, impl=impl, chunk=11))
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=-1).mean()

    def t_loss(a, b):
        h = torch.relu(tops.espmm(torch.as_tensor(x), a, ta[0], 32, impl=impl, chunk=11))
        logits = tops.espmm(h, b, ta[1], 10, impl=impl, chunk=11)
        return torch.nn.functional.cross_entropy(logits, torch.as_tensor(y).long())

    g_ref = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(v1), jnp.asarray(v2))
    _, g = _grads(t_loss, v1, v2)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_nnz_zero_forward_and_grad(impl):
    z = np.zeros(0, np.int32)
    topo = tsp.ElementTopology(8, 6, z, z)
    t = topo.device_arrays(CPU)
    x = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    y = tops.espmm(torch.as_tensor(x), torch.zeros(0), t, 6, impl=impl)
    assert y.shape == (3, 6) and not y.any()
    _, (gx, gv) = _grads(lambda xx, v: tops.espmm(xx, v, t, 6, impl=impl).sum(),
                         x, np.zeros(0, np.float32))
    assert gv.shape == (0,) and not gx.any()


@pytest.mark.parametrize("impl", ("custom", "segment"))
def test_leading_dims_match_flat_and_reference(impl):
    j_topo, t_topo, vals, _, _ = element_case(40, 30, 4, 1, seed=5)
    xb = np.random.default_rng(5).standard_normal((5, 7, 40)).astype(np.float32)
    ta = t_topo.device_arrays(CPU)
    y_lead = tops.espmm(torch.as_tensor(xb), torch.as_tensor(vals), ta, 30, impl=impl)
    y_flat = tops.espmm(torch.as_tensor(xb.reshape(35, 40)), torch.as_tensor(vals), ta, 30,
                        impl=impl)
    assert y_lead.shape == (5, 7, 30)
    np.testing.assert_array_equal(y_lead.reshape(35, 30).numpy(), y_flat.numpy())
    gv_ref = jax.grad(lambda v: jops.espmm(jnp.asarray(xb), v, j_topo.device_arrays(), 30,
                                           impl=impl).sum())(jnp.asarray(vals))
    _, (gv,) = _grads(lambda v: tops.espmm(torch.as_tensor(xb), v, ta, 30, impl=impl).sum(),
                      vals)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gv_ref), **TOL)


def test_espmm_auto_dispatch_and_unknown_impl():
    _, t_topo, vals, x, _ = element_case(32, 24, 3, 4, seed=8)
    ta = t_topo.device_arrays(CPU)
    xt, vt = torch.as_tensor(x), torch.as_tensor(vals)
    np.testing.assert_allclose(tops.espmm(xt, vt, ta, 24).numpy(),
                               tops.espmm(xt, vt, ta, 24, impl="custom").numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        tops.espmm(xt, vt, ta, 24, impl="nope")


@pytest.mark.parametrize("chunk", [None, 1, 7, 10_000])
@pytest.mark.parametrize("shape", [(96, 72, 9, 11), (50, 40, 5, 1), (128, 16, 2, 3)])
def test_coo_dw_matches_reference(shape, chunk):
    j_topo, t_topo, _, x, co = element_case(*shape, seed=2)
    want = jsp.coo_dw(jnp.asarray(x.T), jnp.asarray(co.T), jnp.asarray(j_topo.rows),
                      jnp.asarray(j_topo.cols), chunk=chunk)
    ta = t_topo.device_arrays(CPU)
    got = tsp.coo_dw(torch.as_tensor(x.T.copy()), torch.as_tensor(co.T.copy()), ta.rows,
                     ta.cols, chunk=chunk)
    assert got.shape == (t_topo.nnz,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    empty = torch.zeros(0, dtype=torch.int32)
    assert tsp.coo_dw(torch.as_tensor(x.T.copy()), torch.as_tensor(co.T.copy()), empty,
                      empty).shape == (0,)


@pytest.mark.parametrize("layer_index", [1, 2, None])  # slope +alpha, -alpha; bias only
@pytest.mark.parametrize("batch", [1, 33])
def test_all_relu_bwd_plain_matches_jax_grad(layer_index, batch):
    """dz and dbias against jax.grad of sum(all_relu(z + b) * dy) (of
    sum((z + b) * dy) with no activation), with a third of the
    pre-activations exactly 0: the reference takes the slope branch there."""
    rng = np.random.default_rng(11)
    n, alpha = 40, 0.75
    z = rng.standard_normal((n, batch)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    z[rng.random((n, batch)) < 1 / 3] = 0.0
    z -= b[:, None] * (z == 0)  # z + b == 0 exactly there
    dy = rng.standard_normal((n, batch)).astype(np.float32)
    pre = z + b[:, None]
    assert (pre == 0).sum() > 0

    def f(zz, bb):
        v = zz + bb[:, None]
        out = v if layer_index is None else j_all_relu(v, alpha, layer_index)
        return (out * jnp.asarray(dy)).sum()

    gz, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(z), jnp.asarray(b))
    mask = None if layer_index is None else torch.as_tensor(pre > 0).to(torch.uint8)
    slope = None if layer_index is None else slope_for(alpha, layer_index)
    dz, dbias = all_relu_fused.all_relu_bwd(torch.as_tensor(dy), mask, slope)
    np.testing.assert_array_equal(dz.numpy(), np.asarray(gz))  # one multiply: the same bits
    np.testing.assert_allclose(dbias.numpy(), np.asarray(gb), **TOL)


@pytest.mark.parametrize("layer_index", [1, 2])
def test_training_epilogue_mask_is_the_pre_activation_sign(layer_index):
    """Kernel A's training epilogue (plain version): the output is the
    All-ReLU epilogue's, and the mask is 1 exactly where ``out + bias > 0``,
    0 at 0 and below, whichever sign the slope has."""
    _, t_topo, vals, x, _ = element_case(30, 25, 4, 6, seed=4)
    ta = t_topo.device_arrays(CPU)
    xT, vt = torch.as_tensor(x.T.copy()), torch.as_tensor(vals)
    prod = tsp.coo_matmul_T(xT, vt, ta.rows, ta.cols, 25)
    bias = -prod[:, 0].clone()  # batch column 0 lands on exactly 0
    slope = slope_for(0.6, layer_index)
    out, mask = tsp.coo_matmul_T(xT, vt, ta.rows, ta.cols, 25, bias=bias, slope=slope,
                                 with_mask=True)
    assert mask.dtype == torch.uint8 and mask.shape == out.shape
    assert torch.equal(out, tsp.coo_matmul_T(xT, vt, ta.rows, ta.cols, 25, bias=bias,
                                             slope=slope))
    pre = tsp.coo_matmul_T(xT, vt, ta.rows, ta.cols, 25, bias=bias)
    assert torch.equal(mask.bool(), pre > 0) and not mask[:, 0].any()
    with pytest.raises(ValueError, match="with_mask"):
        tsp.coo_matmul_T(xT, vt, ta.rows, ta.cols, 25, bias=bias, with_mask=True)


@pytest.mark.parametrize("needs_dx", [True, False])
@pytest.mark.parametrize("layer_index", [1, 2, None])
def test_training_layer_matches_reference(layer_index, needs_dx):
    """``espmm_train_T`` against the reference's element layer,
    ``all_relu(espmm(h, v) + b)`` (the bias alone for the output layer), in
    value and in the gradients of h, v and b; where h needs no gradient (the
    first layer) no dX is computed."""
    j_topo, t_topo, vals, x, co = element_case(64, 48, 6, 13, seed=6)
    b = np.random.default_rng(7).standard_normal(48).astype(np.float32)
    alpha = 0.6
    ja, ta = j_topo.device_arrays(), t_topo.device_arrays(CPU)

    def f_ref(xx, v, bb):
        y = jops.espmm(xx, v, ja, 48, impl="custom") + bb
        y = y if layer_index is None else j_all_relu(y, alpha, layer_index)
        return (y * jnp.asarray(co)).sum()

    loss_ref, g_ref = jax.value_and_grad(f_ref, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(b))
    slope = None if layer_index is None else slope_for(alpha, layer_index)
    hT = torch.as_tensor(x.T.copy()).requires_grad_(needs_dx)
    v = torch.as_tensor(vals).requires_grad_(True)
    bias = torch.as_tensor(b).requires_grad_(True)
    yT = tops.espmm_train_T(hT, v, ta, 48, bias=bias, slope=slope)
    loss = (yT * torch.as_tensor(co.T.copy())).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_ref[1]), **TOL)
    np.testing.assert_allclose(bias.grad.numpy(), np.asarray(g_ref[2]), **TOL)
    if needs_dx:
        np.testing.assert_allclose(hT.grad.numpy().T, np.asarray(g_ref[0]), **TOL)
    else:
        assert hT.grad is None


def test_offsets_are_made_once_with_the_arrays():
    """``device_arrays`` registers both orders' offsets to their index
    tensors, with the longest segment as a host int, so that kernel A
    finds them and its route with no device sync."""
    _, t_topo, _, _, _ = element_case(60, 45, 5, 1, seed=9)
    ta = t_topo.device_arrays(CPU)
    col_ptr, row_ptr = tsp.registered_offsets(ta.cols), tsp.registered_offsets(ta.rows_r)
    np.testing.assert_array_equal(col_ptr.numpy(), t_topo.col_ptr())
    np.testing.assert_array_equal(row_ptr.numpy(), t_topo.row_ptr())
    np.testing.assert_array_equal(row_ptr.numpy(),
                                  tsp.segment_offsets(ta.rows_r, t_topo.in_dim).numpy())
    assert tsp._longest_segment(row_ptr, t_topo.nnz, 60) == int(np.diff(t_topo.row_ptr()).max())
    tsp._check_seg_ptr(row_ptr, t_topo.nnz)  # made on the host: no device check
    with pytest.raises(ValueError, match="seg_ptr"):
        tsp._check_seg_ptr(row_ptr, t_topo.nnz + 1)
    assert tsp.registered_offsets(ta.rows) is None  # not a segment order
    key = id(ta.cols)
    del ta, col_ptr
    assert key not in tsp._SEG_PTRS
    with pytest.raises(ValueError, match="never decrease"):
        tsp.offsets_to_device(np.array([0, 3, 2]), CPU)
