"""Kernel B's work in its two places in the port, against the JAX reference
on the CPU: fused into kernel A's store on the element serving path (the
plain epilogue, ``tsp.coo_epilogue``, and the fused op), and as the block
model's no-grad epilogue, which reads kernel C's column slice in place.

The epilogue adds the bias after the whole product and then does All-ReLU's
IEEE compare and multiply, as the Pallas ``bias_all_relu`` does, so on the
reference's own product it is held bit-equal. The fused op sums in another
order than XLA's segment sum and is held at rtol/atol 1e-5. The kernels
themselves are held against these plain versions on the card in
``test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import all_relu as jar
from repro.core import sparsity as jsp
from repro.kernels.all_relu_fused import bias_all_relu as pallas_bias_all_relu
from repro_torch.core import sparsity as tsp
from repro_torch.core.all_relu import activation_fn
from repro_torch.kernels import all_relu_fused
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import slope_for
from repro_torch.models import mlp as tmlp

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(seed, in_dim, out_dim, epsilon, batch, empty_cols=()):
    """A seeded COO layer (its connections into ``empty_cols`` dropped), a
    normal srcT (in_dim, batch), a carry-in and a bias."""
    rng = np.random.default_rng(seed)
    topo = tsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    keep = ~np.isin(topo.cols, np.asarray(empty_cols, np.int32))
    topo = tsp.ElementTopology(in_dim, out_dim, topo.rows[keep], topo.cols[keep])
    vals = tsp._init_numpy(rng, (topo.nnz,), fan_in_dense=in_dim, scheme="he_uniform")
    srcT = rng.standard_normal((in_dim, batch)).astype(np.float32)
    acc = rng.standard_normal((out_dim, batch)).astype(np.float32)
    bias = rng.standard_normal((out_dim,)).astype(np.float32)
    return topo, vals, srcT, acc, bias


def _signed_zeros_and_tiny(yT: np.ndarray, bias: np.ndarray) -> None:
    """Put ±0 and tiny values into the product and into ``yT + bias``."""
    yT[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    bias[0] = 0.0
    bias[1] = -yT[1, 0]  # yT + bias == 0 exactly
    bias[2] = -0.0
    yT[2, 0] = -0.0  # -0 + -0 == -0


@pytest.mark.parametrize("layer_index", [1, 2, 3, 4])
@pytest.mark.parametrize("alpha", [0.05, 0.75])
def test_epilogue_on_the_reference_product_matches_pallas(layer_index, alpha):
    topo, vals, srcT, _, bias = _layer(layer_index, 40, 24, 5, 6)
    yT = np.array(jsp.coo_matmul_T(jnp.asarray(srcT), jnp.asarray(vals), jnp.asarray(topo.rows),
                                   jnp.asarray(topo.cols), 24))
    _signed_zeros_and_tiny(yT, bias)
    want = np.asarray(pallas_bias_all_relu(jnp.asarray(yT.T), jnp.asarray(bias), alpha=alpha,
                                           layer_index=layer_index, interpret=True)).T
    got = tsp.coo_epilogue(torch.as_tensor(yT), torch.as_tensor(bias),
                           slope_for(alpha, layer_index))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(want))  # -0 stays -0
    # the output layer's epilogue: the bias alone
    got1 = tsp.coo_epilogue(torch.as_tensor(yT), torch.as_tensor(bias), None)
    want1 = np.asarray(jnp.asarray(yT) + jnp.asarray(bias)[:, None])
    np.testing.assert_array_equal(got1.numpy(), want1)
    assert np.array_equal(np.signbit(got1.numpy()), np.signbit(want1))


# (seed, in_dim, out_dim, epsilon, batch, columns left empty): batch 1 and
# 33, an emptied segment, and a layer sparse enough to leave others empty
FUSED = [(0, 50, 30, 5, 1, (3,)), (1, 50, 30, 5, 33, (0, 29)), (2, 6, 40, 1, 33, ()),
         (3, 96, 72, 9, 5, ())]


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("layer_index", [None, 1, 2])  # None: the bias alone
@pytest.mark.parametrize("case", FUSED)
def test_fused_op_matches_reference_product_bias_and_all_relu(case, layer_index, with_acc):
    seed, in_dim, out_dim, eps, batch, empty = case
    topo, vals, srcT, acc, bias = _layer(seed, in_dim, out_dim, eps, batch, empty)
    acc = acc if with_acc else None
    yT = jsp.coo_matmul_T(jnp.asarray(srcT), jnp.asarray(vals), jnp.asarray(topo.rows),
                          jnp.asarray(topo.cols), out_dim,
                          acc=None if acc is None else jnp.asarray(acc))
    want = yT + jnp.asarray(bias)[:, None]
    if layer_index is not None:
        want = jar.all_relu(want, 0.75, layer_index)
    slope = None if layer_index is None else slope_for(0.75, layer_index)
    counts = (tsp.coo_matmul_T.launches, tsp.coo_matmul_T.epilogue_launches)
    t = topo.device_arrays(torch.device("cpu"))
    got = tsp.coo_matmul_T(torch.as_tensor(srcT), torch.as_tensor(vals), t.rows, t.cols,
                           out_dim, acc=None if acc is None else torch.as_tensor(acc),
                           bias=torch.as_tensor(bias), slope=slope)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # an empty segment is the epilogue of the carry-in, or of exact zeros
    for c in empty:
        base = np.zeros(batch, np.float32) if acc is None else acc[c]
        np.testing.assert_array_equal(
            got[c].numpy(),
            tsp.coo_epilogue(torch.as_tensor(base)[None], torch.as_tensor(bias[c:c + 1]),
                             slope)[0].numpy())
    # the op the served forward calls is the same thing, with the offsets given
    got_op = tops.espmm_infer_T(torch.as_tensor(srcT), torch.as_tensor(vals), t, out_dim,
                                bias=torch.as_tensor(bias), slope=slope,
                                col_ptr=torch.as_tensor(topo.col_ptr()))
    if acc is None:
        np.testing.assert_array_equal(got_op.numpy(), got.numpy())
    # the plain version launched nothing
    assert (tsp.coo_matmul_T.launches, tsp.coo_matmul_T.epilogue_launches) == counts


@pytest.mark.parametrize("layer_index", [None, 2])
@pytest.mark.parametrize("with_acc", [False, True])
def test_fused_op_without_connections(with_acc, layer_index):
    rng = np.random.default_rng(4)
    acc = rng.standard_normal((4, 3)).astype(np.float32)
    bias = rng.standard_normal((4,)).astype(np.float32)
    empty = torch.empty((0,), dtype=torch.int32)
    slope = None if layer_index is None else slope_for(0.6, layer_index)
    got = tsp.coo_matmul_T(torch.ones((6, 3)), torch.empty((0,)), empty, empty, 4,
                           acc=torch.as_tensor(acc) if with_acc else None,
                           bias=torch.as_tensor(bias), slope=slope)
    base = acc if with_acc else np.zeros((4, 3), np.float32)
    want = jnp.asarray(base) + jnp.asarray(bias)[:, None]
    if layer_index is not None:
        want = jar.all_relu(want, 0.6, layer_index)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_epilogue_arguments_are_checked():
    topo, vals, srcT, _, bias = _layer(5, 20, 10, 3, 4)
    t = topo.device_arrays(torch.device("cpu"))
    args = (torch.as_tensor(srcT), torch.as_tensor(vals), t.rows, t.cols, 10)
    with pytest.raises(ValueError, match="needs a bias"):
        tsp.coo_matmul_T(*args, slope=0.5)
    with pytest.raises(ValueError, match="bias has shape"):
        tsp.coo_matmul_T(*args, bias=torch.as_tensor(bias[:9]))
    with pytest.raises(ValueError, match="bias has shape"):
        tsp.coo_matmul_T(*args, bias=torch.as_tensor(bias)[None])


# -- the served forward's layout ------------------------------------------------


SMOKE = dict(layer_dims=(64, 32, 16, 4), epsilon=8)


@pytest.mark.parametrize("activation", ["all_relu", "leaky_relu"])
def test_served_forward_runs_one_op_per_layer_and_no_standalone_b(monkeypatch, activation):
    """The element forward calls ``espmm_infer_T`` once per layer in the
    (features, batch) layout, with the All-ReLU epilogue on the hidden
    layers where the activation is All-ReLU, and never kernel B's pass."""
    model = tmlp.SparseMLP(tmlp.SparseMLPConfig(**SMOKE, activation=activation), seed=2,
                           device="cpu")
    calls = []
    real = tops.espmm_infer_T

    def spy(hT, values, topo, out_dim, **kw):
        calls.append((tuple(hT.shape), out_dim, kw["slope"]))
        return real(hT, values, topo, out_dim, **kw)

    def no_b(*a, **k):
        raise AssertionError("the element forward ran kernel B's pass")

    monkeypatch.setattr(tops, "espmm_infer_T", spy)
    monkeypatch.setattr(tmlp, "bias_all_relu", no_b)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((7, 64)).astype(np.float32))
    out = tmlp.mlp_forward(model.params(), model.topo_arrays(), x, model.config, infer=True)
    assert out.shape == (7, 4) and out.is_contiguous()
    fused = activation == "all_relu"
    assert calls == [((64, 7), 32, slope_for(0.6, 1) if fused else None),
                     ((32, 7), 16, slope_for(0.6, 2) if fused else None),
                     ((16, 7), 4, None)]


# -- kernel B as the block model's no-grad epilogue ------------------------------


BLOCK = dict(layer_dims=(64, 40, 24, 4), epsilon=8, impl="block", block_m=16, block_n=16,
             dropout=0.0)


def _block_reference(model, x):
    """The block forward as the reference writes it: product, ``+ bias``,
    then the activation."""
    act = activation_fn(model.config.activation, alpha=model.config.alpha)
    h = x
    topo = model.topo_arrays()
    for l in range(model.config.n_layers):
        h = tops.bsmm_kernel(h, model.values[l], topo[l], tmlp.block_meta(model.config, l))
        h = h + model.biases[l]
        if l < model.config.n_layers - 1:
            h = act(h, l + 1)
    return h


@pytest.mark.parametrize("mode", ["infer", "no_grad", "grad"])
def test_block_no_grad_forward_runs_kernel_b_bit_equal(monkeypatch, mode):
    """Evaluation (autograd off) and ``infer=True`` run each hidden layer's
    bias and All-ReLU through kernel B's wrapper on the product's column
    slice; with autograd on, the plain ops run. Either way the logits are
    bit-equal to ``act(h + bias)``."""
    model = tmlp.SparseMLP(tmlp.SparseMLPConfig(**BLOCK), seed=3, device="cpu")
    rng = np.random.default_rng(3)
    model.biases = [torch.as_tensor(rng.standard_normal(b.shape).astype(np.float32))
                    for b in model.biases]
    x = torch.as_tensor(rng.standard_normal((9, 64)).astype(np.float32))
    seen = []
    real = all_relu_fused.bias_all_relu

    def spy(h, bias, **kw):
        seen.append((tuple(h.shape), h.stride(), kw["layer_index"]))
        return real(h, bias, **kw)

    monkeypatch.setattr(tmlp, "bias_all_relu", spy)
    with torch.set_grad_enabled(mode == "grad"):
        got = tmlp.mlp_forward(model.params(), model.topo_arrays(), x, model.config,
                               infer=mode == "infer")
        want = _block_reference(model, x)
    assert torch.equal(got, want)
    if mode == "grad":
        assert seen == []
    else:  # 40 and 24 outputs of 48- and 32-wide padded products, read in place
        assert seen == [((9, 40), (48, 1), 1), ((9, 24), (32, 1), 2)]


def test_block_no_grad_forward_matches_the_reference():
    from repro.models import mlp as jmlp
    cfg = tmlp.SparseMLPConfig(**BLOCK)
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**dataclasses.asdict(cfg)), seed=5)
    tm = tmlp.SparseMLP(cfg, seed=5, device="cpu")
    x = np.random.default_rng(6).standard_normal((5, 64)).astype(np.float32)
    want = jmlp.mlp_forward(jm.params(), jm.topo_arrays(), jnp.asarray(x), jm.config,
                            infer=True)
    with torch.no_grad():
        got = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x), tm.config)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,sl", [
    ((6, 48), np.s_[:, :40]),        # a padded product's columns: pitch 48
    ((3, 5, 36), np.s_[..., :33]),   # leading dims, a ragged width
    ((1, 20), np.s_[:, :17]),        # one row: the pitch is the width
    ((4, 8), np.s_[:, :]),           # contiguous
])
def test_kernel_b_row_pitch(shape, sl):
    """The row pitch kernel B is handed for a column slice, and its plain
    version on the slice, bit-equal to the Pallas kernel on a copy."""
    rng = np.random.default_rng(7)
    full = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    x = full[sl]
    n = x.shape[-1]
    bias = torch.as_tensor(rng.standard_normal((n,)).astype(np.float32))
    pitch = all_relu_fused._row_pitch(x)
    assert pitch == (shape[-1] if x.numel() > n else n)
    got = all_relu_fused.bias_all_relu(x, bias, alpha=0.75, layer_index=2)
    want = pallas_bias_all_relu(jnp.asarray(x.contiguous().numpy()), jnp.asarray(bias.numpy()),
                                alpha=0.75, layer_index=2, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_b_refuses_rows_it_cannot_walk():
    x = torch.zeros((8, 16))
    for bad in (x.T, x[:, ::2], x.unsqueeze(1).expand(8, 3, 16)):
        with pytest.raises(ValueError, match="contiguous"):
            all_relu_fused._row_pitch(bad)
