"""The port's LM stack (``repro_torch.models.layers``, ``.transformer``), kernel
C's bfloat16 instance and kernel B's bfloat16 All-ReLU, against the JAX
reference on the CPU (their kernels on the card: ``test_torch_gpu.py``).

Tolerances, and why:

* kernel C's plain version in bf16 against the Pallas ``bsmm_fwd``
  (interpret mode, bf16): 1e-2, above one bf16 ulp; both keep an f32 sum and
  round once, in other orders. Against ``ref.bsmm_ref``: the reference's
  own 5e-2 (``tests/test_kernels.py``);
* kernel B's plain version in bf16: bit-equal to the Pallas
  ``bias_all_relu`` (interpret) and to ``all_relu`` with a traced layer
  index (the LM's bias-free case): every step rounds to bf16 in both;
* layers in f32: 1e-5 (the reference's own attention tolerance is 2e-5);
* ``PatternLM`` in f32 with the reference's parameters carried over
  (``interop.lm_from_numpy``): logits and caches 1e-4; decode against the
  teacher-forced forward at the reference's 5e-3; the same model in bf16
  within 5e-2 of the reference's forward of its bf16 weights (computed in
  f32: XLA's CPU backend cannot run the reference's bf16 sparse FFN);
* the sparse FFN's topologies and values for a seed: bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro.core.all_relu import all_relu as jall_relu  # noqa: E402
from repro.core.sparsity import BlockMeta as JMeta  # noqa: E402
from repro.core.sparsity import BlockTopology as JTopo  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.all_relu_fused import bias_all_relu as jbias_all_relu  # noqa: E402
from repro.kernels.block_sparse_matmul import bsmm_fwd as jbsmm_fwd  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.sparsity import BlockMeta, BlockTopology  # noqa: E402
from repro_torch.interop import lm_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import all_relu_fused, ref  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as bsm  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import ModelConfig, PatternLM  # noqa: E402
from repro_torch.serve.engine import SparseInferenceEngine  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LM_FIELDS = dict(ffn="sparse", sparse_block=16, sparse_density=0.5, d_ff=64)
LM_CFG = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
JLM_CFG = dataclasses.replace(jconfigs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
TOL = dict(rtol=1e-5, atol=1e-5)
LM_TOL = dict(rtol=1e-4, atol=1e-4)

# B, gm, gn, bm, bn, density: the reference's kernel sweep (tests/test_kernels.py:32)
SHAPES = [
    (8, 2, 3, 8, 16, 0.7),
    (16, 4, 4, 16, 16, 0.4),
    (32, 3, 5, 8, 8, 0.9),
    (8, 1, 2, 16, 8, 1.0),
    (24, 5, 2, 8, 16, 0.5),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# kernel C in bf16 (plain version) and kernel B in bf16 (plain version)
# ---------------------------------------------------------------------------


def _bsmm_case(shape, dtype):
    """The reference's ``make_case`` (seed 0) in both packages."""
    B, gm, gn, bm, bn, density = shape
    rng = np.random.default_rng(0)
    jmeta = JMeta(in_dim=gm * bm, out_dim=gn * bn, block_m=bm, block_n=bn)
    jtopo = JTopo.erdos_renyi(jmeta, density, rng)
    values = jtopo.init_values(rng, dtype=dtype)
    x = jnp.asarray(rng.standard_normal((B, jmeta.in_dim)), dtype)
    return jmeta, jtopo, values, x


@pytest.mark.parametrize("shape", SHAPES)
def test_bsmm_fwd_plain_bf16_matches_pallas_and_oracle(shape):
    jmeta, jtopo, values, x = _bsmm_case(shape, jnp.bfloat16)
    t = jtopo.device_arrays()
    want = jbsmm_fwd(x, values, t.rows, t.cols, t.first_col, grid_n=jmeta.grid_n, block_b=8,
                     interpret=True)
    oracle = jref.bsmm_ref(x.astype(jnp.float32), values.astype(jnp.float32), t.rows, t.cols,
                           grid_m=jmeta.grid_m, grid_n=jmeta.grid_n)
    got = bsm.bsmm_fwd_plain(tensor_from_numpy(np.asarray(x), "cpu"),
                             tensor_from_numpy(np.asarray(values), "cpu"),
                             torch.as_tensor(np.array(t.rows)),
                             torch.as_tensor(np.array(t.cols)), None, grid_n=jmeta.grid_n)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), rtol=5e-2, atol=5e-2)
    # one rounding of the f32 sum: the f32 plain version, rounded, bit for bit
    f32 = bsm.bsmm_fwd_plain(got.new_tensor(np.asarray(x, np.float32)).float(),
                             torch.as_tensor(np.asarray(values, np.float32)),
                             torch.as_tensor(np.array(t.rows)),
                             torch.as_tensor(np.array(t.cols)), None, grid_n=jmeta.grid_n)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(f32.to(torch.bfloat16)))


@pytest.mark.parametrize("alpha", [0.6, 0.75])
@pytest.mark.parametrize("layer_index", [1, 2])
def test_bias_all_relu_plain_bf16_bit_equal_to_pallas(alpha, layer_index):
    rng = np.random.default_rng(layer_index)
    x = jnp.asarray(rng.standard_normal((37, 96)) * 3, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((96,)) * 3, jnp.bfloat16)
    want = jbias_all_relu(x, b, alpha=alpha, layer_index=layer_index, interpret=True)
    got = all_relu_fused.bias_all_relu(tensor_from_numpy(np.asarray(x), "cpu"),
                                       tensor_from_numpy(np.asarray(b), "cpu"), alpha=alpha,
                                       layer_index=layer_index)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("alpha", [0.6, 0.75])
@pytest.mark.parametrize("layer_index", [1, 2])
def test_all_relu_bf16_bias_free_bit_equal_to_traced_reference(alpha, layer_index):
    """The LM's case: no bias, the layer index traced (inside the
    reference's scan), so the slope is cast to bf16 there."""
    x = jnp.asarray(np.random.default_rng(3).standard_normal((8, 160)) * 2, jnp.bfloat16)
    want = jax.jit(lambda x, li: jall_relu(x, alpha, li))(x, jnp.int32(layer_index))
    xt = tensor_from_numpy(np.asarray(x), "cpu")
    got = all_relu_fused.bias_all_relu(xt, None, alpha=alpha, layer_index=layer_index)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    # f32 keeps its bits: the rounded slope is the f32 slope
    xf = xt.float()
    np.testing.assert_array_equal(
        _np(ref.all_relu_ref(xf, alpha, layer_index)),
        _np(torch.where(xf > 0, xf, ref.slope_for(alpha, layer_index) * xf)))


@pytest.mark.parametrize("shape", SHAPES + [(8, 3, 4, 32, 32, 0.5), (24, 2, 3, 128, 128, 0.7),
                                   (8, 8, 2, 32, 32, 1.0)])
@pytest.mark.parametrize("layer_index", [1, 2])
def test_bsmm_fwd_all_relu_store_plain_is_c_then_b(shape, layer_index):
    """Kernel C with All-ReLU in its store, on the CPU (its plain version):
    bit-equal in bf16 to kernel C's plain version followed by kernel B's,
    and held to the reference's Pallas ``bsmm_fwd`` (interpret) followed by
    its ``bias_all_relu`` at the bf16 tolerance of C alone."""
    jmeta, jtopo, values, x = _bsmm_case(shape, jnp.bfloat16)
    t = jtopo.device_arrays()
    xt, vt = _t(x), _t(values)
    rows, cols = torch.as_tensor(np.array(t.rows)), torch.as_tensor(np.array(t.cols))
    got = bsm.bsmm_fwd(xt, vt, rows, cols, None, grid_n=jmeta.grid_n,
                       all_relu=(0.6, layer_index))
    c = bsm.bsmm_fwd_plain(xt, vt, rows, cols, None, grid_n=jmeta.grid_n)
    want = all_relu_fused.bias_all_relu_plain(c, None, alpha=0.6, layer_index=layer_index)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))
    jc = jbsmm_fwd(x, values, t.rows, t.cols, t.first_col, grid_n=jmeta.grid_n, block_b=8,
                   interpret=True)
    jwant = jbias_all_relu(jc, jnp.zeros((jc.shape[1],), jnp.bfloat16), alpha=0.6,
                           layer_index=layer_index, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(jwant, np.float32), rtol=1e-2, atol=1e-2)


# (name, nb, grid_n, rows, bm, bn, bf16, aligned) -> (route, parts, tile_rows): the
# served sparse FFN (W_in 22 tiles over 22 block-columns, W_out 15 over 8)
# at 1 row, the decode rows (8, 16), one past them, and the prefills (64,
# 128, 256); W_in's grid with columns of 8 slots (the card's ring checks); the reference sweep's 8- and 16-wide tiles; f32; unaligned
FWD_PLAN_CASES = [
    (("win", 22, 22, 1, 128, 128, True, True), ("decode", 1, 0)),
    (("win", 22, 22, 8, 128, 128, True, True), ("decode", 1, 0)),
    (("win", 22, 22, 16, 128, 128, True, True), ("decode", 1, 0)),
    (("win", 22, 22, 17, 128, 128, True, True), ("rows", 1, 32)),
    (("win", 22, 22, 64, 128, 128, True, True), ("rows", 1, 32)),
    (("win", 22, 22, 128, 128, 128, True, True), ("rows", 1, 32)),
    (("win", 22, 22, 256, 128, 128, True, True), ("rows", 1, 64)),
    (("wout", 15, 8, 1, 128, 128, True, True), ("decode", 1, 0)),
    (("wout", 15, 8, 8, 128, 128, True, True), ("decode", 1, 0)),
    (("wout", 15, 8, 16, 128, 128, True, True), ("decode", 1, 0)),
    (("wout", 15, 8, 64, 128, 128, True, True), ("rows", 1, 32)),
    (("wout", 15, 8, 128, 128, 128, True, True), ("rows", 1, 32)),
    (("wout", 15, 8, 256, 128, 128, True, True), ("rows", 1, 32)),
    (("columns of 8", 176, 22, 8, 128, 128, True, True), ("decode", 1, 0)),
    (("columns of 8", 176, 22, 16, 128, 128, True, True), ("decode", 1, 0)),
    (("columns of 8", 176, 22, 64, 128, 128, True, True), ("rows", 1, 32)),
    (("columns of 8", 176, 22, 256, 128, 128, True, True), ("rows", 1, 64)),
    (("sweep 8x16", 4, 3, 8, 8, 16, True, True), ("tiled", 2, 0)),
    (("sweep 16x16", 6, 4, 16, 16, 16, True, True), ("tiled", 2, 0)),
    (("sweep 8x8", 13, 5, 32, 8, 8, True, True), ("tiled", 3, 0)),
    (("sweep 16x8", 2, 2, 8, 16, 8, True, True), ("tiled", 1, 0)),
    (("f32 wout", 15, 8, 8, 128, 128, False, True), ("tiled", 2, 0)),
    (("unaligned wout", 15, 8, 8, 128, 128, True, False), ("tiled", 2, 0)),
]


@pytest.mark.parametrize("case,want", FWD_PLAN_CASES, ids=[f"{c[0]}-{c[3]}" for c, _ in
                                                           FWD_PLAN_CASES])
def test_fwd_plan_routes(case, want):
    """Kernel C's route rule on host ints: the bf16 decode route up to 16
    rows (16 features a block), the rows route above (32 x 32 tiles where
    their blocks fit one wave, else 64 x 64), neither with a second pass;
    everything else the tiled route with ``fwd_parts``' split."""
    _, nb, grid_n, rows, bm, bn, bf16, aligned = case
    plan = bsm.fwd_plan(nb, grid_n, rows, bm, bn, bf16=bf16, aligned=aligned)
    assert (plan.route, plan.parts, plan.tile_rows) == want
    if plan.route == "tiled":
        assert plan.parts == bsm.fwd_parts(nb, grid_n, rows, bn)
    else:
        assert plan.tile_feat == (16 if plan.route == "decode" else plan.tile_rows)


def test_fwd_plan_decode_tile_does_not_depend_on_the_batch():
    """A decode-route row's bits may not depend on the call's other rows:
    the route's block tile is the same at every batch it takes."""
    plans = {bsm.fwd_plan(15, 8, b, 128, 128, bf16=True)._replace(parts=1)
             for b in range(1, bsm.DECODE_ROWS + 1)}
    assert len(plans) == 1 and plans.pop().route == "decode"


def test_bsmm_infer_calls_kernel_c_without_autograd(monkeypatch):
    """The serving product calls kernel C directly: it never enters the
    training path's autograd Function, and with ``all_relu`` it is the
    product followed by All-ReLU (in C's store in bf16, kernel B after C's
    f32 instance)."""
    from repro_torch.kernels import ops as kops

    def refuse(*args, **kwargs):
        raise AssertionError("bsmm_infer entered _BsmmCore")

    monkeypatch.setattr(kops._BsmmCore, "apply", refuse)
    rng = np.random.default_rng(4)
    meta = BlockMeta(40, 56, 16, 16)
    topo = BlockTopology.erdos_renyi(meta, 0.5, rng)
    arrays = topo.device_arrays(torch.device("cpu"))
    for dtype in (torch.float32, torch.bfloat16):
        values = topo.init_values(rng, dtype=dtype, device=torch.device("cpu"))
        values.requires_grad_(True)
        x = torch.as_tensor(rng.standard_normal((3, 2, 40)).astype(np.float32)).to(dtype)
        y = kops.bsmm_infer(x, values, arrays, meta)
        assert y.shape == (3, 2, 56) and y.dtype == dtype and y.grad_fn is None
        want = kops.bsmm_xla(x, values, arrays, meta)
        np.testing.assert_allclose(_np(y), _np(want), rtol=1e-2, atol=1e-2)
        fused = kops.bsmm_infer(x, values, arrays, meta, all_relu=(0.6, 2))
        after = all_relu_fused.bias_all_relu_plain(y, None, alpha=0.6, layer_index=2)
        np.testing.assert_array_equal(_np(fused), _np(after))


# ---------------------------------------------------------------------------
# layers, f32
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    bias = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        _np(L.rmsnorm({"scale": _t(scale)}, _t(x))),
        np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        _np(L.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x))),
        np.asarray(JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                                jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope_matches_reference(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.arange(6) if not per_row else rng.integers(0, 100, (2, 6))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)
    got = L.apply_rope(_t(x), torch.as_tensor(pos), theta=1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def _attn_params(cfg, rng):
    dm, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": rng.standard_normal((dm, h * d)), "wk": rng.standard_normal((dm, kv * d)),
         "wv": rng.standard_normal((dm, kv * d)), "wo": rng.standard_normal((h * d, dm)),
         "bq": rng.standard_normal(h * d), "bk": rng.standard_normal(kv * d),
         "bv": rng.standard_normal(kv * d)}
    return {k: (0.2 * v).astype(np.float32) for k, v in p.items()}


ATTN_CASES = [  # window, softcap, prefix
    (None, None, None), (5, None, None), (None, 30.0, None), (None, None, 4), (5, 30.0, None),
]


@pytest.mark.parametrize("mode,window,softcap,prefix", [
    (mode, *case) for mode in ("train", "prefill", "decode") for case in ATTN_CASES
    if not (mode == "decode" and case[2] is not None)  # decode takes no prefix mask
])
def test_attention_fwd_matches_reference(mode, window, softcap, prefix):
    kw = dict(n_heads=4, n_kv=2, head_dim=8, d_model=32, qkv_bias=True, window=window,
              softcap=softcap, kv_chunk=5)
    jcfg, cfg = JL.AttnConfig(**kw), L.AttnConfig(**kw)
    rng = np.random.default_rng(2)
    p = _attn_params(cfg, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    S = 11
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    if mode != "decode":
        want, wc = JL.attention_fwd(jp, jnp.asarray(x), jcfg, positions=jnp.arange(S),
                                    mode=mode, prefix_len=prefix)
        got, gc = L.attention_fwd(tp, _t(x), cfg, positions=torch.arange(S), mode=mode,
                                  prefix_len=prefix)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        if mode == "prefill":
            for k in ("k", "v"):
                np.testing.assert_allclose(_np(gc[k]), np.asarray(wc[k]), **TOL)
        else:
            assert gc is None and wc is None
        return
    # decode 3 steps into a cache prefilled with random keys and values
    cache = {k: rng.standard_normal((2, 16, 2, 8)).astype(np.float32) for k in ("k", "v")}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = {k: _t(v) for k, v in cache.items()}
    for pos in (4, 5, 6):
        xs = x[:, pos:pos + 1]
        want, jc = JL.attention_fwd(jp, jnp.asarray(xs), jcfg, positions=jnp.array([pos]),
                                    mode="decode", cache=jc)
        got, tc = L.attention_fwd(tp, _t(xs), cfg, positions=torch.tensor([pos]),
                                  mode="decode", cache=tc)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]), **TOL)


def test_attention_decode_per_row_positions_match_one_row_each():
    """The engine's decode: rows at their own positions give what each row
    gives alone (the reference's vmap of a batch-1 decode)."""
    kw = dict(n_heads=4, n_kv=2, head_dim=8, d_model=32, qkv_bias=True, kv_chunk=7, window=6)
    jcfg, cfg = JL.AttnConfig(**kw), L.AttnConfig(**kw)
    rng = np.random.default_rng(4)
    p = _attn_params(cfg, rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    cache = {k: rng.standard_normal((3, 16, 2, 8)).astype(np.float32) for k in ("k", "v")}
    pos = np.array([3, 15, 9])
    tc = {k: _t(v) for k, v in cache.items()}
    got, tc = L.attention_fwd({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                              positions=torch.as_tensor(pos)[:, None], mode="decode", cache=tc)
    for b in range(3):
        want, jc = JL.attention_fwd(jp, jnp.asarray(x[b:b + 1]), jcfg,
                                    positions=jnp.array([pos[b]]), mode="decode",
                                    cache={k: jnp.asarray(v[b:b + 1]) for k, v in cache.items()})
        np.testing.assert_allclose(_np(got[b:b + 1]), np.asarray(want), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k][b:b + 1]), np.asarray(jc[k]), **TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_causal_skip_attention_matches_reference(window):
    kw = dict(n_heads=4, n_kv=2, head_dim=8, d_model=32, window=window, kv_chunk=8)
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 32, h, 8)).astype(np.float32) for h in (4, 2, 2))
    want = JL._causal_skip_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     JL.AttnConfig(**kw), jnp.arange(32))
    got = L._causal_skip_attention(_t(q), _t(k), _t(v), L.AttnConfig(**kw), torch.arange(32))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer_index", [1, 2])
def test_sparse_ffn_matches_reference(layer_index):
    sc = JL.SparseFFNConfig(block_m=16, block_n=16, density=0.5)
    rng = np.random.default_rng(5)
    jp, _, (jt_in, jt_out), metas = JL.init_sparse_ffn(rng, 64, 48, sc, jnp.float32)
    tsc = L.SparseFFNConfig(block_m=16, block_n=16, density=0.5)
    tp, (t_in, t_out), tmetas = L.init_sparse_ffn(np.random.default_rng(5), 64, 48, tsc,
                                                  torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(t_in.rows, jt_in.rows)
    np.testing.assert_array_equal(t_out.cols, jt_out.cols)
    np.testing.assert_array_equal(_np(tp["win"]), np.asarray(jp["win"]))
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = JL.sparse_ffn_fwd(jp, jt_in.device_arrays(), jt_out.device_arrays(), metas,
                             jnp.asarray(x), sc, layer_index)
    got = L.sparse_ffn_fwd(tp, t_in.device_arrays(torch.device("cpu")),
                           t_out.device_arrays(torch.device("cpu")), tmetas, _t(x), tsc,
                           layer_index)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("layer_index", [1, 2])
def test_sparse_ffn_bf16_with_all_relu_in_w_in_store(layer_index):
    """The bf16 sparse FFN, W_in with All-ReLU in kernel C's store: bit-equal
    to kernel C, kernel B and kernel C as three calls of their plain
    versions, and within the reference's bf16 tolerance of the reference's
    ``sparse_ffn_fwd`` run in f32 on the same bf16 weights and inputs (its
    CPU backend has no bf16 x bf16 -> f32 dot)."""
    sc = JL.SparseFFNConfig(block_m=16, block_n=16, density=0.5)
    rng = np.random.default_rng(6)
    jp, _, (jt_in, jt_out), metas = JL.init_sparse_ffn(rng, 64, 48, sc, jnp.bfloat16)
    tsc = L.SparseFFNConfig(block_m=16, block_n=16, density=0.5)
    tp, (t_in, t_out), tmetas = L.init_sparse_ffn(np.random.default_rng(6), 64, 48, tsc,
                                                  torch.bfloat16, torch.device("cpu"))
    np.testing.assert_array_equal(_bf16_bits(tp["wout"]), _bf16_bits(jp["wout"]))
    x = jnp.asarray(rng.standard_normal((3, 5, 64)), jnp.bfloat16)
    a_in, a_out = (t.device_arrays(torch.device("cpu")) for t in (t_in, t_out))
    got = L.sparse_ffn_fwd(tp, a_in, a_out, tmetas, _t(x), tsc, layer_index)
    assert got.dtype == torch.bfloat16
    x2 = _t(x).reshape(15, 64)
    h = bsm.bsmm_fwd_plain(x2, tp["win"], a_in.rows, a_in.cols, None, grid_n=tmetas[0].grid_n)
    h = all_relu_fused.bias_all_relu_plain(h, None, alpha=tsc.alpha, layer_index=layer_index)
    y = bsm.bsmm_fwd_plain(h, tp["wout"], a_out.rows, a_out.cols, None, grid_n=tmetas[1].grid_n)
    np.testing.assert_array_equal(_bf16_bits(got.reshape(15, 64)), _bf16_bits(y))
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    want = JL.sparse_ffn_fwd(j32, jt_in.device_arrays(), jt_out.device_arrays(), metas,
                             x.astype(jnp.float32), sc, layer_index)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# PatternLM
# ---------------------------------------------------------------------------


def _port_of(jm, device="cpu"):
    """The port's twin of a reference ``PatternLM``: its params and
    topologies, carried over as numpy."""
    topos = {slot: [((a.rows, a.cols), (b.rows, b.cols)) for a, b in reps]
             for slot, reps in jm.topologies.items()}
    return lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params),
                         topos, seed=jm._seed, device=device)


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape)


PATTERNS = {
    "global": dict(),
    "local_global": dict(pattern=("local", "global"), n_layers=3, window=4),
}


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_pattern_lm_train_and_prefill_match_reference(pattern):
    jm = JPatternLM(dataclasses.replace(JLM_CFG, **PATTERNS[pattern]), seed=0)
    tm = _port_of(jm)
    toks = _tokens(jm.cfg, (2, 10))
    want, _, _ = jm.forward(jm.params, jnp.asarray(toks, jnp.int32), topo=jm.topo_arrays())
    got, none, aux = tm.forward(tm.params, torch.as_tensor(toks), topo=tm.topo_arrays())
    np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)
    assert none is None and float(aux) == 0.0
    want, wc, _ = jm.forward(jm.params, jnp.asarray(toks, jnp.int32), topo=jm.topo_arrays(),
                             mode="prefill")
    got, gc, _ = tm.forward(tm.params, torch.as_tensor(toks), topo=tm.topo_arrays(),
                            mode="prefill")
    np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)
    want_named, _ = _flatten_with_names(wc)
    got_named, _ = tree_flatten_with_names(gc)
    assert [n for n, _ in got_named] == [n for n, _ in want_named]
    for (_, g), (_, w) in zip(got_named, want_named):
        np.testing.assert_allclose(_np(g), np.asarray(w), **LM_TOL)
    # the steps of launch/steps.py
    last = make_prefill_step(tm)(tm.params, {"tokens": torch.as_tensor(toks)},
                                 tm.topo_arrays())
    np.testing.assert_allclose(_np(last), _np(got[:, -1:]), rtol=0, atol=0)


@pytest.mark.parametrize("pattern", ["global", "local_global"])
def test_pattern_lm_decode_matches_teacher_forced(pattern):
    """The reference's tests/test_model_numerics.py check on the port, and
    each step against the reference's own decode."""
    jm = JPatternLM(dataclasses.replace(JLM_CFG, decode_window_cache=False,
                                        **PATTERNS[pattern]), seed=0)
    tm = _port_of(jm)
    S = 9
    toks = _tokens(jm.cfg, (2, S), seed=1)
    full, _, _ = tm.forward(tm.params, torch.as_tensor(toks), topo=tm.topo_arrays())
    topo = tm.topo_arrays()
    caches = tm.init_caches(2, S, dtype=torch.float32)
    jtopo = jm.topo_arrays()
    jcaches = jm.init_caches(2, S, dtype=jnp.float32)
    decode = make_decode_step(tm)
    outs = []
    for pos in range(S):
        lg, caches = decode(tm.params, {"tokens": torch.as_tensor(toks[:, pos:pos + 1]),
                                        "position": pos, "caches": caches}, topo)
        jl, jcaches, _ = jm.forward(jm.params, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                    topo=jtopo, positions=jnp.array([pos]), mode="decode",
                                    caches=jcaches)
        np.testing.assert_allclose(_np(lg), np.asarray(jl), **LM_TOL)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full), rtol=5e-3, atol=5e-3)


def test_ring_cache_decode_matches_full_cache():
    """The reference's ring-cache check (tests/test_model_numerics.py:193)
    on the port: a windowed ring cache agrees with a full cache."""
    base = dict(name="t", vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv=2, head_dim=8,
                d_ff=48, pattern=("local",), window=6, dtype="float32", kv_chunk=8,
                remat="none")
    m_full = PatternLM(ModelConfig(**base, decode_window_cache=False), seed=0, device="cpu")
    m_ring = PatternLM(ModelConfig(**base, decode_window_cache=True), seed=0, device="cpu")
    S = 16
    toks = torch.as_tensor(_tokens(m_full.cfg, (1, S), seed=1))
    c_full = m_full.init_caches(1, S, dtype=torch.float32)
    c_ring = m_ring.init_caches(1, S, dtype=torch.float32)
    assert c_ring["stack"]["s0_local"]["k"].shape[2] == 6
    for pos in range(S):
        lf, c_full, _ = m_full.forward(m_full.params, toks[:, pos:pos + 1],
                                       positions=torch.tensor([pos]), mode="decode",
                                       caches=c_full)
        lr, c_ring, _ = m_ring.forward(m_ring.params, toks[:, pos:pos + 1],
                                       positions=torch.tensor([pos]), mode="decode",
                                       caches=c_ring)
        np.testing.assert_allclose(_np(lf), _np(lr), rtol=5e-3, atol=5e-3)


def test_pattern_lm_bf16_within_reference_tolerance():
    """The port's bf16 model against the reference's forward of the same
    bf16 weights. The reference's CPU backend cannot run its own bf16 model
    (XLA's CPU dot has no bf16 x bf16 -> f32 kernel for ``bsmm_xla``'s
    einsum), so it computes in f32 on the weights rounded to bf16: that
    holds the port's bf16 arithmetic to the exact result at 5e-2."""
    jm = JPatternLM(dataclasses.replace(JLM_CFG, dtype="bfloat16"), seed=0)
    tm = _port_of(jm)
    assert tm.params["embed"]["table"].dtype == torch.bfloat16
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jm.params)
    jm.cfg = dataclasses.replace(jm.cfg, dtype="float32")
    toks = _tokens(jm.cfg, (2, 10), seed=2)
    want, _, _ = jm.forward(j32, jnp.asarray(toks, jnp.int32), topo=jm.topo_arrays())
    got, _, _ = tm.forward(tm.params, torch.as_tensor(toks), topo=tm.topo_arrays())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_seed_gives_reference_topologies_and_sparse_values(pattern):
    jm = JPatternLM(dataclasses.replace(JLM_CFG, **PATTERNS[pattern]), seed=3)
    tm = PatternLM(dataclasses.replace(LM_CFG, **PATTERNS[pattern]), seed=3, device="cpu")
    assert list(tm.topologies) == list(jm.topologies)
    for slot, reps in jm.topologies.items():
        assert len(tm.topologies[slot]) == len(reps)
        for (ja, jb), (ta, tb) in zip(reps, tm.topologies[slot]):
            for j, t in ((ja, ta), (jb, tb)):
                np.testing.assert_array_equal(t.rows, j.rows)
                np.testing.assert_array_equal(t.cols, j.cols)
    jl, _ = _flatten_with_names(jm.params)
    tl, _ = tree_flatten_with_names(tm.params)
    assert [n for n, _ in tl] == [n for n, _ in jl]
    for (name, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(np.asarray(j).shape), name
        if name.endswith(("ffn__win", "ffn__wout")):
            np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=name)


def test_full_width_qwen_sparse_ffn_tiles():
    """The served model's sparse FFN at full width (seed 0): W_in 22 of 8x22
    tiles, W_out 15 of 22x8, every output block-column covered."""
    cfg = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").config, ffn="sparse")
    rng = np.random.default_rng(0)
    ffn = cfg.sparse_cfg()
    t_in = BlockTopology.from_epsilon(BlockMeta(cfg.d_model, cfg.d_ff, 128, 128),
                                      ffn.epsilon, rng)
    t_out = BlockTopology.from_epsilon(BlockMeta(cfg.d_ff, cfg.d_model, 128, 128),
                                       ffn.epsilon, rng)
    jrng = np.random.default_rng(0)
    j_in = JTopo.from_epsilon(JMeta(1024, 2816, 128, 128), 64.0, jrng)
    j_out = JTopo.from_epsilon(JMeta(2816, 1024, 128, 128), 64.0, jrng)
    assert (t_in.n_blocks, t_out.n_blocks) == (22, 15) == (j_in.n_blocks, j_out.n_blocks)
    np.testing.assert_array_equal(t_out.cols, j_out.cols)
    counts = np.bincount(t_out.cols, minlength=8)
    assert counts.min() >= 1 and counts.max() == 4


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_lm_params_round_trip_through_names(pattern):
    """``tree.py`` names the LM's nested params (``rest`` a list, empty for
    qwen's 2 = 2 x 1 layers) as jax names them, and rebuilds the tree."""
    jm = JPatternLM(dataclasses.replace(JLM_CFG, **PATTERNS[pattern]), seed=0)
    tm = _port_of(jm)
    assert isinstance(tm.params["rest"], list)
    assert len(tm.params["rest"]) == jm.cfg.remainder
    named, unflatten = tree_flatten_with_names(tm.params)
    want, _ = _flatten_with_names(jm.params)
    assert [n for n, _ in named] == [n for n, _ in want]
    rebuilt = unflatten([t.clone() for _, t in named])
    assert isinstance(rebuilt["rest"], list)
    again, _ = tree_flatten_with_names(rebuilt)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(named, again))
    moved = tree_map(lambda a: a + 0, tm.params)
    assert isinstance(moved["rest"], list) and len(moved["rest"]) == jm.cfg.remainder


def test_registry_matches_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    for arch in configs.list_archs():
        spec, jspec = configs.get_spec(arch), jconfigs.get_spec(arch)
        for mine, theirs in ((spec.config, jspec.config), (spec.smoke, jspec.smoke)):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), arch
        assert (spec.family, spec.shapes, spec.source) == (jspec.family, jspec.shapes,
                                                           jspec.source)
    assert configs.SHAPES == jconfigs.SHAPES
    assert dataclasses.fields(ModelConfig) and [f.name for f in dataclasses.fields(
        ModelConfig)] == [f.name for f in dataclasses.fields(JModelConfig)]


@pytest.mark.parametrize("arch,what", [
    ("qwen3-moe-30b-a3b", "'moe'"),
    ("falcon-mamba-7b", "'mamba'"),
    ("recurrentgemma-2b", "'rglru'"),
])
def test_unported_blocks_are_refused(arch, what):
    """The model builds (``tests/test_torch_arch_smoke.py``); the serving
    engine refuses it: a recurrent pattern as the reference's engine does
    (a prefill returns no state), the MoE FFN naming its ROADMAP item."""
    model = PatternLM(configs.get_spec(arch).smoke, seed=0, device="cpu")
    if what == "'moe'":
        with pytest.raises(NotImplementedError, match="MoE in the serving engine.*item 17"):
            SparseInferenceEngine(model, device="cpu")
    else:
        with pytest.raises(ValueError, match=f"attention patterns only.*{what}"):
            SparseInferenceEngine(model, device="cpu")


def test_whisper_and_abstract_are_refused():
    """Whisper is ported (``tests/test_torch_whisper.py``): its spec is the
    reference's and its step builders take it. The shape-only build is
    still refused (Queue 1, item 9)."""
    spec = configs.get_spec("whisper-medium")
    assert type(spec.config).__name__ == "WhisperConfig" and spec.family == "audio"
    from repro_torch.models.whisper import WhisperModel

    prefill = make_prefill_step(WhisperModel(spec.smoke, seed=0, device="cpu"))
    assert prefill.__name__ == "prefill_w"
    with pytest.raises(TypeError, match="abstract"):  # no shape-only build (Queue 1, item 9)
        PatternLM(LM_CFG, seed=0, abstract=True, device="cpu")
