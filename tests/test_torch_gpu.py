"""The port's CUDA kernels, its serving path and its block training step on
the card, against their plain PyTorch versions. Every test here carries the
``gpu`` marker and skips where there is no card; the file imports no JAX,
so it runs on a machine that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Kernel A sums each segment in slot order, the plain version through
``index_add_`` (atomics on the card), so they are held at rtol/atol 1e-5;
its two routes are held bit-equal to each other, and dropping zero-valued
slots is held bit-equal (lossless compaction). Its epilogue (bias, then
All-ReLU) is held bit-equal to kernel A followed by kernel B, on both
routes. Kernel B does the plain version's f32 arithmetic and is held
bit-equal, on contiguous rows and on rows at a pitch. Kernels C, D and E sum in
another order than the plain versions' einsums (up to K = 4096 products per
output, in 3xTF32 on the tensor cores, as accurate as f32), so they are held
at rtol/atol 1e-4; uncovered dx block-rows are held exactly 0, and launches
on the same inputs are held bit-equal (the kernels split long sums, and add
the partials in a fixed order). Device SET evolution is held slot for slot
to its numpy version fed the same draws, and runs without a host sync;
kernel F over the run plan made on the device (padded) is held bit-equal
to the host-made plan. A training run on the card, saved at every epoch and
resumed from epoch 0 in a fresh trainer, is held bit-equal to the run that
never stopped. The out-of-core stream: K8 over shards (segments across
shard edges, padded tails) bit-equal to kernels A and F over the whole
layer and within 1e-5 of the plain versions; kernel B's (features, batch)
pass bit-equal to A's fused store; the pinned ring against a run
synchronised after every copy, with each copy held back ~10 ms, bit-equal;
a streamed step bit-equal to the in-core step. The bfloat16 LM: kernel C's
bf16 instance within 1e-2 of its plain version (both round an f32 sum
once, in other orders) and 5e-2 of ``ref.bsmm_ref`` (the reference's bf16
tolerance), on the reference's kernel sweep and the full-width sparse FFN,
bit-equal over 3 launches, on the route ``fwd_plan`` gives (one launch, no
second pass on the served shapes); its All-ReLU store bit-equal to kernel
C followed by kernel B on every route; columns longer than the new
routes' rings held the same way; a decode-route row the same alone
as within 8 or 16 rows; kernel B's bf16 entry bit-equal to its plain
version, with and without a bias; the smoke LM in bf16 on the card within
5e-2 of the CPU run, on kernel C with All-ReLU in W_in's store, served
through the batcher. Its training backward: kernels D and E bf16 within
1e-2 of their plain versions and 5e-2 of ``ref.bsmm_*_ref`` at 1 to 4,100
rows (every cluster size of E, ragged last chunks), on every layer's
topology of the served model, long block-rows and tile sides from 16 to
128, bit-equal over 3 launches, counted as bf16 launches with no second
pass; the bf16 block op's gradients within 5e-2 of ``bsmm_xla``'s; the
smoke LM's bf16 train step on the card within 5e-2 of the f32 step.
recurrentgemma-2b's sparse FFN grids (W_in 20 x 60, W_out 60 x 20): C, D
and E bf16 held the same way, on columns and block-rows longer than their
rings. The RG-LRU, Mamba-1 and MoE smoke models in f32 on the card within
1e-4 of the CPU run (logits, loss with the auxiliary loss, gradients, a
decode step). The observability layer: a span that ``block_on``s kernel A's
result closes after the kernel ends (its duration at least the kernel's
CUDA-event time); ``sample_device_memory`` reads the allocator's figures;
the probed segment's stats on the card within 1e-4 of the CPU's (the
histograms equal), its weights and losses bit-equal to the unprobed
segment's, and its launches exactly the steps' plus one forward (A storing
z + bias, B's All-ReLU) and one backward (F, G standalone, A's dX). Whisper
cut to 2 + 2 layers at full width in f32: logits within 1e-4 of the CPU's,
gradients within 1e-4 relative L2 a leaf, the cross attention's bias
gradients exact zeros.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.set_mlp import mlp_config
from repro_torch.core import sparsity as tsp
from repro_torch.core.topology import (
    block_device_arrays,
    element_device_arrays,
    evolution_draws,
    evolve_block_device,
    evolve_block_device_reference,
    evolve_block_layers_device,
    evolve_element_device,
    evolve_element_device_reference,
    evolve_element_layers_device,
)
from repro_torch.core.importance import PruningSchedule
from repro_torch.data.datasets import load
from repro_torch.kernels import all_relu_fused
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import all_relu_ref, slope_for
from repro_torch.launch.steps import make_mlp_train_step
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, block_meta, mlp_forward
from repro_torch.optim.sgd import MomentumSGD
from repro_torch.serve import EngineConfig, SparseInferenceEngine, importance_prune_mlp
from repro_torch.train.trainer import SequentialTrainer, TrainerConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    return torch.device("cuda")


def _layer(seed, in_dim, out_dim, epsilon, batch):
    rng = np.random.default_rng(seed)
    topo = tsp.ElementTopology.erdos_renyi(in_dim, out_dim, epsilon, rng)
    vals = tsp._init_numpy(rng, (topo.nnz,), fan_in_dense=in_dim, scheme="he_uniform")
    x = rng.standard_normal((batch, in_dim)).astype(np.float32)
    return topo, vals, x


# (seed, in_dim, out_dim, epsilon, batch): batch 1, one slot per segment,
# long segments (400 wide, 80,000 connections) at batch 128
LAYERS = [(0, 96, 72, 9, 11), (1, 50, 40, 5, 1), (2, 33, 77, 3, 4), (3, 400, 400, 100, 128)]


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("case", LAYERS)
def test_kernel_a_matches_plain(cuda, case, with_acc):
    seed, in_dim, out_dim, eps, batch = case
    topo, vals, x = _layer(seed, in_dim, out_dim, eps, batch)
    t = topo.device_arrays(cuda)
    srcT = torch.as_tensor(np.ascontiguousarray(x.T), device=cuda)
    v = torch.as_tensor(vals, device=cuda)
    acc = torch.randn((out_dim, batch), device=cuda) if with_acc else None
    before = tsp.coo_matmul_T.launches
    got = tsp.coo_matmul_T(srcT, v, t.rows, t.cols, out_dim, acc=acc)
    torch.cuda.synchronize()
    assert tsp.coo_matmul_T.launches == before + 1
    want = tsp.coo_matmul_T_plain(srcT, v, t.rows, t.cols, out_dim, acc=acc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic, and the same with the offsets given
    again = tsp.coo_matmul_T(srcT, v, t.rows, t.cols, out_dim, acc=acc,
                             seg_ptr=torch.as_tensor(topo.col_ptr(), device=cuda))
    assert torch.equal(again, got)


@pytest.mark.parametrize("with_acc", [False, True])
def test_kernel_a_without_connections(cuda, with_acc):
    src = torch.randn((6, 3), device=cuda)
    acc = torch.randn((4, 3), device=cuda) if with_acc else None
    empty = torch.empty((0,), dtype=torch.int32, device=cuda)
    got = tsp.coo_matmul_T(src, torch.empty((0,), device=cuda), empty, empty, 4, acc=acc)
    torch.cuda.synchronize()
    assert torch.equal(got, acc if with_acc else torch.zeros((4, 3), device=cuda))


def test_kernel_a_validates_inputs(cuda):
    topo, vals, x = _layer(4, 20, 10, 3, 4)
    t = topo.device_arrays(cuda)
    srcT = torch.as_tensor(np.ascontiguousarray(x.T), device=cuda)
    v = torch.as_tensor(vals, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        tsp.coo_matmul_T(srcT.double(), v, t.rows, t.cols, 10)
    with pytest.raises(ValueError, match="contiguous"):
        tsp.coo_matmul_T(torch.as_tensor(x, device=cuda).T, v, t.rows, t.cols, 10)
    with pytest.raises(ValueError, match="dtype"):
        tsp.coo_matmul_T(srcT, v, t.rows.long(), t.cols, 10)
    with pytest.raises(ValueError, match="segment_idx.*shape"):
        tsp.coo_matmul_T(srcT, v, t.rows, t.cols[:-1], 10)
    with pytest.raises(ValueError, match="non-decreasing"):
        tsp.coo_matmul_T(srcT, v, t.rows, t.cols.flip(0), 10)
    # offsets that do not end at nnz would send kernel A past the slots
    bad = torch.as_tensor(topo.col_ptr(), device=cuda)
    bad[-1] += 1
    with pytest.raises(ValueError, match="seg_ptr"):
        tsp.coo_matmul_T(srcT, v, t.rows, t.cols, 10, seg_ptr=bad)


def _long_segments(counts, batch, seed=0, n_src=3000):
    """Segments of ``counts`` slots over ``n_src`` sources (distinct, sorted
    within a segment), he-uniform values and a normal srcT (n_src, batch)."""
    rng = np.random.default_rng(seed)
    gather = np.concatenate([np.sort(rng.choice(n_src, k, replace=False)) for k in counts])
    lim = np.sqrt(6.0 / n_src)
    vals = rng.uniform(-lim, lim, len(gather)).astype(np.float32)
    srcT = rng.standard_normal((n_src, batch)).astype(np.float32)
    return rng, gather.astype(np.int32), vals, srcT


def _offsets(counts):
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


# the served output layer's segment length, with an empty and a short one
LONG = [2800, 0, 37]


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("batch", [1, 5, 100, 128])
def test_kernel_a_routes_give_the_same_bits(cuda, batch, with_acc):
    """The staged route (16-byte copies at batch 100 and 128, 4-byte at 1
    and 5) and the one-thread route run the same chain: equal bits."""
    rng, gather, vals, srcT = _long_segments(LONG, batch)
    n = len(LONG)
    seg = torch.as_tensor(np.repeat(np.arange(n), LONG).astype(np.int32), device=cuda)
    g, v = torch.as_tensor(gather, device=cuda), torch.as_tensor(vals, device=cuda)
    src = torch.as_tensor(srcT, device=cuda)
    acc = torch.as_tensor(rng.standard_normal((n, batch)).astype(np.float32),
                          device=cuda) if with_acc else None
    seg_ptr = tsp.offsets_to_device(_offsets(LONG), cuda)
    assert tsp.coo_route(tsp._longest_segment(seg_ptr, len(gather), n)) == tsp.COO_STAGED
    got = {route: tsp._coo_matmul_T_cuda(src, v, g, seg, seg_ptr, n, acc, route)
           for route in (tsp.COO_THREAD, tsp.COO_STAGED)}
    torch.cuda.synchronize()
    assert torch.equal(got[tsp.COO_THREAD], got[tsp.COO_STAGED])
    torch.testing.assert_close(
        got[tsp.COO_STAGED], tsp.coo_matmul_T_plain(src, v, g, seg, n, acc=acc),
        rtol=1e-5, atol=1e-5)
    # an srcT 4 bytes past a 16-byte boundary takes the 4-byte copies
    flat = torch.empty(src.numel() + 1, device=cuda)
    src_u = flat[1:].view(src.shape)
    src_u.copy_(src)
    assert torch.equal(
        tsp._coo_matmul_T_cuda(src_u, v, g, seg, seg_ptr, n, acc, tsp.COO_STAGED),
        got[tsp.COO_THREAD])


@pytest.mark.parametrize("batch", [1, 128])
def test_kernel_a_drops_zero_slots_bit_equal(cuda, batch):
    """Lossless compaction on the card: zero a third of a 2,800-slot
    segment's values, then drop those slots and rebuild seg_ptr; the
    outputs are equal, bit for bit."""
    rng, gather, vals, srcT = _long_segments(LONG, batch)
    n = len(LONG)
    seg = np.repeat(np.arange(n), LONG).astype(np.int32)
    vals[rng.choice(len(vals), len(vals) // 3, replace=False)] = 0.0
    keep = vals != 0
    src = torch.as_tensor(srcT, device=cuda)
    outs = []
    for sel in (np.ones_like(keep), keep):
        kept = np.bincount(seg[sel], minlength=n)
        outs.append(tsp.coo_matmul_T(
            src, torch.as_tensor(vals[sel], device=cuda),
            torch.as_tensor(gather[sel], device=cuda), torch.as_tensor(seg[sel], device=cuda),
            n, seg_ptr=tsp.offsets_to_device(_offsets(kept), cuda)))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("shape", [(128, 4000), (1, 1000), (300, 40), (5, 1001), (3, 7)])
@pytest.mark.parametrize("layer_index", [1, 2, 3])
def test_kernel_b_matches_plain(cuda, shape, layer_index):
    rng = np.random.default_rng(layer_index)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    b = torch.as_tensor(rng.standard_normal(shape[1:]).astype(np.float32), device=cuda)
    before = all_relu_fused.bias_all_relu.launches
    got = all_relu_fused.bias_all_relu(x, b, alpha=0.75, layer_index=layer_index)
    torch.cuda.synchronize()
    assert all_relu_fused.bias_all_relu.launches == before + 1
    want = all_relu_fused.bias_all_relu_plain(x, b, alpha=0.75, layer_index=layer_index)
    assert torch.equal(got, want)


def test_kernel_b_validates_inputs(cuda):
    x = torch.randn((8, 16), device=cuda)
    b = torch.randn((16,), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        all_relu_fused.bias_all_relu(x.T, torch.randn((8,), device=cuda), alpha=0.5, layer_index=1)
    with pytest.raises(ValueError, match="dtype"):
        all_relu_fused.bias_all_relu(x.double(), b, alpha=0.5, layer_index=1)
    with pytest.raises(ValueError, match="shape"):
        all_relu_fused.bias_all_relu(x, b[:8], alpha=0.5, layer_index=1)


# -- kernel A's epilogue (kernel B fused into its store) ------------------------


def _a_then_b(yT, bias, alpha, layer_index):
    """Kernel A's output, then kernel B (in its (batch, features) layout) or
    the output layer's ``+ bias``: what the fused store must give."""
    if layer_index is None:
        return yT + bias[:, None]
    return all_relu_fused.bias_all_relu(yT.T.contiguous(), bias, alpha=alpha,
                                        layer_index=layer_index).T


# the served output layer's segment lengths (staged route) and a hidden-like
# layer (400 -> 400, 80,000 connections, one thread per output)
EPI_LAYERS = {"long": LONG, "hidden": None}


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("batch", [1, 5, 33, 128])
@pytest.mark.parametrize("layer", sorted(EPI_LAYERS))
def test_kernel_a_epilogue_is_kernel_a_then_b_bit_equal(cuda, layer, batch, with_acc):
    """On both routes, with and without a carry-in: the epilogue's store is
    bit-equal to kernel A followed by kernel B (both slope signs) or by
    ``+ bias``, and matches the plain version at A's tolerance."""
    if layer == "long":
        rng, gather, vals, srcT = _long_segments(LONG, batch)
        n = len(LONG)
        seg_np = np.repeat(np.arange(n), LONG).astype(np.int32)
        seg_ptr = tsp.offsets_to_device(_offsets(LONG), cuda)
    else:
        topo, vals, x = _layer(3, 400, 400, 100, batch)
        rng = np.random.default_rng(5)
        gather, seg_np, n, srcT = topo.rows, topo.cols, topo.out_dim, np.ascontiguousarray(x.T)
        seg_ptr = tsp.offsets_to_device(topo.col_ptr(), cuda)
    g, seg = torch.as_tensor(gather, device=cuda), torch.as_tensor(seg_np, device=cuda)
    v, src = torch.as_tensor(vals, device=cuda), torch.as_tensor(srcT, device=cuda)
    bias = torch.as_tensor(rng.standard_normal((n,)).astype(np.float32), device=cuda)
    acc = torch.as_tensor(rng.standard_normal((n, batch)).astype(np.float32),
                          device=cuda) if with_acc else None
    # A's tolerance is the product's (the plain version sums in another
    # order); the bias can cancel the product, so it is taken at the larger
    # of the product's and the result's magnitude
    plain = tsp.coo_matmul_T_plain(src, v, g, seg, n, acc=acc)
    for route in (tsp.COO_THREAD, tsp.COO_STAGED):
        base = tsp._coo_matmul_T_cuda(src, v, g, seg, seg_ptr, n, acc, route)
        for layer_index in (None, 1, 2):  # + bias; All-ReLU with +alpha and -alpha
            slope = None if layer_index is None else slope_for(0.75, layer_index)
            e0 = tsp.coo_matmul_T.epilogue_launches
            got = tsp._coo_matmul_T_cuda(src, v, g, seg, seg_ptr, n, acc, route,
                                         bias=bias, slope=slope)
            torch.cuda.synchronize()
            assert tsp.coo_matmul_T.epilogue_launches == e0 + 1
            assert torch.equal(got, _a_then_b(base, bias, 0.75, layer_index)), (route, layer_index)
            want = tsp.coo_epilogue(plain, bias, slope)
            assert bool((got - want).abs().le(
                1e-5 + 1e-5 * torch.maximum(plain.abs(), want.abs())).all())


def test_kernel_a_epilogue_validates_inputs(cuda):
    topo, vals, x = _layer(4, 20, 10, 3, 4)
    t = topo.device_arrays(cuda)
    args = (torch.as_tensor(np.ascontiguousarray(x.T), device=cuda),
            torch.as_tensor(vals, device=cuda), t.rows, t.cols, 10)
    bias = torch.randn((10,), device=cuda)
    before = tsp.coo_matmul_T.launches
    with pytest.raises(ValueError, match="dtype"):
        tsp.coo_matmul_T(*args, bias=bias.double())
    with pytest.raises(ValueError, match="bias has shape"):
        tsp.coo_matmul_T(*args, bias=bias[:9])
    with pytest.raises(ValueError, match="bias is on cpu"):
        tsp.coo_matmul_T(*args, bias=bias.cpu())
    with pytest.raises(ValueError, match="needs a bias"):
        tsp.coo_matmul_T(*args, slope=0.75)
    assert tsp.coo_matmul_T.launches == before  # no launch, and no plain fallback


@pytest.mark.parametrize("case", [
    ((128, 4096), np.s_[:, :4000]),  # the block model's padded product: 16-byte path
    ((512, 1024), np.s_[:, :1000]),
    ((5, 1003), np.s_[:, :1001]),    # a pitch that is no multiple of 4: scalar path
    ((4, 4004), np.s_[:, 1:4001]),   # 4 bytes past a 16-byte boundary: scalar path
    ((2, 3, 40), np.s_[..., :36]),   # leading dims
])
def test_kernel_b_reads_a_row_pitch(cuda, case):
    shape, sl = case
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)[sl]
    b = torch.as_tensor(rng.standard_normal(x.shape[-1:]).astype(np.float32), device=cuda)
    assert not x.is_contiguous()
    got = all_relu_fused.bias_all_relu(x, b, alpha=0.75, layer_index=2)
    torch.cuda.synchronize()
    assert got.is_contiguous() and got.shape == x.shape
    assert torch.equal(got, all_relu_fused.bias_all_relu_plain(x, b, alpha=0.75, layer_index=2))


def test_block_evaluation_runs_kernel_b_bit_equal(cuda):
    """The block model's no-grad forward runs kernel B on each hidden
    layer's product slice; the logits equal the plain ``act(h + bias)``
    after the same kernel C products, bit for bit."""
    cfg = SparseMLPConfig(layer_dims=(300, 200, 130, 10), epsilon=20, impl="block",
                          block_m=128, block_n=128, dropout=0.0)
    model = SparseMLP(cfg, seed=2, device=cuda)
    rng = np.random.default_rng(2)
    model.biases = [torch.as_tensor(rng.standard_normal(b.shape).astype(np.float32), device=cuda)
                    for b in model.biases]
    x = torch.as_tensor(rng.standard_normal((100, 300)).astype(np.float32), device=cuda)
    topo = model.topo_arrays()
    b0 = all_relu_fused.bias_all_relu.launches
    with torch.no_grad():
        got = mlp_forward(model.params(), topo, x, cfg)
        torch.cuda.synchronize()
        assert all_relu_fused.bias_all_relu.launches - b0 == cfg.n_layers - 1
        h = x
        for l in range(cfg.n_layers):
            h = ops.bsmm_kernel(h, model.values[l], topo[l], block_meta(cfg, l)) + model.biases[l]
            if l < cfg.n_layers - 1:
                h = all_relu_ref(h, cfg.alpha, l + 1)
    assert torch.equal(got, h)


def _model(device, seed=8):
    cfg = SparseMLPConfig(layer_dims=(32, 24, 20, 6), epsilon=6, dropout=0.0)
    model = SparseMLP(cfg, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    model.biases = [torch.as_tensor(rng.standard_normal(b.shape).astype(np.float32), device=device)
                    for b in model.biases]
    return model


def test_engine_on_card_matches_cpu_and_counts_launches(cuda):
    sched = PruningSchedule(tau=0, period=1, percentile=30.0)
    ec = EngineConfig(batch_buckets=(2, 4))
    card = SparseInferenceEngine(_model(cuda), compaction=sched, engine=ec)
    cpu = SparseInferenceEngine(_model("cpu"), compaction=sched, engine=ec, device="cpu")
    x = np.random.default_rng(9).standard_normal((9, 32)).astype(np.float32)
    a0, b0 = tsp.coo_matmul_T.launches, all_relu_fused.bias_all_relu.launches
    e0 = tsp.coo_matmul_T.epilogue_launches
    got = card.classify(x)
    forwards = 3  # 4 + 4 + (1 padded to 2)
    # one kernel A launch per layer, each with its bias (+ All-ReLU) epilogue;
    # kernel B's standalone pass does not run on the served path
    assert tsp.coo_matmul_T.launches - a0 == forwards * 3
    assert tsp.coo_matmul_T.epilogue_launches - e0 == forwards * 3
    assert all_relu_fused.bias_all_relu.launches - b0 == 0
    np.testing.assert_allclose(got, cpu.classify(x), rtol=1e-5, atol=1e-5)
    # lossless compaction holds bit for bit on the card
    pruned, _ = importance_prune_mlp(_model(cuda), sched)
    pruned_eng = SparseInferenceEngine(pruned, compact=False, engine=ec)
    np.testing.assert_array_equal(pruned_eng.classify(x), got)


# -- kernels C, D, E ----------------------------------------------------------

BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)

# (in_dim, out_dim, bm, bn, epsilon, batch): 128x128 tiles at the output
# layer's shape (one block-column, K = 4096), 8x8, a non-square 32x16 with
# padded features, and ragged batches
BLOCK_CASES = [
    (4000, 10, 128, 128, 20, 128),
    (1000, 4000, 128, 128, 20, 100),
    (64, 48, 8, 8, 6, 33),
    (100, 70, 32, 16, 8, 128),
    (100, 70, 32, 16, 8, 5),
]


def _block_layer(cuda, case, seed=0):
    in_dim, out_dim, bm, bn, eps, batch = case
    rng = np.random.default_rng(seed)
    meta = tsp.BlockMeta(in_dim, out_dim, bm, bn)
    topo = tsp.BlockTopology.from_epsilon(meta, eps, rng)
    values = topo.init_values(rng, device=cuda)
    x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(np.float32),
                        device=cuda)
    x[:, in_dim:] = 0
    dy = torch.as_tensor(rng.standard_normal((batch, meta.padded_out)).astype(np.float32),
                         device=cuda)
    return meta, topo, topo.device_arrays(cuda), values, x, dy


@pytest.mark.parametrize("case", BLOCK_CASES)
def test_kernels_c_d_e_match_plain(cuda, case):
    meta, topo, t, v, x, dy = _block_layer(cuda, case)
    before = (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches)
    y = bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    dx = bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
    dw = bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n)
    torch.cuda.synchronize()
    assert (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches) == tuple(
        b + 1 for b in before)
    torch.testing.assert_close(
        y, bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n),
        **BLOCK_TOL)
    want_dx = bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                grid_m=meta.grid_m)
    torch.testing.assert_close(dx, want_dx, **BLOCK_TOL)
    torch.testing.assert_close(
        dw, bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=meta.block_m,
                              block_n=meta.block_n), **BLOCK_TOL)
    # uncovered input block-rows: exact zeros
    uncovered = np.setdiff1d(np.arange(meta.grid_m), topo.rows)
    tiles = dx.reshape(dx.shape[0], meta.grid_m, meta.block_m)
    assert not tiles[:, torch.as_tensor(uncovered, device=cuda).long()].any()
    # deterministic: the same call gives the same bits
    assert torch.equal(y, bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n))
    assert torch.equal(dx, bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                       grid_m=meta.grid_m))
    assert torch.equal(dw, bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                       block_n=meta.block_n))


def test_block_kernels_refuse_what_they_cannot_take(cuda):
    meta = tsp.BlockMeta(512, 256, 256, 128)  # bm = 256 > 128
    topo = tsp.BlockTopology(meta, np.array([0, 1]), np.array([0, 1]))
    t = topo.device_arrays(cuda)
    v = torch.zeros((2, 256, 128), device=cuda)
    x = torch.zeros((4, 512), device=cuda)
    before = bsm.bsmm_fwd.launches
    with pytest.raises(ValueError, match="block size"):
        bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=2)
    with pytest.raises(ValueError, match="block size"):
        bsm.bsmm_dx(torch.zeros((4, 256), device=cuda), v, t.rows_r, t.cols_r, t.first_row,
                    t.perm_r, grid_m=2)
    with pytest.raises(ValueError, match="block size"):
        bsm.bsmm_dw(x, torch.zeros((4, 256), device=cuda), t.rows, t.cols, block_m=256,
                    block_n=128)
    assert bsm.bsmm_fwd.launches == before  # no launch, and no plain fallback
    meta, topo, t, v, x, dy = _block_layer(cuda, BLOCK_CASES[2])
    with pytest.raises(ValueError, match="dtype"):
        bsm.bsmm_fwd(x.double(), v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    with pytest.raises(ValueError, match="contiguous"):
        bsm.bsmm_dw(x.T.contiguous().T, dy, t.rows, t.cols, block_m=8, block_n=8)
    with pytest.raises(ValueError, match="non-decreasing"):
        bsm.bsmm_fwd(x, v, t.rows, t.cols.flip(0).contiguous(), t.first_col,
                     grid_n=meta.grid_n)
    with pytest.raises(ValueError, match="rows_r"):
        bsm.bsmm_dx(dy, v, t.rows_r.flip(0).contiguous(), t.cols_r, t.first_row, t.perm_r,
                    grid_m=meta.grid_m)


def test_block_op_gradients_match_plain_autograd(cuda):
    meta, topo, t, v, _, _ = _block_layer(cuda, (100, 70, 32, 16, 8, 0))
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 37, 100)).astype(np.float32), device=cuda)
    g = torch.as_tensor(rng.standard_normal((2, 37, 70)).astype(np.float32), device=cuda)
    grads = []
    for impl in ("kernel", "xla"):
        xx, vv = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
        (ops.bsmm(xx, vv, t, meta, impl=impl) * g).sum().backward()
        grads.append((xx.grad, vv.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], **BLOCK_TOL)
    torch.testing.assert_close(grads[0][1], grads[1][1], **BLOCK_TOL)


def test_full_width_block_train_step_matches_cpu(cuda):
    """One step of the full-width CIFAR-10 block model (3072-4000-1000-4000-10,
    128x128 tiles) on the card and on the CPU from the same state, and its
    launches: C 4, D 3 (layer 0's input needs no gradient), E 4."""
    cfg = mlp_config("cifar10", impl="block")
    cfg = dataclasses.replace(cfg, dropout=0.0)
    data = load("cifar10", scale=0.003)
    x, y = data.x_train[:128], data.y_train[:128]
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    step = make_mlp_train_step(cfg, opt)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = SparseMLP(cfg, seed=0, device=dev)
        before = (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches)
        p, s, loss = step(model.params(), opt.init(model.params()), model.topo_arrays(),
                          torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev).long(),
                          torch.tensor(0.01, device=dev), None)
        launches = tuple(a - b for a, b in zip(
            (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches), before))
        out[dev.type] = (p, s, loss, launches)
    assert out["cuda"][3] == (4, 3, 4) and out["cpu"][3] == (0, 0, 0)
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=1e-5)
    for k in ("values", "biases"):
        for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
        for a, b in zip(out["cuda"][1].velocity[k], out["cpu"][1].velocity[k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("impl", ["masked", "dense"])
def test_full_width_masked_dense_train_step_matches_cpu(cuda, impl):
    """One step of the paper's baselines at the full CIFAR-10 width
    (3072-4000-1000-4000-10) on the card and on the CPU from the same state:
    ``torch.matmul`` (IEEE f32), then plain autograd for bias and All-ReLU;
    no kernel launched; the masked model's weights off its mask unmoved by
    the gradient (only weight decay and momentum, which start at 0 here,
    reach them: with momentum 0 and no decay they stay as they were)."""
    cfg = dataclasses.replace(mlp_config("cifar10", impl=impl), dropout=0.0)
    data = load("cifar10", scale=0.003)
    x, y = data.x_train[:128], data.y_train[:128]
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    step = make_mlp_train_step(cfg, opt)
    wrappers = (bsm.bsmm_fwd, bsm.bsmm_dx, bsm.bsmm_dw, tsp.coo_matmul_T, tsp.coo_dw,
                all_relu_fused.bias_all_relu)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = SparseMLP(cfg, seed=0, device=dev)
        before = [w.launches for w in wrappers]
        p, s, loss = step(model.params(), opt.init(model.params()), model.topo_arrays(),
                          torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev).long(),
                          torch.tensor(0.01, device=dev), None)
        assert [w.launches for w in wrappers] == before
        out[dev.type] = (p, s, loss, model)
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=1e-5)
    for k in ("values", "biases"):
        for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)
        for a, b in zip(out["cuda"][1].velocity[k], out["cpu"][1].velocity[k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    if impl == "masked":
        model = out["cuda"][3]
        bare = MomentumSGD(momentum=0.0, weight_decay=0.0)
        p, _, _ = make_mlp_train_step(cfg, bare)(
            model.params(), bare.init(model.params()), model.topo_arrays(),
            torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda).long(),
            torch.tensor(0.01, device=cuda), None)
        for a, b, mask in zip(p["values"], model.values, model.topo_arrays()):
            off = mask == 0
            assert torch.equal(a[off], b[off]) and not torch.equal(a, b)


def _skewed_layer(cuda, counts, bm, bn, batch, seed=0):
    """A topology whose block-columns hold ``counts`` slots each (canonical
    order, distinct rows per column), with seeded inputs and values at the
    block model's he-uniform scale (fan-in grid_m * bm), so that an output
    sums up to 5,120 products to O(1), as in the model."""
    rng = np.random.default_rng(seed)
    grid_m, grid_n = max(max(counts), 1) + 2, len(counts)
    meta = tsp.BlockMeta(grid_m * bm, grid_n * bn, bm, bn)
    cols = np.repeat(np.arange(grid_n), counts).astype(np.int32)
    rows = np.concatenate([np.sort(rng.choice(grid_m, k, replace=False)) for k in counts])
    t = block_device_arrays(torch.as_tensor(rows.astype(np.int32), device=cuda),
                            torch.as_tensor(cols, device=cuda), meta=meta)
    lim = np.sqrt(6.0 / (grid_m * bm))
    v = torch.as_tensor(rng.uniform(-lim, lim, (len(cols), bm, bn)).astype(np.float32),
                        device=cuda)
    x = torch.as_tensor(rng.standard_normal((batch, grid_m * bm)).astype(np.float32), device=cuda)
    dy = torch.as_tensor(rng.standard_normal((batch, grid_n * bn)).astype(np.float32),
                         device=cuda)
    return meta, rows, t, v, x, dy


# slots per block-column: one column holds every slot (the others none), and
# columns of 1, 2, 7 and 33 slots; block sizes 128 (16-byte copies), 8
# (16-byte copies, fragments masked at the edge of a 64-wide tile) and 5
# (4-byte copies)
SKEWED = [([0, 40, 0], 8, 8), ([0, 40, 0], 128, 128), ([1, 2, 7, 33], 128, 128),
          ([1, 2, 7, 33], 8, 8), ([1, 2, 7, 33], 5, 5), ([3, 1], 5, 8)]


@pytest.mark.parametrize("batch", [1, 100, 128, 300])
@pytest.mark.parametrize("case", SKEWED)
def test_kernels_c_e_on_skewed_columns_match_plain_and_repeat_bit_equal(cuda, case, batch):
    counts, bm, bn = case
    meta, rows, t, v, x, dy = _skewed_layer(cuda, counts, bm, bn, batch)
    before = (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches)
    y = bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    dx = bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
    dw = bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=bm, block_n=bn)
    torch.cuda.synchronize()
    assert (bsm.bsmm_fwd.launches, bsm.bsmm_dx.launches, bsm.bsmm_dw.launches) == tuple(
        b + 1 for b in before)
    want_y = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    torch.testing.assert_close(y, want_y, **BLOCK_TOL)
    torch.testing.assert_close(
        dx, bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                              grid_m=meta.grid_m), **BLOCK_TOL)
    torch.testing.assert_close(dw, bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=bm,
                                                     block_n=bn), **BLOCK_TOL)
    # a block-column with no slot: exact zeros
    empty = [c for c, k in enumerate(counts) if k == 0]
    assert not y.reshape(batch, meta.grid_n, bn)[:, empty].any()
    # the same inputs give the same bits, split or not
    for _ in range(2):
        assert torch.equal(y, bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                           grid_n=meta.grid_n))
        assert torch.equal(dw, bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=bm, block_n=bn))


def _skewed_rows(cuda, counts, bm, bn, batch, seed=0):
    """A topology whose block-rows hold ``counts`` slots each (distinct
    columns per row), in canonical order, with he-uniform values at fan-in
    grid_n * bn and normal dy."""
    rng = np.random.default_rng(seed)
    grid_m, grid_n = len(counts), max(max(counts), 1) + 2
    meta = tsp.BlockMeta(grid_m * bm, grid_n * bn, bm, bn)
    rows = np.repeat(np.arange(grid_m), counts)
    cols = np.concatenate([rng.choice(grid_n, k, replace=False) for k in counts])
    order = np.lexsort((rows, cols))
    t = block_device_arrays(torch.as_tensor(rows[order].astype(np.int32), device=cuda),
                            torch.as_tensor(cols[order].astype(np.int32), device=cuda),
                            meta=meta)
    lim = np.sqrt(6.0 / (grid_n * bn))
    v = torch.as_tensor(rng.uniform(-lim, lim, (len(rows), bm, bn)).astype(np.float32),
                        device=cuda)
    dy = torch.as_tensor(rng.standard_normal((batch, grid_n * bn)).astype(np.float32),
                         device=cuda)
    return meta, t, v, dy


@pytest.mark.parametrize("batch", [100, 128])
@pytest.mark.parametrize("tile", [128, 5])
@pytest.mark.parametrize("counts", [[0, 40, 0], [1, 2, 7, 33]])
def test_kernel_d_on_skewed_rows_matches_plain_and_repeats_bit_equal(cuda, counts, tile, batch):
    """Kernel D splits a long block-row into runs (16-byte copies at
    128x128, 4-byte at 5x5): it matches its plain version, writes exact
    zeros into the uncovered rows, and gives the same bits three times."""
    meta, t, v, dy = _skewed_rows(cuda, counts, tile, tile, batch)
    assert bsm.dx_parts(len(t.rows), meta.grid_m, batch, tile) > 1
    before = bsm.bsmm_dx.launches
    dx = [bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
          for _ in range(3)]
    torch.cuda.synchronize()
    assert bsm.bsmm_dx.launches == before + 3  # the sum pass is not counted apart
    torch.testing.assert_close(
        dx[0], bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                 grid_m=meta.grid_m), **BLOCK_TOL)
    empty = [r for r, k in enumerate(counts) if k == 0]
    assert not dx[0].reshape(batch, meta.grid_m, tile)[:, empty].any()
    assert torch.equal(dx[0], dx[1]) and torch.equal(dx[0], dx[2])


def test_kernels_c_e_split_where_the_plan_says(cuda):
    """The output layer's shape splits C's column 32 ways and a layer of 8
    tiles splits E's batch 4 ways; the results match the plain versions."""
    meta, rows, t, v, x, dy = _skewed_layer(cuda, [32], 128, 128, 128)
    assert bsm.fwd_parts(32, 1, 128, 128) == 32
    torch.testing.assert_close(
        bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=1),
        bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=1), **BLOCK_TOL)
    meta, rows, t, v, x, dy = _skewed_layer(cuda, [2, 1, 3, 2], 128, 128, 128)
    assert bsm.dw_splits(8, 128, 128, 128) == 4
    torch.testing.assert_close(
        bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=128, block_n=128),
        bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=128, block_n=128), **BLOCK_TOL)


def test_kernels_c_e_without_slots(cuda):
    empty = torch.empty((0,), dtype=torch.int32, device=cuda)
    x = torch.randn((100, 3 * 8), device=cuda)
    dy = torch.randn((100, 2 * 8), device=cuda)
    y = bsm.bsmm_fwd(x, torch.empty((0, 8, 8), device=cuda), empty, empty, empty, grid_n=2)
    dw = bsm.bsmm_dw(x, dy, empty, empty, block_m=8, block_n=8)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros((100, 16), device=cuda))
    assert dw.shape == (0, 8, 8)


def test_kernels_c_e_take_an_unaligned_input(cuda):
    """A contiguous x whose storage starts 4 bytes past a 16-byte boundary
    takes the 4-byte copies, with block sizes that would allow 16."""
    meta, rows, t, v, x, dy = _skewed_layer(cuda, [1, 2, 7, 33], 8, 8, 100)
    flat = torch.empty(x.numel() + 1, device=cuda)
    xu = flat[1:].view(x.shape)
    xu.copy_(x)
    assert xu.is_contiguous() and xu.data_ptr() % 16 == 4
    torch.testing.assert_close(bsm.bsmm_fwd(xu, v, t.rows, t.cols, t.first_col,
                                            grid_n=meta.grid_n),
                               bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                            grid_n=meta.grid_n), rtol=0, atol=0)
    torch.testing.assert_close(bsm.bsmm_dw(xu, dy, t.rows, t.cols, block_m=8, block_n=8),
                               bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=8, block_n=8),
                               rtol=0, atol=0)


# -- the element training path: kernel A's dX use and training epilogue, F, G --


def _grad_case(cuda, case, seed=6):
    """A layer of LAYERS on the card: its arrays (offsets registered), values,
    the input hT (in_dim, B) and a seeded output gradient dz (out_dim, B)."""
    _, in_dim, out_dim, eps, batch = case
    topo, vals, x = _layer(seed, in_dim, out_dim, eps, batch)
    rng = np.random.default_rng(seed + 1)
    dz = rng.standard_normal((out_dim, batch)).astype(np.float32)
    return (topo, topo.device_arrays(cuda), torch.as_tensor(vals, device=cuda),
            torch.as_tensor(np.ascontiguousarray(x.T), device=cuda), torch.as_tensor(dz, device=cuda))


@pytest.mark.parametrize("case", LAYERS)
def test_kernel_a_dx_use_matches_plain_and_repeats_bit_equal(cuda, case):
    """dX over the row-sorted dual order, with the row offsets the topology
    registered (no sync, the thread route): against the plain version at A's
    tolerance, and bit-equal over three launches."""
    topo, t, v, _, dz = _grad_case(cuda, case)
    assert tsp.registered_offsets(t.rows_r) is not None
    vr = v.index_select(0, t.perm_r)
    before = tsp.coo_matmul_T.launches
    got = [tsp.coo_matmul_T(dz, vr, t.cols_r, t.rows_r, topo.in_dim) for _ in range(3)]
    torch.cuda.synchronize()
    assert tsp.coo_matmul_T.launches == before + 3
    want = tsp.coo_matmul_T_plain(dz, vr, t.cols_r, t.rows_r, topo.in_dim)
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])


@pytest.mark.parametrize("layer", sorted(EPI_LAYERS))
@pytest.mark.parametrize("batch", [1, 33, 128])
def test_kernel_a_training_epilogue_gives_mode_2_and_the_sign_mask(cuda, layer, batch):
    """Epilogue 3 on both routes: its output bit-equal to the All-ReLU
    epilogue's, its mask exactly where the bias epilogue's output is > 0
    (0 where it is 0: some biases cancel a product exactly)."""
    if layer == "long":
        rng, gather, vals, srcT = _long_segments(LONG, batch)
        n = len(LONG)
        seg_np = np.repeat(np.arange(n), LONG).astype(np.int32)
        seg_ptr = tsp.offsets_to_device(_offsets(LONG), cuda)
    else:
        topo, vals, x = _layer(3, 400, 400, 100, batch)
        rng = np.random.default_rng(5)
        gather, seg_np, n, srcT = topo.rows, topo.cols, topo.out_dim, np.ascontiguousarray(x.T)
        seg_ptr = tsp.offsets_to_device(topo.col_ptr(), cuda)
    g, seg = torch.as_tensor(gather, device=cuda), torch.as_tensor(seg_np, device=cuda)
    v, src = torch.as_tensor(vals, device=cuda), torch.as_tensor(srcT, device=cuda)
    args = (src, v, g, seg, seg_ptr, n, None)
    prod = tsp._coo_matmul_T_cuda(*args, tsp.COO_THREAD)
    bias = torch.as_tensor(rng.standard_normal((n,)).astype(np.float32), device=cuda)
    bias[::3] = -prod[::3, 0]  # v == 0 exactly at batch column 0 of every third segment
    for route in (tsp.COO_THREAD, tsp.COO_STAGED):
        pre = tsp._coo_matmul_T_cuda(*args, route, bias=bias)
        for layer_index in (1, 2):
            slope = slope_for(0.75, layer_index)
            m0 = tsp.coo_matmul_T.mask_launches
            out, mask = tsp._coo_matmul_T_cuda(*args, route, bias=bias, slope=slope,
                                               with_mask=True)
            torch.cuda.synchronize()
            assert tsp.coo_matmul_T.mask_launches == m0 + 1 and mask.dtype == torch.uint8
            assert torch.equal(out, tsp._coo_matmul_T_cuda(*args, route, bias=bias, slope=slope))
            assert torch.equal(mask.bool(), pre > 0)
    assert bool((pre[::3, 0] == 0).all())


# Kernel F's layers beside LAYERS: batch 33 with every third column emptied
# (their empty runs still write dz and dbias), 4,000-slot columns (the
# output layer's: 125 runs a column) at batch 128, and the batches that take
# the kernel's other register widths (256, 512; ragged: 255, 511) and its
# path for a batch over 512 (600, 599), whose dz row is not in registers
F_LAYERS = [*LAYERS, (4, 400, 400, 100, 33, "emptied"), (5, 4000, 10, 20, 128),
            (6, 200, 150, 20, 256), (7, 200, 150, 20, 512), (8, 200, 150, 20, 600)]
# kernel F's epilogue: mode 0 (no bias), 1 (the bias alone), 2 (bias +
# All-ReLU, slope +alpha or -alpha)
F_MODES = {"none": None, "bias": None, "relu_odd": 1, "relu_even": 2}


def _f_args(cuda, mode, shape, seed=12):
    """coo_dw's epilogue arguments for ``mode``: with All-ReLU, the branch
    mask of pre-activations of which a fifth are exactly 0."""
    if mode in ("none", "bias"):
        return dict(with_dbias=mode == "bias")
    rng = np.random.default_rng(seed)
    pre = rng.standard_normal(shape).astype(np.float32)
    pre[rng.random(shape) < 0.2] = 0.0
    return dict(with_dbias=True, mask=torch.as_tensor(pre > 0, device=cuda).to(torch.uint8),
                slope=slope_for(0.75, F_MODES[mode]))


def _f_check(got, want, what):
    """dz bit-equal to the plain version, dv and dbias at its tolerance."""
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5, msg=lambda m: f"{what}: {m}")
    if len(want) == 3:
        assert torch.equal(got[1], want[1]), f"{what}: dz differs"
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"{what}: {m}")


@pytest.mark.parametrize("mode", sorted(F_MODES))
@pytest.mark.parametrize("case", F_LAYERS)
def test_kernel_f_matches_plain_and_repeats_bit_equal(cuda, case, mode):
    """Kernel F in its three epilogue modes against the plain version (dz
    bit-equal: one rounded multiply; dv and dbias at rtol 1e-4 / atol 1e-5),
    every output bit-equal over three launches; then a ragged batch and
    operands off a 16-byte boundary (the scalar path)."""
    topo, t, _, hT, dz = _grad_case(cuda, case[:5])
    if len(case) > 5:  # empty every third column
        keep = topo.cols % 3 != 0
        topo = tsp.ElementTopology(topo.in_dim, topo.out_dim, topo.rows[keep], topo.cols[keep])
        t = topo.device_arrays(cuda)
    args = _f_args(cuda, mode, tuple(dz.shape))
    counts = lambda: (tsp.coo_dw.launches, tsp.coo_dw.epilogue_launches,  # noqa: E731
                      tsp.coo_dw.mask_launches, all_relu_fused.all_relu_bwd.launches)
    before = counts()
    got = [tsp.coo_dw(hT, dz, t.rows, t.cols, **args) for _ in range(3)]
    torch.cuda.synchronize()
    epi, masked = args["with_dbias"], "mask" in args
    assert tuple(a - b for a, b in zip(counts(), before)) == (3, 3 * epi, 3 * masked, 0)
    want = tsp.coo_dw_plain(hT, dz, t.rows, t.cols, **args)
    _f_check(got[0], want, f"{case}, mode {mode}")
    first = got[0] if isinstance(got[0], tuple) else (got[0],)
    assert first[0].shape == (topo.nnz,)
    for other in got[1:]:
        other = other if isinstance(other, tuple) else (other,)
        assert all(torch.equal(a, b) for a, b in zip(first, other))
    # a ragged batch, and operands off a 16-byte boundary: the scalar path
    for sl in (np.s_[:, :-1], np.s_[:, 1:]):
        h2, d2 = hT[sl].contiguous(), dz[sl].contiguous()
        a2 = dict(args, mask=args["mask"][sl].contiguous()) if masked else args
        if h2.shape[1]:
            _f_check(tsp.coo_dw(h2, d2, t.rows, t.cols, **a2),
                     tsp.coo_dw_plain(h2, d2, t.rows, t.cols, **a2), f"{case}, ragged")
    for which in (0, 1):
        ops_ = [hT, dz]
        ops_[which] = torch.empty(ops_[which].numel() + 1, device=cuda)[1:].view(
            ops_[which].shape).copy_(ops_[which])
        _f_check(tsp.coo_dw(*ops_, t.rows, t.cols, **args), want, f"{case}, off 16 bytes")


def test_kernel_f_validates_inputs(cuda):
    topo, t, _, hT, dz = _grad_case(cuda, LAYERS[0])
    before = tsp.coo_dw.launches
    with pytest.raises(ValueError, match="dtype"):
        tsp.coo_dw(hT.double(), dz, t.rows, t.cols)
    with pytest.raises(ValueError, match="one B"):
        tsp.coo_dw(hT, dz[:, :-1], t.rows, t.cols)
    with pytest.raises(ValueError, match="outside"):  # unregistered indices are checked
        tsp.coo_dw(hT, dz, t.rows.clone() + 1000, t.cols)
    with pytest.raises(ValueError, match="dtype"):
        tsp.coo_dw(hT, dz, t.rows.long(), t.cols)
    assert tsp.coo_dw.launches == before  # no launch, and no plain fallback


@pytest.mark.parametrize("shape", [(4000, 128), (10, 128), (1000, 33), (7, 1)])
@pytest.mark.parametrize("layer_index", [1, 2, None])  # slope +alpha, -alpha; no mask
def test_kernel_g_matches_plain_and_repeats_bit_equal(cuda, shape, layer_index):
    """G's standalone call, kernel F's epilogue over one empty run a row:
    dz bit-equal to the plain version (one rounded multiply; dy itself
    without a mask), dbias at the plain sum's tolerance and bit-equal
    across launches; where the pre-activation is exactly 0 the slope branch
    is taken."""
    rng = np.random.default_rng(12)
    dy = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda)
    pre = rng.standard_normal(shape).astype(np.float32)
    pre[rng.random(shape) < 0.2] = 0.0
    mask = None if layer_index is None else torch.as_tensor(pre > 0, device=cuda).to(torch.uint8)
    slope = None if layer_index is None else slope_for(0.75, layer_index)
    before = all_relu_fused.all_relu_bwd.launches, tsp.coo_dw.launches
    got = [all_relu_fused.all_relu_bwd(dy, mask, slope) for _ in range(3)]
    torch.cuda.synchronize()
    # kernel F's epilogue alone: counted as G's standalone call, not as F
    assert (all_relu_fused.all_relu_bwd.launches, tsp.coo_dw.launches) == (before[0] + 3,
                                                                          before[1])
    dz, db = all_relu_fused.all_relu_bwd_plain(dy, mask, slope)
    assert torch.equal(got[0][0], dz)
    torch.testing.assert_close(got[0][1], db, rtol=1e-4, atol=1e-5)
    for other in got[1:]:
        assert torch.equal(other[0], got[0][0]) and torch.equal(other[1], got[0][1])


def test_full_width_element_train_step_matches_cpu(cuda):
    """One step of the full-width CIFAR-10 element model (3072-4000-1000-
    4000-10, epsilon 20) on the card and on the CPU from the same state, and
    its launches: A 4 forward (3 with the mask) and 3 dX (layer 0's input
    needs no gradient), F 4, each with its epilogue (G's work: 3 with
    All-ReLU's mask, 1 with the bias alone), and no standalone G."""
    cfg = dataclasses.replace(mlp_config("cifar10"), dropout=0.0)
    data = load("cifar10", scale=0.003)
    x, y = data.x_train[:128], data.y_train[:128]
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    step = make_mlp_train_step(cfg, opt)
    counters = (lambda: (tsp.coo_matmul_T.launches, tsp.coo_matmul_T.mask_launches,
                         tsp.coo_dw.launches, tsp.coo_dw.epilogue_launches,
                         tsp.coo_dw.mask_launches, all_relu_fused.all_relu_bwd.launches))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = SparseMLP(cfg, seed=0, device=dev)
        before = counters()
        p, s, loss = step(model.params(), opt.init(model.params()), model.topo_arrays(),
                          torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev).long(),
                          torch.tensor(0.01, device=dev), None)
        out[dev.type] = (p, s, loss, tuple(a - b for a, b in zip(counters(), before)))
    assert out["cuda"][3] == (7, 3, 4, 4, 3, 0) and out["cpu"][3] == (0,) * 6
    torch.testing.assert_close(out["cuda"][2].cpu(), out["cpu"][2], rtol=1e-5, atol=1e-5)
    for k in ("values", "biases"):
        for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
        for a, b in zip(out["cuda"][1].velocity[k], out["cpu"][1].velocity[k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)


# -- device SET evolution and the plans it makes on the card -----------------


def _device_made(t, topo):
    """The same topology's arrays made on the device (new tensors, so the
    plans are made anew: kernel F's padded to its fixed capacity)."""
    return element_device_arrays(t.rows.clone(), t.cols.clone(), in_dim=topo.in_dim,
                                 out_dim=topo.out_dim,
                                 longest=tsp.route_hints(t, topo.in_dim, topo.out_dim))


@pytest.mark.parametrize("emptied", [False, True])
@pytest.mark.parametrize("batch", [1, 33, 128])
def test_kernel_f_on_a_padded_device_plan_is_bit_equal_to_the_host_plan(cuda, batch, emptied):
    """Kernel F over the run plan made on the device (its slot runs, then
    padding runs of column -1 up to the capacity) gives the bits of the
    host-made plan, in every epilogue mode, with columns emptied too."""
    topo, t, _, hT, dz = _grad_case(cuda, (3, 400, 400, 100, batch))
    if emptied:
        keep = topo.cols % 3 != 0
        topo = tsp.ElementTopology(topo.in_dim, topo.out_dim, topo.rows[keep], topo.cols[keep])
        t = topo.device_arrays(cuda)
    d = _device_made(t, topo)
    plan = tsp.dw_plan(d.rows, d.cols, topo.out_dim)
    n_real = tsp.dw_plan(t.rows, t.cols, topo.out_dim).n_slot_runs
    assert plan.n_slot_runs == tsp.dw_runs_capacity(topo.nnz, topo.out_dim) > n_real
    for mode in sorted(F_MODES):
        args = _f_args(cuda, mode, tuple(dz.shape))
        host = tsp.coo_dw(hT, dz, t.rows, t.cols, **args)
        dev = tsp.coo_dw(hT, dz, d.rows, d.cols, **args)
        torch.cuda.synchronize()
        host, dev = (x if isinstance(x, tuple) else (x,) for x in (host, dev))
        assert all(torch.equal(a, b) for a, b in zip(host, dev)), f"mode {mode}"


def test_kernel_f_padding_runs_write_nothing(cuda):
    """A plan of padding runs alone, with an epilogue's outputs given:
    every warp returns at once, and dv, dz and dbias keep their sentinels."""
    rng = np.random.default_rng(0)
    n_cols, batch = 16, 33
    xT = torch.as_tensor(rng.standard_normal((8, batch)).astype(np.float32), device=cuda)
    dy = torch.as_tensor(rng.standard_normal((n_cols, batch)).astype(np.float32), device=cuda)
    mask = torch.ones((n_cols, batch), dtype=torch.uint8, device=cuda)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    runs = torch.tensor([[-1, 0, 0]] * 40, dtype=torch.int32, device=cuda)
    dv = torch.full((4,), 7.0, device=cuda)
    dz = torch.full((n_cols, batch), 7.0, device=cuda)
    dbias = torch.full((n_cols,), 7.0, device=cuda)
    fn = tsp.build.kernel("coo_dw", "coo_dw_f32", tsp._COO_DW_ARGTYPES)
    rc = fn(xT.data_ptr(), dy.data_ptr(), mask.data_ptr(), 0.5, rows.data_ptr(),
            runs.data_ptr(), dv.data_ptr(), dz.data_ptr(), dbias.data_ptr(), runs.shape[0],
            batch, *tsp.build.stream_args(dy.device))
    tsp.build.check_launch(rc, "coo_dw kernel")
    torch.cuda.synchronize()
    assert bool((dv == 7).all() & (dz == 7).all() & (dbias == 7).all())


def _check_evolved(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert np.array_equal(g, np.asarray(w)), f"{what}: output {i} differs"


@pytest.mark.parametrize("zeta", [0.3, 0.5])
def test_device_evolution_matches_its_numpy_version(cuda, zeta):
    """Element and block SET on the card against the numpy versions fed the
    same draws (copied from the card): equal slot for slot."""
    rng = np.random.default_rng(4)
    topo = tsp.ElementTopology.erdos_renyi(400, 300, 20, rng)
    vals = rng.standard_normal(topo.nnz).astype(np.float32)
    vals[::17] = 0.0
    mom = rng.standard_normal(topo.nnz).astype(np.float32)
    gen = torch.Generator(device=cuda).manual_seed(1)
    cand, init = evolution_draws(gen, topo.nnz, 400 * 300, fan_in_dense=400, scheme="he_uniform")
    dims = dict(in_dim=400, out_dim=300, zeta=zeta)
    got = evolve_element_device(*(torch.as_tensor(a, device=cuda) for a in (
        topo.rows, topo.cols, vals, mom)), cand, init, **dims)
    want = evolve_element_device_reference(topo.rows, topo.cols, vals, mom, cand.cpu().numpy(),
                                           init.cpu().numpy(), **dims)
    _check_evolved(got, want, "element")
    meta = tsp.BlockMeta(300, 200, 32, 32)
    btopo = tsp.BlockTopology.erdos_renyi(meta, 0.4, rng)
    bvals = rng.standard_normal((btopo.n_blocks, 32, 32)).astype(np.float32)
    bmom = rng.standard_normal(bvals.shape).astype(np.float32)
    bcand, _ = evolution_draws(gen, btopo.n_blocks, meta.total_blocks, fan_in_dense=300,
                               scheme=None)
    dv = torch.as_tensor(bvals, device=cuda)
    got = evolve_block_device(*(torch.as_tensor(a, device=cuda) for a in (
        btopo.rows, btopo.cols)), dv, torch.as_tensor(bmom, device=cuda), bcand, meta=meta,
        zeta=zeta)
    scores = dv.abs().mean(dim=(1, 2)).cpu().numpy()
    np.testing.assert_allclose(scores, np.abs(bvals).mean(axis=(1, 2)), rtol=1e-6)
    want = evolve_block_device_reference(btopo.rows, btopo.cols, bvals, bmom,
                                         bcand.cpu().numpy(), meta=meta, zeta=zeta,
                                         scores=scores)
    _check_evolved(got, want, "block")


def test_full_width_evolution_runs_without_a_host_sync(cuda):
    """One device evolution of the full-width element model (3072-4000-
    1000-4000-10) and of its block model, arrays and plans included, under
    ``set_sync_debug_mode("error")``; then the device-made offsets equal
    the host's and F's plan, padding stripped, equals ``dw_runs``."""
    model = SparseMLP(mlp_config("cifar10"), seed=0, device=cuda)
    bmodel = SparseMLP(mlp_config("cifar10", impl="block"), seed=0, device=cuda)
    topo, btopo = model.topo_arrays(), bmodel.topo_arrays()
    gen = torch.Generator(device=cuda).manual_seed(0)
    vel = [torch.randn(v.shape, device=cuda) for v in model.values]
    bvel = [torch.randn(v.shape, device=cuda) for v in bmodel.values]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        new, _, _, pruned = evolve_element_layers_device(
            topo, model.values, vel, gen, layer_dims=model.config.layer_dims, zeta=0.3)
        bnew, _, _, bpruned = evolve_block_layers_device(
            btopo, bmodel.values, bvel, gen,
            metas=[block_meta(bmodel.config, l) for l in range(4)], zeta=0.3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # a block layer of one tile a block-column (layer 0: 32 tiles, 32
    # columns) has none to drop: coverage keeps them all
    assert int(pruned.min()) > 0 and int(bpruned.sum()) > 0
    for l, t in enumerate(new):
        host = tsp.ElementTopology(model.config.layer_dims[l], model.config.layer_dims[l + 1],
                                   t.rows.cpu().numpy(), t.cols.cpu().numpy())
        assert torch.equal(tsp.registered_offsets(t.cols).cpu(), torch.from_numpy(host.col_ptr()))
        assert torch.equal(tsp.registered_offsets(t.rows_r).cpu(),
                           torch.from_numpy(host.row_ptr()))
        runs, n = tsp.dw_runs(host.rows, host.col_ptr())
        plan = tsp.dw_plan(t.rows, t.cols, host.out_dim).runs.cpu().numpy()
        cap = tsp.dw_runs_capacity(host.nnz, host.out_dim)
        assert np.array_equal(plan[:n], runs[:n]) and np.array_equal(plan[cap:], runs[n:])
        assert (plan[n:cap, 0] == -1).all()
    for l, t in enumerate(bnew):
        tsp.BlockTopology(block_meta(bmodel.config, l), t.rows.cpu().numpy(),
                          t.cols.cpu().numpy())


# -- WASAP-SGD: the phase-1 epoch and phase-2 worker evolution on the card ---


def _phase1_inputs(dev, k=3, h=2, rounds=2, batch=32, seed=0):
    """The full-width element model's phase-1 epoch inputs on ``dev``: k
    workers, rounds x h local steps of ``batch``, the last step padded."""
    cfg = dataclasses.replace(mlp_config("cifar10"), dropout=0.0)
    data = load("cifar10", scale=0.003)
    rng = np.random.default_rng(seed)
    n = len(data.x_train)
    idx = rng.integers(0, n, (rounds, k, h, batch))
    valid = np.ones((rounds, h), np.float32)
    valid[-1, -1] = 0.0
    lrs = np.full((rounds, h), 0.02, np.float32)
    model = SparseMLP(cfg, seed=seed, device=dev)
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    return cfg, opt, model, (
        torch.as_tensor(data.x_train, device=dev), torch.as_tensor(data.y_train, device=dev).long(),
        torch.as_tensor(idx, device=dev), torch.as_tensor(lrs, device=dev),
        torch.as_tensor(valid, device=dev))


def _launches():
    return (tsp.coo_matmul_T.launches, tsp.coo_matmul_T.epilogue_launches,
            tsp.coo_matmul_T.mask_launches, tsp.coo_dw.launches, tsp.coo_dw.epilogue_launches,
            tsp.coo_dw.mask_launches, all_relu_fused.all_relu_bwd.launches)


def test_wasap_phase1_epoch_matches_cpu_and_repeats_bit_equal(cuda):
    """A phase-1 epoch of the full-width element model (3 workers, 2 rounds
    of 2 steps of 32, the last padded) on the card against the CPU at rtol
    1e-5, with its launches: every step of every worker, the padded one
    too, launches A 4 forward (3 with the mask) and 3 dX, and F 4 with its
    epilogue (3 with the mask), no standalone G; then a second card run of
    the same epoch, bit-equal."""
    from repro_torch.core.wasap import make_phase1_epoch_fn

    out = {}
    for dev in (torch.device("cpu"), cuda, cuda):
        cfg, opt, model, (x, y, idx, lrs, valid) = _phase1_inputs(dev)
        epoch = make_phase1_epoch_fn(cfg, opt, n_workers=3)
        before = _launches()
        p, s, losses = epoch(model.params(), opt.init(model.params()), model.topo_arrays(), x, y,
                             idx, lrs, valid, torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = tuple(a - b for a, b in zip(_launches(), before))
        out.setdefault(dev.type, []).append((p, s, losses, launches))
    steps = 2 * 3 * 2  # rounds x workers x steps, the padded one included
    assert out["cpu"][0][3] == (0,) * 7
    assert out["cuda"][0][3] == (7 * steps, 4 * steps, 3 * steps, 4 * steps, 4 * steps,
                                 3 * steps, 0)
    (pc, sc, lc, _), (p1, s1, l1, _), (p2, s2, l2, _) = out["cpu"][0], *out["cuda"]
    torch.testing.assert_close(l1.cpu(), lc, rtol=1e-5, atol=1e-6)
    assert int(s1.step) == int(sc.step) == 3
    for k in ("values", "biases"):
        for a, b in zip(p1[k], pc[k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        for a, b in zip(s1.velocity[k], sc.velocity[k]):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
        assert all(torch.equal(a, b) for a, b in zip(p1[k], p2[k]))
        assert all(torch.equal(a, b) for a, b in zip(s1.velocity[k], s2.velocity[k]))
    assert torch.equal(l1, l2)


def test_wasap_phase2_worker_evolution_runs_without_a_host_sync(cuda):
    """Phase 2's K workers each evolve their own copy of the full-width
    element model's topology on the card, every evolution under
    ``set_sync_debug_mode("error")``; the K x 4 device-made array sets keep
    their own offsets and F plans registered, and a training step of each
    worker on its arrays, also under the sync check, finds them (a miss
    would sync) and launches A and F."""
    from repro_torch.core.wasap import WASAPConfig, WASAPTrainer

    cfg = dataclasses.replace(mlp_config("cifar10"), dropout=0.0)
    data = load("cifar10", scale=0.003)
    model = SparseMLP(cfg, seed=0, device=cuda)
    trainer = WASAPTrainer(model, data, WASAPConfig(n_workers=3, batch_size=32))
    opt = trainer.opt
    base = model.params()
    workers = []
    for wk in range(3):
        rng = np.random.default_rng(wk)
        state = opt.init(base)._replace(velocity={
            k: tuple(torch.as_tensor(0.01 * rng.standard_normal(tuple(v.shape)),
                                     dtype=torch.float32, device=cuda) for v in vs)
            for k, vs in base.items()})
        workers.append([model.topo_arrays(), base, state,
                        torch.Generator(device=cuda).manual_seed(wk)])
    step = make_mlp_train_step(cfg, opt)
    x = torch.as_tensor(data.x_train[:32], device=cuda)
    y = torch.as_tensor(data.y_train[:32], device=cuda).long()
    lr = torch.tensor(0.01, device=cuda)
    torch.cuda.synchronize()
    before = _launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for w in workers:
            w[0], w[1], w[2] = trainer._evolve_device(*w)
        for w in workers:
            w[1], w[2], _ = step(w[1], w[2], w[0], x, y, lr, None)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(_launches(), before))
    assert launches == (21, 12, 9, 12, 12, 9, 0)
    for wk, w in enumerate(workers):
        for l, t in enumerate(w[0]):
            host = tsp.ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1],
                                       t.rows.cpu().numpy(), t.cols.cpu().numpy())
            assert host.nnz == model.topos[l].nnz
            assert torch.equal(tsp.registered_offsets(t.cols).cpu(),
                               torch.from_numpy(host.col_ptr())), (wk, l)
            assert tsp._recall(tsp._DW_RUNS, t.cols) is not None, (wk, l)
        assert all(bool(torch.isfinite(v).all()) for v in w[1]["values"])
    # the workers drew from their own generators: their topologies differ
    assert not torch.equal(workers[0][0][0].rows, workers[1][0][0].rows)


@pytest.mark.parametrize("impl", ["element", "block"])
def test_card_resume_is_bit_equal(cuda, tmp_path, impl):
    """A 3-epoch fused run on the card (device SET, pruning, dropout 0.2)
    saving at every epoch; a fresh trainer restored from the epoch-0
    checkpoint runs on to the same history and the same final values,
    biases and topologies, bit for bit, on the path's kernels."""
    cfg = SparseMLPConfig(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, block_m=8,
                          block_n=8, impl=impl, dropout=0.2)
    data = load("fashionmnist", scale=0.01)
    tc = TrainerConfig(epochs=3, batch_size=32, seed=1,
                       pruning=PruningSchedule(tau=1, period=1, percentile=10.0))
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    live = SequentialTrainer(SparseMLP(cfg, seed=1, device=cuda), data, tc)
    live.epoch_end_hook = lambda tr, epoch: tr.save_checkpoint(mgr)
    hist = live.run()
    mgr.wait()
    resumed = SequentialTrainer(SparseMLP(cfg, seed=1, device=cuda), data, tc)
    resumed.restore_checkpoint(mgr, mgr.all_steps()[0])
    wrappers = ((tsp.coo_matmul_T, tsp.coo_dw) if impl == "element"
                else (bsm.bsmm_fwd, bsm.bsmm_dx, bsm.bsmm_dw))
    before = [w.launches for w in wrappers]
    got = resumed.run()
    assert all(w.launches > b for w, b in zip(wrappers, before))
    for key in ("epoch", "train_loss", "test_acc", "n_params"):
        assert got[key] == hist[key], key
    for a, b in zip(resumed.model.values + resumed.model.biases,
                    live.model.values + live.model.biases):
        assert a.is_cuda and torch.equal(a, b)
    for a, b in zip(resumed.model.topos, live.model.topos):
        assert np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols)


# -- the out-of-core stream (repro_torch.xl): K8, kernel B's (features,
# batch) pass, the pinned ring, and a streamed step -------------------------


def _shards(seg: np.ndarray, cap: int):
    """Canonical-order shard bounds of ``cap`` slots over ``seg``."""
    return [(lo, min(lo + cap, seg.size)) for lo in range(0, seg.size, cap)]


def _padded(a: np.ndarray, cap: int, fill, device):
    out = np.full(cap, fill, a.dtype)
    out[: a.size] = a
    return torch.as_tensor(out, device=device)


@pytest.mark.parametrize("layer", ["short", "long"])
@pytest.mark.parametrize("batch", [32, 33])
def test_xl_shard_acc_kernel(cuda, layer, batch):
    """Kernel A over shard windows, in place into a carried buffer: shards
    (segments spanning shard edges; a padded last shard; 1,024-slot shards
    of 2,800-slot segments on the staged route) give the bits of one call of
    kernel A over the whole layer, on both routes, leave every row outside
    the windows as it was, and match the plain version (index_add_: other
    rounding) within 1e-5."""
    if layer == "long":
        rng, gather, vals, srcT = _long_segments(LONG, batch)
        seg = np.repeat(np.arange(len(LONG)), LONG).astype(np.int32)
        n = len(LONG) + 3  # three rows no shard touches
        cap = 1024
    else:
        topo, vals, x = _layer(4, 300, 500, 20, batch)
        rng = np.random.default_rng(4)
        gather, seg, n, srcT = topo.rows, topo.cols, topo.out_dim, np.ascontiguousarray(x.T)
        cap = 96
    src = torch.as_tensor(srcT, device=cuda)
    acc0 = torch.as_tensor(rng.standard_normal((n, batch)).astype(np.float32), device=cuda)
    acc, plain = acc0.clone(), acc0.clone()
    launches = ops.xl_shard_acc.launches
    for lo, hi in _shards(seg, cap):
        vals_d = _padded(vals[lo:hi], cap, 0.0, cuda)
        gather_d = _padded(gather[lo:hi], cap, 0, cuda)
        seg_d = _padded(seg[lo:hi], cap, n, cuda)
        window = ops.shard_window(seg_d, n)
        assert ops.xl_shard_acc(acc, src, vals_d, gather_d, n_segments=n, window=window) is acc
        plain = ops._xl_shard_acc_plain(plain, src, vals_d, gather_d, window, None)
    torch.cuda.synchronize()
    assert ops.xl_shard_acc.launches - launches == len(_shards(seg, cap))
    seg_all = torch.as_tensor(seg, device=cuda)
    ptr = torch.searchsorted(seg_all, torch.arange(n + 1, dtype=torch.int32, device=cuda))
    whole = [tsp._coo_matmul_T_cuda(src, torch.as_tensor(vals, device=cuda),
                                    torch.as_tensor(gather, device=cuda), seg_all, ptr, n,
                                    acc0, route) for route in (tsp.COO_THREAD, tsp.COO_STAGED)]
    assert torch.equal(acc, whole[0]) and torch.equal(acc, whole[1])
    untouched = torch.ones(n, dtype=torch.bool, device=cuda)
    untouched[seg_all.long()] = False
    assert torch.equal(acc[untouched], acc0[untouched])
    torch.testing.assert_close(acc, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [32, 33])
def test_xl_shard_dw_kernel(cuda, batch):
    """Kernel F over shards with host-made run plans: each shard's real
    extent bit-equal to kernel F over the whole layer (a slot's sum does not
    depend on its run), the padded tail of the output untouched, and within
    1e-5 of the plain version."""
    topo, _, x = _layer(5, 300, 500, 20, batch)
    rng = np.random.default_rng(5)
    xT = torch.as_tensor(np.ascontiguousarray(x.T), device=cuda)
    dy = torch.as_tensor(rng.standard_normal((topo.out_dim, batch)).astype(np.float32),
                         device=cuda)
    arrays = topo.device_arrays(cuda)
    whole = tsp.coo_dw(xT, dy, arrays.rows, arrays.cols)
    cap = 96
    for lo, hi in _shards(topo.cols, cap):
        rows_d = _padded(topo.rows[lo:hi], cap, 0, cuda)
        cols_d = _padded(topo.cols[lo:hi], cap, topo.out_dim, cuda)
        out = torch.full((cap,), 7.0, device=cuda)
        got = ops.xl_shard_dw(xT, dy, rows_d, cols_d, out=out)
        torch.cuda.synchronize()
        assert got is out and torch.equal(out[: hi - lo], whole[lo:hi])
        assert bool((out[hi - lo:] == 7.0).all())
        want = ops._xl_shard_dw_plain(xT, dy, rows_d, ops.shard_window(cols_d, topo.out_dim),
                                      None, torch.zeros(cap, device=cuda))
        torch.testing.assert_close(out[: hi - lo], want[: hi - lo], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [32, 33, 1])
def test_kernel_b_features_batch_pass_equals_kernel_a_epilogue(cuda, batch):
    """Kernel A with no epilogue, then kernel B's (features, batch) pass,
    bit-equal to kernel A's fused store in each mode (the bias alone;
    All-ReLU of either slope sign; with the mask), in place or not, on the
    16-byte (batch 32) and scalar paths."""
    topo, vals, x = _layer(6, 300, 500, 20, batch)
    rng = np.random.default_rng(6)
    src = torch.as_tensor(np.ascontiguousarray(x.T), device=cuda)
    arrays = topo.device_arrays(cuda)
    v = torch.as_tensor(vals, device=cuda)
    n = topo.out_dim
    prod = tsp.coo_matmul_T(src, v, arrays.rows, arrays.cols, n)
    bias = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=cuda)
    bias[::5] = -prod[::5, 0]  # some pre-activations exactly 0
    fused = tsp.coo_matmul_T(src, v, arrays.rows, arrays.cols, n, bias=bias)
    assert torch.equal(all_relu_fused.bias_all_relu_T(prod, bias, None), fused)
    for layer_index in (1, 2):
        slope = slope_for(0.5, layer_index)
        f_out, f_mask = tsp.coo_matmul_T(src, v, arrays.rows, arrays.cols, n, bias=bias,
                                         slope=slope, with_mask=True)
        mask = torch.empty_like(f_mask)
        before = all_relu_fused.bias_all_relu.T_launches
        y, m = all_relu_fused.bias_all_relu_T(prod, bias, slope, mask=mask)
        assert torch.equal(y, f_out) and torch.equal(m, f_mask) and m is mask
        assert torch.equal(all_relu_fused.bias_all_relu_T(prod, bias, slope), f_out)
        inplace = prod.clone()
        all_relu_fused.bias_all_relu_T(inplace, bias, slope, out=inplace)
        assert torch.equal(inplace, f_out)
        assert all_relu_fused.bias_all_relu.T_launches == before + 3
        plain = all_relu_fused.bias_all_relu_T_plain(prod, bias, slope, with_mask=True)
        assert torch.equal(plain[0], f_out) and torch.equal(plain[1], f_mask)


XL_DIMS = (96, 160, 128, 5)


XL_BUDGET = 210_000  # shards of 256 slots: [8, 9, 3] a layer
XL_RESIDENT_BUDGET = 5_000_000  # one shard a layer, every index shard cached


def _xl_setup(cuda, budget=XL_BUDGET, seed=0):
    """A small XL model on the card and its plan (multi-shard at the
    default budget)."""
    from repro_torch.xl import XLModelState, plan_memory_budget

    cfg = SparseMLPConfig(layer_dims=XL_DIMS, epsilon=8, alpha=0.6, dropout=0.0,
                          impl="element")
    model = SparseMLP(cfg, seed=seed, device=cuda)
    plan = plan_memory_budget(XL_DIMS, [t.nnz for t in model.topos], 32, budget,
                              chunk=128, min_chunk=32)
    assert budget != XL_BUDGET or [lp.n_shards for lp in plan.layers] == [8, 9, 3]
    return model, plan, XLModelState.from_model(model, plan)


def _xl_batches(n=3):
    rng = np.random.default_rng(9)
    return [(rng.standard_normal((32, XL_DIMS[0])).astype(np.float32),
             rng.integers(0, XL_DIMS[-1], 32)) for _ in range(n)]


def _xl_run(cuda, **knobs):
    """Three streamed steps and the logits after them, with the executor's
    knobs set; returns the values, biases and logits."""
    from repro_torch.xl import StreamExecutor

    _, _, state = _xl_setup(cuda)
    ex = StreamExecutor(state, cuda)
    for k, v in knobs.items():
        setattr(ex, k, v)
    losses = [ex.train_step(x, y, 0.05, momentum=0.9, weight_decay=2e-4)
              for x, y in _xl_batches()]
    logits = ex.logits(_xl_batches(1)[0][0])
    return losses, [l.values.copy() for l in state.layers], [l.bias.copy() for l in state.layers], logits


def test_xl_pinned_ring_has_no_race(cuda):
    """The pipelined ring (each shard gathered into a pinned slot while the
    one before computes) against a run that synchronises after every copy,
    with the copy stream spun before each copy so that copies are still in
    flight when the host comes back to a slot: the same bits. A slot reused
    before its copy completed would have shipped the next shard's data."""
    ref = _xl_run(cuda, sync_copies=True)
    stressed = _xl_run(cuda, copy_delay_cycles=20_000_000)  # ~10 ms a copy
    plain = _xl_run(cuda)
    for got in (stressed, plain):
        assert got[0] == ref[0]
        for a, b in zip(got[1] + got[2], ref[1] + ref[2]):
            assert np.array_equal(a, b)
        assert np.array_equal(got[3], ref[3])


@pytest.mark.parametrize("budget", [XL_BUDGET, XL_RESIDENT_BUDGET], ids=["streamed", "resident"])
def test_xl_streamed_step_bit_equal_to_in_core(cuda, budget):
    """On the card, streamed logits and one streamed step (kernels A, B, F
    and G over shards) bit-equal to the in-core element forward and step
    (kernel A with its fused epilogue, F with G's work in its epilogue), and
    each kernel launched."""
    from repro_torch.xl import StreamExecutor

    model, _, state = _xl_setup(cuda, budget)
    ex = StreamExecutor(state, cuda)
    x, y = _xl_batches(1)[0]
    with torch.no_grad():
        want = mlp_forward(model.params(), model.topo_arrays(), torch.as_tensor(x, device=cuda),
                           model.config).cpu().numpy()
    assert np.array_equal(ex.logits(x), want)
    counts = (ops.xl_shard_acc, ops.xl_shard_dw, all_relu_fused.bias_all_relu,
              all_relu_fused.all_relu_bwd)
    before = [c.launches for c in counts]
    loss = ex.train_step(x, y, 0.01, momentum=0.9, weight_decay=2e-4)
    assert all(c.launches > b for c, b in zip(counts, before))
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    params = model.params()
    p2, s2, ref_loss = make_mlp_train_step(model.config, opt)(
        params, opt.init(params), model.topo_arrays(), torch.as_tensor(x, device=cuda),
        torch.as_tensor(y, device=cuda).long(), torch.tensor(0.01, device=cuda), None)
    assert loss == float(ref_loss)
    for l, layer in enumerate(state.layers):
        assert np.array_equal(layer.values, p2["values"][l].cpu().numpy()), l
        assert np.array_equal(layer.velocity, s2.velocity["values"][l].cpu().numpy()), l
        assert np.array_equal(layer.bias, p2["biases"][l].cpu().numpy()), l


# -- the bfloat16 LM: kernel C's bf16 instance, kernel B's bf16 entry ----------

# The reference's kernel sweep (tests/test_kernels.py:32): B, gm, gn, bm, bn, density
LM_KERNEL_SHAPES = [
    (8, 2, 3, 8, 16, 0.7), (16, 4, 4, 16, 16, 0.4), (32, 3, 5, 8, 8, 0.9),
    (8, 1, 2, 16, 8, 1.0), (24, 5, 2, 8, 16, 0.5),
]
# Qwen1.5-0.5B's sparse FFN at full width, seed 0: W_in 1024 -> 2816 (22 of 8 x 22
# tiles), W_out 2816 -> 1024 (15 of 22 x 8), at 1 row, a decode step's 8 and a
# 4-prompt prefill's 64, 128 and 256 (buckets 16, 32 and 64)
FULL_WIDTH_FFN = [(rows, which) for which in ("win", "wout")
                  for rows in (1, 8, 64, 128, 256)]
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # both keep an f32 sum and round once, in other orders


def _bf16_case(cuda, B, meta, topo, rng):
    values = topo.init_values(rng, dtype=torch.bfloat16, device=cuda)
    x = torch.as_tensor(rng.standard_normal((B, meta.padded_in)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    return topo.device_arrays(cuda), values, x


def _full_width_ffn(cuda, which, rows):
    rng = np.random.default_rng(0)
    t_in = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(1024, 2816), 64.0, rng)
    t_out = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2816, 1024), 64.0, rng)
    assert (t_in.n_blocks, t_out.n_blocks) == (22, 15)
    topo = t_in if which == "win" else t_out
    return (topo.meta,) + _bf16_case(cuda, rows, topo.meta, topo, rng)


# W_in's 8 x 22 grid with every block-column holding L slots: columns longer
# than the decode and rows routes' rings (4 slot stages, 3 on the 64 x 64
# rows tile), at the decode route's one and two x-fragments (8, 16 rows) and
# the rows route's 32 x 32 (64 rows) and 64 x 64 (256 rows) tiles
LONG_COLUMNS = [(length, rows) for length in (4, 5, 8) for rows in (8, 16, 64, 256)]


def _long_columns(cuda, length, rows):
    rng = np.random.default_rng(length)
    meta = tsp.BlockMeta(1024, 2816, 128, 128)
    block_rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                                 for _ in range(meta.grid_n)])
    topo = tsp.BlockTopology(meta, block_rows, np.repeat(np.arange(meta.grid_n), length))
    return (meta,) + _bf16_case(cuda, rows, meta, topo, rng)


@pytest.mark.parametrize("case", [("sweep", s) for s in LM_KERNEL_SHAPES]
                         + [("full", c) for c in FULL_WIDTH_FFN]
                         + [("columns", c) for c in LONG_COLUMNS])
def test_kernel_c_bf16_matches_plain_and_oracle_and_repeats(cuda, case):
    meta, t, v, x = _c_bf16_case(cuda, case)
    before = bsm.bsmm_fwd.launches
    ys = [bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
          for _ in range(3)]
    torch.cuda.synchronize()
    assert bsm.bsmm_fwd.launches == before + 3
    assert ys[0].dtype == torch.bfloat16
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    torch.testing.assert_close(ys[0].float(), want.float(), **BF16_TOL)
    oracle = ref.bsmm_ref(x.float(), v.float(), t.rows, t.cols, grid_m=meta.grid_m,
                          grid_n=meta.grid_n)
    torch.testing.assert_close(ys[0].float(), oracle, rtol=5e-2, atol=5e-2)


C_BF16_CASES = ([("sweep", s) for s in LM_KERNEL_SHAPES]
                + [("full", c) for c in FULL_WIDTH_FFN + [(16, "win"), (16, "wout")]]
                + [("columns", c) for c in LONG_COLUMNS])


def _c_bf16_case(cuda, case):
    kind, shape = case
    if kind == "sweep":
        B, gm, gn, bm, bn, density = shape
        rng = np.random.default_rng(0)
        meta = tsp.BlockMeta(gm * bm, gn * bn, bm, bn)
        topo = tsp.BlockTopology.erdos_renyi(meta, density, rng)
        return (meta,) + _bf16_case(cuda, B, meta, topo, rng)
    if kind == "columns":
        return _long_columns(cuda, *shape)
    return _full_width_ffn(cuda, shape[1], shape[0])


@pytest.mark.parametrize("layer_index", [1, 2])
@pytest.mark.parametrize("case", C_BF16_CASES)
def test_kernel_c_bf16_all_relu_store_is_c_then_b(cuda, case, layer_index):
    """Kernel C bf16 with All-ReLU in its store, on every route: bit-equal
    to kernel C followed by kernel B's bf16 entry, the same bits on three
    launches, and counted as an epilogue launch."""
    meta, t, v, x = _c_bf16_case(cuda, case)
    before = (bsm.bsmm_fwd.launches, bsm.bsmm_fwd.epilogue_launches)
    ys = [bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n,
                       all_relu=(0.6, layer_index)) for _ in range(3)]
    torch.cuda.synchronize()
    assert (bsm.bsmm_fwd.launches, bsm.bsmm_fwd.epilogue_launches) == (before[0] + 3,
                                                                       before[1] + 3)
    assert all(torch.equal(ys[0].view(torch.int16), y.view(torch.int16)) for y in ys[1:])
    c = bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    after = all_relu_fused.bias_all_relu(c, None, alpha=0.6, layer_index=layer_index)
    assert torch.equal(ys[0].view(torch.int16), after.view(torch.int16))
    want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n,
                              all_relu=(0.6, layer_index))
    torch.testing.assert_close(ys[0].float(), want.float(), **BF16_TOL)


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("which", ["win", "wout"])
def test_kernel_c_bf16_decode_row_does_not_depend_on_the_batch(cuda, which, rows):
    """On the decode route a row's bits are the same alone as within the
    call: nothing in the swapped product mixes batch columns."""
    meta, t, v, x = _full_width_ffn(cuda, which, rows)
    assert bsm.fwd_plan(t.rows.numel(), meta.grid_n, rows, 128, 128, bf16=True).route == "decode"
    y = bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    for r in range(rows):
        alone = bsm.bsmm_fwd(x[r:r + 1].clone(), v, t.rows, t.cols, t.first_col,
                             grid_n=meta.grid_n)
        assert torch.equal(alone[0].view(torch.int16), y[r].view(torch.int16)), r


@pytest.mark.parametrize("case", C_BF16_CASES)
def test_kernel_c_bf16_launches_its_planned_route(cuda, case):
    """One launch a call on the route ``fwd_plan`` gives; no second pass on
    the served shapes (the decode and rows routes never split)."""
    meta, t, v, x = _c_bf16_case(cuda, case)
    plan = bsm.fwd_plan(t.rows.numel(), meta.grid_n, x.shape[0], meta.block_m, meta.block_n,
                        bf16=True)
    names = ("launches", "second_pass_launches", "decode_launches", "rows_launches")
    before = [getattr(bsm.bsmm_fwd, n) for n in names]
    bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    torch.cuda.synchronize()
    got = [getattr(bsm.bsmm_fwd, n) - b for n, b in zip(names, before)]
    assert got == [1, int(plan.parts > 1), int(plan.route == "decode"),
                   int(plan.route == "rows")]
    if case[0] != "sweep":
        assert plan.route == ("decode" if x.shape[0] <= 16 else "rows") and plan.parts == 1


def _repadded_case(cuda, rows):
    """Kernel C bf16's input on a topology as ``compact_block_lm`` leaves
    it: W_in's 8 x 22 grid with block-columns of 6 slots; some blocks zeroed
    and freed by ``_free_empty_blocks``, then ``_repad_blocks`` resurrects a
    few freed positions as zero blocks, re-sorted among the live ones, so
    that columns of 6 (longer than C's 4-stage ring) hold zero blocks. Also
    the topology before freeing, with the zeroed values."""
    from repro_torch.serve import compact

    rng = np.random.default_rng(7)
    meta = tsp.BlockMeta(1024, 2816, 128, 128)
    length = 6
    block_rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                                 for _ in range(meta.grid_n)])
    full = tsp.BlockTopology(meta, block_rows, np.repeat(np.arange(meta.grid_n), length))
    lim = np.sqrt(6.0 / meta.in_dim)
    vals = rng.uniform(-lim, lim, (full.n_blocks, 128, 128)).astype(np.float32)
    vals = torch.as_tensor(vals).to(torch.bfloat16).float().numpy()  # bf16-exact
    vals[rng.random(full.n_blocks) < 0.3] = 0.0
    keep, live, live_vals = compact._free_empty_blocks(full, vals)
    freed = int((~keep).sum())
    assert freed >= 8
    topo, v = compact._repad_blocks(meta, live.rows, live.cols, live_vals, full.rows[~keep],
                                    full.cols[~keep], live.n_blocks + freed // 2)
    zero = np.abs(v).sum(axis=(1, 2)) == 0
    counts = np.bincount(topo.cols, minlength=meta.grid_n)
    assert zero.any() and counts.max() == length
    assert (counts[topo.cols[zero]] > 4).any()  # a zero block in a column longer than the ring
    x = torch.as_tensor(rng.standard_normal((rows, meta.padded_in)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)

    def on_card(t, values):
        return t.device_arrays(cuda), torch.as_tensor(values, device=cuda).to(torch.bfloat16)

    return meta, on_card(topo, v), on_card(full, vals), x


@pytest.mark.parametrize("rows", [8, 16, 64, 256])
def test_kernel_c_bf16_on_a_repadded_topology(cuda, rows):
    """Kernel C bf16 on a compacted LM's kind of topology (zero blocks at
    freed positions, re-sorted into canonical order, in columns longer than
    its ring): within 1e-2 of its plain version, with and without All-ReLU
    in its store, the same bits on three launches, and equal to C on the
    topology before the blocks were freed (a zero block adds exact zeros,
    and the route is the same)."""
    meta, (t, v), (t_full, v_full), x = _repadded_case(cuda, rows)
    for all_relu in (None, (0.6, 1), (0.6, 2)):
        def c(t=t, v=v):
            return bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n,
                                all_relu=all_relu)

        ys = [c() for _ in range(3)]
        assert all(torch.equal(ys[0].view(torch.int16), y.view(torch.int16)) for y in ys[1:])
        want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n,
                                  all_relu=all_relu)
        torch.testing.assert_close(ys[0].float(), want.float(), **BF16_TOL)
        assert torch.equal(ys[0], c(t_full, v_full))


def test_kernel_c_f32_refuses_the_all_relu_store(cuda):
    topo = tsp.BlockTopology(tsp.BlockMeta(16, 16, 16, 16), np.array([0]), np.array([0]))
    t = topo.device_arrays(cuda)
    launches = bsm.bsmm_fwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        bsm.bsmm_fwd(torch.zeros((8, 16), device=cuda), torch.zeros((1, 16, 16), device=cuda),
                     t.rows, t.cols, t.first_col, grid_n=1, all_relu=(0.6, 1))
    assert bsm.bsmm_fwd.launches == launches


@pytest.mark.parametrize("shape", [(8, 2816), (256, 2816), (5, 1001), (3, 7)])
@pytest.mark.parametrize("layer_index", [1, 2])
@pytest.mark.parametrize("with_bias", [False, True])
def test_kernel_b_bf16_bit_equal_to_plain(cuda, shape, layer_index, with_bias):
    rng = np.random.default_rng(layer_index)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 3,
                        device=cuda).to(torch.bfloat16)
    b = (torch.as_tensor(rng.standard_normal(shape[1:]).astype(np.float32), device=cuda)
         .to(torch.bfloat16) if with_bias else None)
    before = all_relu_fused.bias_all_relu.launches
    got = all_relu_fused.bias_all_relu(x, b, alpha=0.6, layer_index=layer_index)
    torch.cuda.synchronize()
    assert all_relu_fused.bias_all_relu.launches == before + 1
    want = all_relu_fused.bias_all_relu_plain(x, b, alpha=0.6, layer_index=layer_index)
    assert got.dtype == torch.bfloat16 and torch.equal(got.view(torch.int16),
                                                       want.view(torch.int16))
    # rows at a pitch (a column slice of a wider product), and f32 without a bias
    wide = torch.cat([x, x], dim=1)[:, : shape[1]]
    assert torch.equal(all_relu_fused.bias_all_relu(wide, b, alpha=0.6, layer_index=layer_index),
                       got)
    xf = x.float()
    assert torch.equal(all_relu_fused.bias_all_relu(xf, None, alpha=0.6, layer_index=layer_index),
                       all_relu_fused.bias_all_relu_plain(xf, None, alpha=0.6,
                                                          layer_index=layer_index))


def test_kernels_b_c_refuse_dtypes_they_lack(cuda):
    x = torch.zeros((8, 16), dtype=torch.float16, device=cuda)
    launches = (all_relu_fused.bias_all_relu.launches, bsm.bsmm_fwd.launches)
    with pytest.raises(ValueError, match="dtype"):
        all_relu_fused.bias_all_relu(x, None, alpha=0.6, layer_index=1)
    topo = tsp.BlockTopology(tsp.BlockMeta(16, 16, 16, 16), np.array([0]), np.array([0]))
    t = topo.device_arrays(cuda)
    with pytest.raises(ValueError, match="dtype"):
        bsm.bsmm_fwd(x, torch.zeros((1, 16, 16), dtype=torch.float16, device=cuda), t.rows,
                     t.cols, t.first_col, grid_n=1)
    with pytest.raises(ValueError, match="dtype"):  # values of another dtype than x
        bsm.bsmm_fwd(x.to(torch.bfloat16), torch.zeros((1, 16, 16), device=cuda), t.rows,
                     t.cols, t.first_col, grid_n=1)
    assert (all_relu_fused.bias_all_relu.launches, bsm.bsmm_fwd.launches) == launches


def test_lm_engine_bf16_on_card_matches_cpu(cuda):
    """The reference's serving LM (tests/test_serve.py's LM_CFG) in bf16: the
    card's forward, prefill caches and teacher-forced decode within 5e-2 of
    the CPU run (plain versions), every sparse FFN on kernel C (All-ReLU in
    W_in's store), and the card's engine serving a trace through the
    continuous batcher."""
    from repro_torch import configs
    from repro_torch.models.transformer import PatternLM
    from repro_torch.serve import ContinuousBatcher, poisson_trace

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, ffn="sparse",
                              sparse_block=16, sparse_density=0.5, d_ff=64, dtype="bfloat16")
    cpu = PatternLM(cfg, seed=0, device="cpu")
    card = PatternLM(cfg, seed=0, device=cuda)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    tol = dict(rtol=5e-2, atol=5e-2)
    want, wc, _ = cpu.forward(cpu.params, torch.as_tensor(toks), topo=cpu.topo_arrays(),
                              mode="prefill")
    c0, b0 = bsm.bsmm_fwd.launches, all_relu_fused.bias_all_relu.launches
    e0 = bsm.bsmm_fwd.epilogue_launches
    got, gc, _ = card.forward(card.params, torch.as_tensor(toks, device=cuda),
                              topo=card.topo_arrays(), mode="prefill")
    torch.cuda.synchronize()
    # All-ReLU in W_in's store: two kernel-C launches a layer, no kernel B
    assert (bsm.bsmm_fwd.launches - c0, bsm.bsmm_fwd.epilogue_launches - e0,
            all_relu_fused.bias_all_relu.launches - b0) == (2 * cfg.n_layers, cfg.n_layers, 0)
    torch.testing.assert_close(got.float().cpu(), want.float(), **tol)
    torch.testing.assert_close(gc["stack"]["s0_global"]["k"].float().cpu(),
                               wc["stack"]["s0_global"]["k"].float(), **tol)
    caches = {d: m.init_caches(2, 12) for d, m in (("cpu", cpu), ("card", card))}
    for pos in range(12):
        step = toks[:, pos:pos + 1]
        lw, _, _ = cpu.forward(cpu.params, torch.as_tensor(step), topo=cpu.topo_arrays(),
                               positions=torch.tensor([pos]), mode="decode",
                               caches=caches["cpu"])
        lg, _, _ = card.forward(card.params, torch.as_tensor(step, device=cuda),
                                topo=card.topo_arrays(), positions=torch.tensor([pos],
                                                                                device=cuda),
                                mode="decode", caches=caches["card"])
        torch.testing.assert_close(lg.float().cpu(), lw.float(), **tol)
    engine = SparseInferenceEngine(card, engine=EngineConfig(
        max_slots=4, max_len=48, prefill_buckets=(8, 16), prefill_batch=2))

    def trace(seed):
        return poisson_trace(8, rate=500.0, vocab=cfg.vocab, prompt_lens=(3, 14),
                             new_tokens=(1, 6), seed=seed)

    ContinuousBatcher(engine, queue_capacity=16).run(trace(0))
    builds = engine.stats["compiles"]
    c0 = bsm.bsmm_fwd.launches
    stats = ContinuousBatcher(engine, queue_capacity=16).run(trace(7))
    assert stats.completed == 8 and engine.stats["compiles"] == builds
    assert bsm.bsmm_fwd.launches - c0 == 2 * cfg.n_layers * (stats.decode_steps
                                                             + stats.prefill_calls)


# -- the bfloat16 LM's training: kernels D and E bf16, kernel C's backward ------

DE_BF16_ROWS = (1, 8, 256, 2048)  # one row, a decode step's, a prefill's, a train step's


def _de_bf16_inputs(cuda, meta, topo, rows, seed):
    """Random bf16 tiles (the init's scale), x and dy for one topology."""
    rng = np.random.default_rng(seed)
    shape = (topo.n_blocks, meta.block_m, meta.block_n)
    v = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 0.05, device=cuda)
    x = torch.as_tensor(rng.standard_normal((rows, meta.padded_in)).astype(np.float32),
                        device=cuda)
    dy = torch.as_tensor(rng.standard_normal((rows, meta.padded_out)).astype(np.float32),
                         device=cuda)
    return (topo.device_arrays(cuda),) + tuple(a.to(torch.bfloat16) for a in (v, x, dy))


def _check_de_bf16(meta, topo, t, v, x, dy):
    """D and E bf16 within 1e-2 of their plain versions (both round an f32
    sum once, in other orders) and 5e-2 of ``ref.bsmm_*_ref`` (the
    reference's bf16 tolerance), the same bits on three launches, each
    launch counted as a bf16 one, uncovered dx block-rows exactly 0."""
    names = ("launches", "bf16_launches")
    before = [getattr(k, n) for k in (bsm.bsmm_dx, bsm.bsmm_dw) for n in names]
    passes = (bsm.bsmm_dx.second_pass_launches, bsm.bsmm_dw.second_pass_launches)
    dxs = [bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
           for _ in range(3)]
    dws = [bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n)
           for _ in range(3)]
    torch.cuda.synchronize()
    after = [getattr(k, n) for k in (bsm.bsmm_dx, bsm.bsmm_dw) for n in names]
    assert [a - b for a, b in zip(after, before)] == [3, 3, 3, 3]
    # one launch a call: D sums a block-row whole, E's runs meet in its
    # clusters' shared memory
    assert (bsm.bsmm_dx.second_pass_launches, bsm.bsmm_dw.second_pass_launches) == passes
    for got in (dxs, dws):
        assert got[0].dtype == torch.bfloat16
        assert all(torch.equal(got[0].view(torch.int16), g.view(torch.int16)) for g in got[1:])
    dx, dw = dxs[0], dws[0]
    torch.testing.assert_close(dx.float(), bsm.bsmm_dx_plain(
        dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m).float(),
        **BF16_TOL)
    torch.testing.assert_close(dw.float(), bsm.bsmm_dw_plain(
        x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n).float(), **BF16_TOL)
    torch.testing.assert_close(dx.float(), ref.bsmm_dx_ref(
        dy.float(), v.float(), t.rows, t.cols, grid_m=meta.grid_m, grid_n=meta.grid_n),
        rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(dw.float(), ref.bsmm_dw_ref(
        x.float(), dy.float(), t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n),
        rtol=5e-2, atol=5e-2)
    covered = np.zeros(meta.grid_m, bool)
    covered[topo.rows] = True
    uncovered = torch.as_tensor(np.repeat(~covered, meta.block_m), device=dx.device)
    assert (dx[:, uncovered] == 0).all()


def _full_width_topo(which):
    """The served LM's first-layer W_in or W_out topology (seed 0)."""
    rng = np.random.default_rng(0)
    t_in = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(1024, 2816), 64.0, rng)
    t_out = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2816, 1024), 64.0, rng)
    return t_in if which == "win" else t_out


@pytest.mark.parametrize("rows", DE_BF16_ROWS)
@pytest.mark.parametrize("which", ["win", "wout"])
def test_kernels_d_e_bf16_on_the_lm_ffn(cuda, which, rows):
    """The served LM's first-layer W_in (22 tiles on 8 x 22) and W_out (15 on
    22 x 8, block-rows with no tile) at 1, 8, 256 and 2,048 rows."""
    topo = _full_width_topo(which)
    _check_de_bf16(topo.meta, topo, *_de_bf16_inputs(cuda, topo.meta, topo, rows, rows))


@pytest.mark.parametrize("rows", (63, 64, 65, 255, 256, 257, 4096))
@pytest.mark.parametrize("which", ["win", "wout"])
def test_kernels_d_e_bf16_on_ragged_chunks(cuda, which, rows):
    """Batches one row either side of E's 64-row chunks and of D's 128-row
    tiles, and 4,096 rows (E in 4 or 6 runs, D in one run)."""
    topo = _full_width_topo(which)
    _check_de_bf16(topo.meta, topo, *_de_bf16_inputs(cuda, topo.meta, topo, rows, rows + 1))


@pytest.mark.parametrize("rows", (960, 1100, 1536, 2100, 2600, 3100, 3600, 4100))
def test_kernel_e_bf16_every_cluster_size(cuda, rows):
    """One 128 x 128 tile: E's runs S = 1, 2, ..., 8 (dw_splits_bf16), most
    with a ragged last chunk; D on the same tile (its other block-row 0)."""
    meta = tsp.BlockMeta(256, 128, 128, 128)
    topo = tsp.BlockTopology(meta, np.array([1]), np.array([0]))
    assert bsm.dw_splits_bf16(1, rows) == [960, 1100, 1536, 2100, 2600, 3100, 3600,
                                           4100].index(rows) + 1
    _check_de_bf16(meta, topo, *_de_bf16_inputs(cuda, meta, topo, rows, rows))


@pytest.mark.parametrize("case", [(length, rows) for length in (4, 5, 8)
                                  for rows in (8, 256, 2048)])
def test_kernels_d_e_bf16_on_long_columns(cuda, case):
    """W_in's grid with every block-column holding 4, 5 or 8 slots: block-rows
    of 11 to 22 slots, longer than kernel D's ring of 3."""
    length, rows = case
    rng = np.random.default_rng(length)
    meta = tsp.BlockMeta(1024, 2816, 128, 128)
    block_rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                                 for _ in range(meta.grid_n)])
    topo = tsp.BlockTopology(meta, block_rows, np.repeat(np.arange(meta.grid_n), length))
    _check_de_bf16(meta, topo, *_de_bf16_inputs(cuda, meta, topo, rows, length))


def test_kernels_d_e_bf16_on_every_served_layer(cuda):
    """Every layer's W_in and W_out topology of the served model
    (Qwen1.5-0.5B, the sparse FFN, seed 0) at a train step's 2,048 rows."""
    from repro_torch import configs
    from repro_torch.models.transformer import PatternLM

    cfg = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").config, ffn="sparse")
    model = PatternLM(cfg, seed=0, device="cpu")  # the host topologies only
    layers = 0
    for pairs in model.topologies.values():
        for pair in pairs:
            layers += 1
            for topo in pair:
                _check_de_bf16(topo.meta, topo,
                               *_de_bf16_inputs(cuda, topo.meta, topo, 2048, layers))
    assert layers == cfg.n_layers


@pytest.mark.parametrize("tile", [(16, 16), (32, 48), (96, 16), (128, 64), (48, 128)])
def test_kernels_d_e_bf16_take_tile_sides_multiples_of_16(cuda, tile):
    """Sides below the blocks' 64 features (masked) at a ragged batch of 77."""
    bm, bn = tile
    meta = tsp.BlockMeta(5 * bm, 3 * bn, bm, bn)
    topo = tsp.BlockTopology.erdos_renyi(meta, 0.5, np.random.default_rng(bm + bn))
    _check_de_bf16(meta, topo, *_de_bf16_inputs(cuda, meta, topo, 77, bm))


def test_kernels_d_e_bf16_refuse_what_they_cannot_take(cuda):
    meta = tsp.BlockMeta(16, 16, 8, 8)
    topo = tsp.BlockTopology.erdos_renyi(meta, 1.0, np.random.default_rng(0))
    t, v, x, dy = _de_bf16_inputs(cuda, meta, topo, 4, 0)
    before = (bsm.bsmm_dx.launches, bsm.bsmm_dw.launches)
    with pytest.raises(ValueError, match="multiples of 16"):
        bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
    with pytest.raises(ValueError, match="multiples of 16"):
        bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=8, block_n=8)
    topo = _full_width_topo("wout")
    t, v, x, dy = _de_bf16_inputs(cuda, topo.meta, topo, 4, 1)
    with pytest.raises(ValueError, match="dtype"):  # tiles of another dtype than dy
        bsm.bsmm_dx(dy, v.float(), t.rows_r, t.cols_r, t.first_row, t.perm_r,
                    grid_m=meta.grid_m)
    with pytest.raises(ValueError, match="dtype"):
        bsm.bsmm_dw(x.half(), dy.half(), t.rows, t.cols, block_m=128, block_n=128)
    assert (bsm.bsmm_dx.launches, bsm.bsmm_dw.launches) == before


def test_kernels_d_e_bf16_take_an_unaligned_input(cuda):
    """A contiguous dy whose storage starts 2 bytes past a 16-byte boundary
    (a view at an offset) gives the aligned call's bits."""
    topo = _full_width_topo("win")
    meta = topo.meta
    t, v, x, dy = _de_bf16_inputs(cuda, meta, topo, 100, 2)
    flat = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)
    du = flat[1:].view(dy.shape)
    du.copy_(dy)
    assert du.is_contiguous() and du.data_ptr() % 16 == 2
    assert torch.equal(bsm.bsmm_dx(du, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                   grid_m=meta.grid_m),
                       bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                   grid_m=meta.grid_m))
    assert torch.equal(bsm.bsmm_dw(x, du, t.rows, t.cols, block_m=128, block_n=128),
                       bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=128, block_n=128))


def test_bf16_block_op_gradients_match_plain_autograd(cuda):
    """``ops.bsmm`` in bf16: kernels C, D and E against ``bsmm_xla``'s
    autograd, at the reference's bf16 tolerance."""
    meta = tsp.BlockMeta(1024, 2816)
    topo = tsp.BlockTopology.from_epsilon(meta, 64.0, np.random.default_rng(3))
    t, v, _, _ = _de_bf16_inputs(cuda, meta, topo, 1, 3)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((4, 64, 1024)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    g = torch.as_tensor(rng.standard_normal((4, 64, 2816)).astype(np.float32),
                        device=cuda).to(torch.bfloat16)
    grads = []
    for impl in ("kernel", "xla"):
        xx, vv = x.clone().requires_grad_(True), v.clone().requires_grad_(True)
        (ops.bsmm(xx, vv, t, meta, impl=impl).float() * g.float()).sum().backward()
        grads.append((xx.grad, vv.grad))
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b.float(), rtol=5e-2, atol=5e-2)


def test_lm_train_step_bf16_on_card_matches_f32(cuda):
    """The smoke LM's bf16 train step on the card (kernels C, D and E, remat)
    against the f32 step on the CPU on the same bf16 weights: the loss and
    each gradient leaf within 5e-2 (relative, relative L2), on a batch of the
    training stream (examples/train_lm_torch.py's, seed 0, 8 x 32); and the
    launches: C four times a layer (forward, recompute), D and E bf16 twice."""
    import importlib.util
    from pathlib import Path

    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.transformer import PatternLM
    from repro_torch.tree import tree_flatten_with_names, tree_map

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, ffn="sparse",
                              sparse_block=32, sparse_density=0.5, dtype="bfloat16")
    card = PatternLM(cfg, seed=0, device=cuda)
    cpu = PatternLM(dataclasses.replace(cfg, dtype="float32"), seed=0, device="cpu")
    cpu.params = tree_map(lambda a: a.float().cpu(), card.params)
    toks = torch.as_tensor(next(example.synthetic_stream(np.random.default_rng(0), cfg.vocab,
                                                         8, 33))).long()
    grads = {}
    for name, model in (("card", card), ("cpu", cpu)):
        batch = {"tokens": toks[:, :-1].to(model.device), "labels": toks[:, 1:].to(model.device)}
        c0, d0, e0 = bsm.bsmm_fwd.launches, bsm.bsmm_dx.bf16_launches, bsm.bsmm_dw.bf16_launches
        _, loss, g = steps._microbatched_grad(steps.lm_loss_fn(model, model.topo_arrays()),
                                              model.params, batch, 1)
        if name == "card":
            torch.cuda.synchronize()
            assert (bsm.bsmm_fwd.launches - c0, bsm.bsmm_dx.bf16_launches - d0,
                    bsm.bsmm_dw.bf16_launches - e0) == (4 * cfg.n_layers, 2 * cfg.n_layers,
                                                        2 * cfg.n_layers)
        grads[name] = (float(loss), tree_flatten_with_names(g)[0])
    assert abs(grads["card"][0] - grads["cpu"][0]) <= 5e-2 * abs(grads["cpu"][0])
    for (name, a), (_, b) in zip(grads["card"][1], grads["cpu"][1]):
        assert a.dtype == torch.bfloat16, name
        err = float((a.float().cpu() - b).norm() / b.norm())
        assert err <= 5e-2, (name, err)


# -- recurrentgemma-2b's sparse FFN: kernels C, D and E bf16 on its grids -------

# recurrentgemma-2b with the paper's sparse FFN (128 x 128 tiles, epsilon 64,
# seed 0): W_in 2560 -> 7680 holds 60 tiles on 20 x 60 (a tile a column,
# block-rows of up to 5 slots), W_out 7680 -> 2560 holds 40 on 60 x 20
# (columns of up to 6 slots, block-rows of up to 3). The ring rule: C's rings
# hold 4 slot stages (3 on the rows route's 64 x 64 tile) and D's 3, so
# W_out's columns of 6 run C's rings round and W_in's block-rows of 5 run D's.
C_RING, D_RING = 4, 3


def _rg_topo(which):
    rng = np.random.default_rng(0)
    t_in = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2560, 7680), 64.0, rng)
    t_out = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(7680, 2560), 64.0, rng)
    assert (t_in.n_blocks, t_out.n_blocks) == (60, 40)
    assert (t_in.meta.grid_m, t_in.meta.grid_n) == (20, 60)
    longest_col = np.bincount(t_out.cols, minlength=t_out.meta.grid_n).max()
    longest_row = np.bincount(t_in.rows, minlength=t_in.meta.grid_m).max()
    assert longest_col == 6 > C_RING and longest_row == 5 > D_RING
    return t_in if which == "win" else t_out


@pytest.mark.parametrize("rows", [8, 16, 64, 2048])
@pytest.mark.parametrize("which", ["win", "wout"])
def test_kernel_c_bf16_on_recurrentgemma_ffn(cuda, which, rows):
    """Kernel C bf16 on recurrentgemma-2b's W_in and W_out at a decode
    step's rows (8, 16: the decode route) and a prefill's and a train step's
    (64, 2,048: the rows route): within 1e-2 of its plain version and 5e-2 of
    ``ref.bsmm_ref``, one launch on the planned route, the same bits on three
    launches; with All-ReLU in its store, both parities, bit-equal to C then
    kernel B."""
    topo = _rg_topo(which)
    meta = topo.meta
    t, v, x = _bf16_case(cuda, rows, meta, topo, np.random.default_rng(rows))
    plan = bsm.fwd_plan(topo.n_blocks, meta.grid_n, rows, 128, 128, bf16=True)
    assert plan.route == ("decode" if rows <= 16 else "rows") and plan.parts == 1
    names = ("launches", "second_pass_launches", "decode_launches", "rows_launches")
    before = [getattr(bsm.bsmm_fwd, n) for n in names]
    ys = [bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n) for _ in range(3)]
    torch.cuda.synchronize()
    got = [getattr(bsm.bsmm_fwd, n) - b for n, b in zip(names, before)]
    assert got == [3, 0, 3 * (plan.route == "decode"), 3 * (plan.route == "rows")]
    assert all(torch.equal(ys[0].view(torch.int16), y.view(torch.int16)) for y in ys[1:])
    want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
    torch.testing.assert_close(ys[0].float(), want.float(), **BF16_TOL)
    oracle = ref.bsmm_ref(x.float(), v.float(), t.rows, t.cols, grid_m=meta.grid_m,
                          grid_n=meta.grid_n)
    torch.testing.assert_close(ys[0].float(), oracle, rtol=5e-2, atol=5e-2)
    for layer_index in (1, 2):
        fused = [bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n,
                              all_relu=(0.6, layer_index)) for _ in range(3)]
        assert all(torch.equal(fused[0].view(torch.int16), f.view(torch.int16))
                   for f in fused[1:])
        after = all_relu_fused.bias_all_relu(ys[0], None, alpha=0.6, layer_index=layer_index)
        assert torch.equal(fused[0].view(torch.int16), after.view(torch.int16))


@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("which", ["win", "wout"])
def test_kernels_d_e_bf16_on_recurrentgemma_ffn(cuda, which, rows):
    """Kernels D and E bf16 on recurrentgemma-2b's W_in (block-rows of 5,
    longer than D's ring) and W_out (60 block-rows, 20 columns) at 8 and a
    train step's 2,048 rows (E's runs S by ``dw_splits_bf16``: 1 on W_in's 60
    tiles, 2 on W_out's 40)."""
    topo = _rg_topo(which)
    assert bsm.dw_splits_bf16(topo.n_blocks, 2048) == {"win": 1, "wout": 2}[which]
    _check_de_bf16(topo.meta, topo, *_de_bf16_inputs(cuda, topo.meta, topo, rows, rows + 3))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "falcon-mamba-7b", "qwen3-moe-30b-a3b"])
def test_recurrent_and_moe_archs_on_card_match_cpu(cuda, arch):
    """The RG-LRU, Mamba-1 and MoE blocks (plain PyTorch: the chunked scans,
    the stable dispatch sort, the fixed-order combine) at their SMOKE
    configs in f32: logits, loss with the auxiliary loss, and gradients on
    the card within 1e-4 of the CPU's (relative L2 a leaf for gradients);
    a decode step's logits too; the MoE forward the same bits twice."""
    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models.transformer import PatternLM
    from repro_torch.tree import tree_flatten_with_names

    cfg = configs.get_spec(arch).smoke
    cpu = PatternLM(cfg, seed=0, device="cpu")
    card = PatternLM(cfg, seed=0, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 33)))
    res = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        total, loss, g = steps._microbatched_grad(steps.lm_loss_fn(model, model.topo_arrays()),
                                                  model.params, batch, 1)
        with torch.no_grad():
            logits, _, aux = model.forward(model.params, batch["tokens"],
                                           topo=model.topo_arrays())
            again, _, _ = model.forward(model.params, batch["tokens"], topo=model.topo_arrays())
            caches = model.init_caches(2, 16, dtype=torch.float32)
            step, _, _ = model.forward(model.params, batch["tokens"][:, :1],
                                       topo=model.topo_arrays(),
                                       positions=torch.tensor([0], device=dev), mode="decode",
                                       caches=caches)
        assert torch.equal(logits, again)
        res[name] = (logits.cpu(), float(total), float(aux), step.cpu(),
                     [(n, a.cpu()) for n, a in tree_flatten_with_names(g)[0]])
    (l0, t0, a0, s0, g0), (l1, t1, a1, s1, g1) = res["cpu"], res["card"]
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, s0, rtol=1e-4, atol=1e-4)
    assert abs(t1 - t0) <= 1e-4 * abs(t0) and abs(a1 - a0) <= 1e-4 * max(abs(a0), 1e-6)
    assert (a0 > 0) == (cfg.ffn == "moe")
    for (name, a), (_, b) in zip(g1, g0):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7, name


# ---------------------------------------------------------------------------
# the observability layer (repro_torch.obs) and Whisper on the card
# ---------------------------------------------------------------------------


def test_span_block_on_waits_for_kernel_a(cuda, tmp_path):
    """A span that registers kernel A's result closes after the kernel has
    run: its duration is at least the launches' CUDA-event time."""
    from repro_torch import obs

    topo, vals, x = _layer(3, 400, 400, 100, 128)
    t = topo.device_arrays(cuda)
    srcT = torch.as_tensor(np.ascontiguousarray(x.T), device=cuda)
    v = torch.as_tensor(vals, device=cuda)
    tsp.coo_matmul_T(srcT, v, t.rows, t.cols, 400)  # built and warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    path = tmp_path / "t.jsonl"
    with obs.trace_to(str(path)):
        with obs.span("kernel_a") as sp:
            start.record()
            out = srcT
            for _ in range(50):  # long enough to outlast the host's enqueueing
                out = tsp.coo_matmul_T(srcT, v, t.rows, t.cols, 400, acc=out)
            end.record()
            sp.block_on({"out": [out]})
        assert end.query()  # the close waited
    span = next(e for e in obs.read_events(str(path)) if e.get("name") == "kernel_a")
    assert span["dur_s"] * 1e3 >= start.elapsed_time(end)


def test_sample_device_memory_on_card(cuda):
    from repro_torch import obs

    x = torch.empty(1 << 24, dtype=torch.uint8, device=cuda)
    reg = obs.MetricsRegistry(control=True)
    got = obs.sample_device_memory(reg)
    dev = torch.cuda.current_device()
    assert got[f"device_bytes_in_use{{device={dev}}}"] == torch.cuda.memory_allocated(dev)
    assert got[f"device_peak_bytes_in_use{{device={dev}}}"] == torch.cuda.max_memory_allocated(dev)
    assert got[f"device_bytes_in_use{{device={dev}}}"] >= x.numel()
    assert got["device_live_buffers"] >= 1
    assert not any("largest_alloc_size" in k for k in got)
    snap = reg.snapshot()
    assert snap[f'device_bytes_in_use{{device="{dev}"}}'] == got[
        f"device_bytes_in_use{{device={dev}}}"]


def _element_counts() -> dict:
    """The element path's launch counters (kernels A, B, F, G and their
    sub-counts)."""
    a, f = tsp.coo_matmul_T, tsp.coo_dw
    b, g = all_relu_fused.bias_all_relu, all_relu_fused.all_relu_bwd
    return {"coo_matmul_T": a.launches, "coo_matmul_T.epilogue": a.epilogue_launches,
            "coo_matmul_T.mask": a.mask_launches, "bias_all_relu": b.launches,
            "bias_all_relu.T": b.T_launches, "coo_dw": f.launches,
            "coo_dw.epilogue": f.epilogue_launches, "coo_dw.mask": f.mask_launches,
            "all_relu_bwd": g.launches}


def test_probed_segment_on_card_matches_cpu(cuda):
    """The probed element segment (784-300-100-10, 4 steps of 32, dropout
    0): its stats on the card within 1e-4 of the CPU's, the histograms
    equal; its weights and losses bit-equal to the unprobed segment's on the
    card; its launches the steps' plus the probe's exactly."""
    from repro_torch.train.trainer import make_segment_program

    cfg = SparseMLPConfig(layer_dims=(784, 300, 100, 10), epsilon=20, impl="element",
                          dropout=0.0)
    opt = MomentumSGD()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 784)).astype(np.float32)
    y = rng.integers(0, 10, 256)
    perm = rng.permutation(256)[:128].reshape(4, 32)
    res = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda), ("card_off", cuda)):
        model = SparseMLP(cfg, seed=0, device=dev)
        args = (model.params(), opt.init(model.params()), model.topo_arrays(),
                torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev).long(),
                torch.as_tensor(perm, device=dev), torch.full((4,), 0.01, device=dev),
                torch.Generator(device=dev))
        before = _element_counts()
        out = make_segment_program(cfg, opt, probe=name != "card_off")(*args)
        torch.cuda.synchronize()
        res[name] = (out, {k: n - before[k] for k, n in _element_counts().items()})
    (cpu, _), (card, n_on), (off, n_off) = res["cpu"], res["card"], res["card_off"]
    L = cfg.n_layers
    probe = {"coo_matmul_T": 2 * L - 1, "coo_matmul_T.epilogue": L, "bias_all_relu": L - 1,
             "bias_all_relu.T": L - 1, "coo_dw": L, "coo_dw.epilogue": L,
             "all_relu_bwd": L - 1}
    assert {k: n_on[k] - n_off[k] for k in n_on if n_on[k] != n_off[k]} == probe
    for a, b in zip(card[0]["values"], off[0]["values"]):
        assert torch.equal(a, b)
    assert torch.equal(card[3], off[3])
    for k, w in cpu[4].items():
        g = card[4][k].cpu()
        if k.endswith("_hist"):
            assert torch.equal(g, w), k
        else:
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6, msg=k)


def test_whisper_two_layer_cut_on_card_matches_cpu(cuda):
    """Whisper-medium cut to 2 + 2 layers at full width, in f32, on 1 x 64
    frames and 16 tokens: logits within 1e-4 of the CPU's, gradients
    within 1e-4 relative L2 a leaf, the cross attention's bias gradients
    exact zeros."""
    from repro_torch import configs
    from repro_torch.interop import whisper_from_numpy
    from repro_torch.launch import steps
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.tree import tree_flatten_with_names, tree_map

    cfg = dataclasses.replace(configs.get_spec("whisper-medium").config, n_layers=2,
                              dtype="float32")
    card = WhisperModel(cfg, seed=0, device=cuda)
    cpu = whisper_from_numpy(dataclasses.asdict(cfg),
                             tree_map(lambda a: a.cpu().numpy(), card.params), device="cpu")
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal((1, 64, cfg.d_model)), dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 17)))
    res = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        batch = {"frames": frames.to(dev), "tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        _, loss, g = steps._microbatched_grad(steps.whisper_loss_fn(model), model.params,
                                              batch, 1)
        with torch.no_grad():
            h = model.decode_train(model.params, batch["tokens"],
                                   model.encode(model.params, batch["frames"]))
            logits = model.logits(model.params, h)
        res[name] = (logits.cpu(), float(loss), [(n, a.cpu()) for n, a in
                                                 tree_flatten_with_names(g)[0]])
    (l0, s0, g0), (l1, s1, g1) = res["cpu"], res["card"]
    torch.testing.assert_close(l1, l0, rtol=1e-4, atol=1e-4)
    assert abs(s1 - s0) <= 1e-4 * abs(s0)
    for (name, a), (_, b) in zip(g1, g0):
        if "cross_attn" in name and name.endswith(("bq", "bk", "bv")):
            assert not a.any() and not b.any(), name
        else:
            assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7, name
