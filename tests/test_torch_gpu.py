"""The port's CUDA kernels and its serving path on the card, against their
plain PyTorch versions. Every test here carries the ``gpu`` marker and skips
where there is no card; the file imports no JAX, so it runs on a machine
that has only the port:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Kernel A sums each segment in slot order, the plain version through
``index_add_`` (atomics on the card), so they are held at rtol/atol 1e-5;
kernel B does the plain version's f32 arithmetic and is held bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sparsity as tsp
from repro_torch.core.importance import PruningSchedule
from repro_torch.kernels import all_relu_fused
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
from repro_torch.serve import EngineConfig, SparseInferenceEngine, importance_prune_mlp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
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
    got = card.classify(x)
    forwards = 3  # 4 + 4 + (1 padded to 2)
    assert tsp.coo_matmul_T.launches - a0 == forwards * 3
    assert all_relu_fused.bias_all_relu.launches - b0 == forwards * 2
    np.testing.assert_allclose(got, cpu.classify(x), rtol=1e-5, atol=1e-5)
    # lossless compaction holds bit for bit on the card
    pruned, _ = importance_prune_mlp(_model(cuda), sched)
    pruned_eng = SparseInferenceEngine(pruned, compact=False, engine=ec)
    np.testing.assert_array_equal(pruned_eng.classify(x), got)
