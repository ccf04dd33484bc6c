"""Kernels C and E's host-side pieces on the CPU: the split plans that cut a
long sum into contiguous runs (a pure function of host ints), the ordered
sum of the runs' partials, a numpy emulation of the 3xTF32 product the
kernels take on the tensor cores, and the library names that track the
shared header. The kernels themselves run on the card
(``tests/test_torch_gpu.py``, ``-m gpu``).

The precision argument: a sum over K = 4096 held at rtol = atol = 1e-4
(``chip_smoke.BLOCK_RTOL``) is out of reach of one TF32 product, and within
it for 3xTF32 (hi*lo + lo*hi + hi*hi, lo*lo dropped), as for plain f32.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.set_mlp import mlp_config
from repro_torch.core import sparsity as tsp
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import build
from repro_torch.models.mlp import SparseMLP, block_meta

BLOCK_RTOL = BLOCK_ATOL = 1e-4


def _covers_in_order(runs, begin, end):
    """The runs tile [begin, end) contiguously, in order, each index once."""
    assert runs[0][0] == begin and runs[-1][1] == end
    for (a, b), (c, _) in zip(runs, runs[1:]):
        assert a <= b == c
    assert [i for a, b in runs for i in range(a, b)] == list(range(begin, end))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 32, 33, 1000])
@pytest.mark.parametrize("parts", [1, 2, 3, 16, 32, 40])
def test_split_runs_cover_each_slot_once_in_order(n, parts):
    runs = bsm.split_runs(5, 5 + n, parts)
    assert len(runs) == parts
    _covers_in_order(runs, 5, 5 + n)
    sizes = [b - a for a, b in runs]
    assert max(sizes) - min(sizes) <= 1  # as even as the count allows


def test_fwd_parts_on_the_full_width_block_model():
    """P = 1 where a layer's columns already fill the card, P > 1 for the
    output layer's one column of 32 slots."""
    model = SparseMLP(mlp_config("cifar10", impl="block"), seed=0, device="cpu")
    cfg = model.config
    for batch in (128, 100):
        parts = []
        for l, topo in enumerate(model.topos):
            meta = block_meta(cfg, l)
            parts.append(bsm.fwd_parts(topo.n_blocks, meta.grid_n, batch, meta.block_n))
            col_ptr = np.searchsorted(topo.cols, np.arange(meta.grid_n + 1))
            runs = [bsm.split_runs(int(col_ptr[c]), int(col_ptr[c + 1]), parts[-1])
                    for c in range(meta.grid_n)]
            _covers_in_order([r for col in runs for r in col], 0, topo.n_blocks)
        assert parts[:3] == [1, 1, 1]
        assert 16 <= parts[3] <= 32
    # blocks fill a wave: P * (blocks without a split) stays within the SMs
    assert bsm.fwd_parts(32, 1, 128, 128) * 4 <= bsm.SMS


@pytest.mark.parametrize("batch", [0, 1, 100, 128, 300, 5000])
@pytest.mark.parametrize("nb, grid_n, bn", [(0, 3, 8), (1, 1, 128), (40, 1, 5), (33, 4, 8),
                                            (8, 8, 128), (32, 32, 128)])
def test_fwd_parts_bounds(batch, nb, grid_n, bn):
    p = bsm.fwd_parts(nb, grid_n, batch, bn)
    assert 1 <= p <= max(1, -(-nb // grid_n))
    blocks = grid_n * -(-batch // bsm.FWD_TILE) * -(-bn // bsm.FWD_TILE)
    assert p == 1 or p * blocks <= bsm.SMS


def test_fwd_split_of_an_empty_topology_and_of_one_full_column():
    # no slots at all: every run of every column is empty, and a column
    # with no slots writes zeros
    assert bsm.fwd_parts(0, 4, 128, 128) == 1
    assert bsm.split_runs(0, 0, 1) == [(0, 0)]
    assert bsm.dw_splits(0, 128, 128, 128) == 1
    # one block-column (of 4) holds all 40 slots: its range splits, the
    # other columns' runs are all empty
    col_ptr = tsp.segment_offsets(torch.zeros(40, dtype=torch.int32), 4).tolist()
    assert col_ptr == [0, 40, 40, 40, 40]
    p = bsm.fwd_parts(40, 4, 128, 8)
    assert p > 1
    runs = [bsm.split_runs(col_ptr[c], col_ptr[c + 1], p) for c in range(4)]
    _covers_in_order(runs[0], 0, 40)
    assert all(a == b == 40 for col in runs[1:] for a, b in col)


@pytest.mark.parametrize("case", [
    # (grid_m, grid_n, bm, bn, counts of slots per column, batch)
    (6, 1, 8, 8, [6], 33),
    (40, 3, 8, 16, [1, 2, 33], 5),
    (9, 4, 5, 5, [7, 0, 2, 9], 64),
])
def test_ordered_sum_of_runs_matches_the_plain_forward(case):
    """Kernel C's split, on the CPU: each run's partial tile from the plain
    product over its slots, the partials added in index order, equals the
    plain version (to f32 rounding)."""
    grid_m, grid_n, bm, bn, counts, batch = case
    rng = np.random.default_rng(0)
    cols = np.repeat(np.arange(grid_n), counts)
    rows = np.concatenate([np.sort(rng.choice(grid_m, k, replace=False)) for k in counts])
    nb = len(cols)
    x = torch.as_tensor(rng.standard_normal((batch, grid_m * bm)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((nb, bm, bn)).astype(np.float32))
    r, c = torch.as_tensor(rows, dtype=torch.int32), torch.as_tensor(cols, dtype=torch.int32)
    want = bsm.bsmm_fwd_plain(x, v, r, c, None, grid_n=grid_n)
    p = bsm.fwd_parts(nb, grid_n, batch, bn)
    col_ptr = np.searchsorted(cols, np.arange(grid_n + 1))
    partials = torch.zeros((p, batch, grid_n * bn))
    for col in range(grid_n):
        for q, (a, b) in enumerate(bsm.split_runs(int(col_ptr[col]), int(col_ptr[col + 1]), p)):
            if b > a:
                part = bsm.bsmm_fwd_plain(x, v[a:b], r[a:b], c[a:b], None, grid_n=grid_n)
                partials[q, :, col * bn:(col + 1) * bn] = part[:, col * bn:(col + 1) * bn]
    got = partials[0].clone()
    for q in range(1, p):
        got += partials[q]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [0, 1, 31, 32, 100, 128, 300])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 10])
def test_dw_batch_runs_cover_each_sample_once_in_chunks(batch, splits):
    runs = bsm.dw_batch_runs(batch, splits)
    assert len(runs) == splits
    _covers_in_order(runs, 0, batch)
    for a, b in runs:  # runs start on a chunk and end on one, or at the batch's end
        assert a % bsm.DW_CHUNK == 0 and (b % bsm.DW_CHUNK == 0 or b == batch)


def test_dw_splits_on_the_full_width_block_model():
    model = SparseMLP(mlp_config("cifar10", impl="block"), seed=0, device="cpu")
    s = [bsm.dw_splits(t.n_blocks, 128, 128, 128) for t in model.topos]
    assert s == [1, 4, 1, 1]  # layer 1 has 8 tiles: 32 blocks, split 4 ways
    for nb, batch in ((0, 128), (8, 0), (8, 1), (1, 5000), (8, 100), (1000, 128)):
        k = bsm.dw_splits(nb, batch, 8, 8)
        assert 1 <= k <= max(1, -(-batch // bsm.DW_CHUNK))
        runs = bsm.dw_batch_runs(batch, k)
        if batch:  # with S <= chunks, no run is empty
            assert all(b > a for a, b in runs)


def test_col_ptr_is_computed_once_per_topology_tensor():
    """Kernel C's wrapper reuses a column-offset tensor for the same
    (frozen) index tensor, and drops it with the index tensor."""
    cols = torch.tensor([0, 0, 2, 2, 2], dtype=torch.int32)
    first = bsm._offsets_once(cols, 3)
    assert first.tolist() == [0, 2, 2, 5]
    assert bsm._offsets_once(cols, 3) is first
    assert bsm._offsets_once(cols, 4).tolist() == [0, 2, 2, 5, 5]
    other = cols.clone()
    assert bsm._offsets_once(other, 3) is not first
    key = (id(cols), 3)
    del cols, first
    assert key not in bsm._OFFSETS


# -- 3xTF32 --------------------------------------------------------------------


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32``: keep 10 explicit mantissa bits, rounding to
    nearest with ties away from zero (add half of the dropped 13 bits'
    range to the magnitude, then clear them)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split3(a: np.ndarray):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _f32_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """An f32 product whose terms are exact in f32 (TF32 times TF32 has 22
    significant bits) and whose sums round in f32, as the tensor cores'
    accumulator does."""
    return (torch.as_tensor(a) @ torch.as_tensor(b)).numpy()


def _tolerance_ratio(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| / (atol + rtol |want|): below 1 passes the check."""
    return float((np.abs(got - want) / (BLOCK_ATOL + BLOCK_RTOL * np.abs(want))).max())


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-11),
                  1.0 + 2**-11 - 2**-23, 0.0, 3.0e-39], np.float32)
    np.testing.assert_array_equal(
        tf32_rna(a),
        np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0 + 2**-9, -(1.0 + 2**-10), 1.0, 0.0,
                  tf32_rna(np.float32(3.0e-39))], np.float32))
    x = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi, lo = split3(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    assert np.abs(x - hi).max() <= np.abs(x).max() * 2.0**-11
    # hi + lo carries 21-22 of f32's 24 bits
    assert (np.abs(x - (hi + lo)) <= np.abs(x) * 2.0**-21).all()


def test_3xtf32_holds_the_block_tolerance_where_1xtf32_does_not():
    """The output layer's product at batch 128: x (128 x 4096, ReLU'd
    normal, the 96 padded features zero) @ W (4096 x 128, he-uniform over
    fan-in 4000), against the f64 product."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((128, 4096)), 0).astype(np.float32)
    x[:, 4000:] = 0
    lim = np.sqrt(6.0 / 4000)
    w = rng.uniform(-lim, lim, (4096, 128)).astype(np.float32)
    want = x.astype(np.float64) @ w.astype(np.float64)
    x_hi, x_lo = split3(x)
    w_hi, w_lo = split3(w)
    three = _f32_matmul(x_lo, w_hi) + _f32_matmul(x_hi, w_lo) + _f32_matmul(x_hi, w_hi)
    one = _f32_matmul(x_hi, w_hi)
    f32 = _f32_matmul(x, w)
    r3, r1, rf = (_tolerance_ratio(a, want) for a in (three, one, f32))
    assert r3 < 0.1, r3  # ~0.01: as accurate as f32
    assert rf < 0.1, rf
    assert r3 < 3 * rf
    assert r1 > 1.0, r1  # one TF32 pass fails rtol = atol = 1e-4


# -- the build's names ---------------------------------------------------------


def test_library_path_tracks_the_shared_header(tmp_path, monkeypatch):
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert (tmp_path / "tf32x3.cuh").exists()
    before = {s: build.library_path(s) for s in build.KERNEL_SOURCES}
    header = tmp_path / "tf32x3.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {s: build.library_path(s) for s in build.KERNEL_SOURCES}
    assert all(before[s] != after[s] for s in build.KERNEL_SOURCES)
    assert after == {s: build.library_path(s) for s in build.KERNEL_SOURCES}  # stable
