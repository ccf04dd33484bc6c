"""Kernels A and D's host-side plans on the CPU, pure functions of host
ints: kernel D's split of a block-row's slot range into runs (``dx_parts``)
and the ordered sum of the runs' partials, and kernel A's route
(``coo_route``) from the longest segment of the offsets the engine makes on
the host. The kernels run on the card (``tests/test_torch_gpu.py``,
``-m gpu``).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.set_mlp import mlp_config
from repro_torch.core import sparsity as tsp
from repro_torch.core.importance import PruningSchedule
from repro_torch.core.topology import block_device_arrays
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.models.mlp import SparseMLP, block_meta
from repro_torch.serve import SparseInferenceEngine

BLOCK_RTOL = BLOCK_ATOL = 1e-4


# -- kernel D's split ------------------------------------------------------------


@pytest.mark.parametrize("batch", [100, 128])
def test_dx_parts_on_the_full_width_block_model(batch):
    """Layer 2 (8 block-rows of 4 slots: 32 blocks) splits 4 ways; layers 1
    and 3, whose block-rows fill the card, and layer 0 (no dx) do not."""
    model = SparseMLP(mlp_config("cifar10", impl="block"), seed=0, device="cpu")
    parts = []
    for l, topo in enumerate(model.topos):
        meta = block_meta(model.config, l)
        parts.append(bsm.dx_parts(topo.n_blocks, meta.grid_m, batch, meta.block_m))
        assert parts[-1] <= max(1, -(-topo.n_blocks // meta.grid_m))  # the mean slots per row
    assert parts == [1, 1, 4, 1]


@pytest.mark.parametrize("batch", [0, 1, 100, 128, 300, 5000])
@pytest.mark.parametrize("nb, grid_m, bm", [(0, 3, 8), (1, 1, 128), (40, 3, 5), (43, 4, 128),
                                            (8, 32, 128), (32, 8, 128), (32, 32, 128)])
def test_dx_parts_bounds(batch, nb, grid_m, bm):
    p = bsm.dx_parts(nb, grid_m, batch, bm)
    assert 1 <= p <= max(1, -(-nb // grid_m))
    blocks = grid_m * -(-batch // bsm.FWD_TILE) * -(-bm // bsm.FWD_TILE)
    assert p == 1 or p * blocks <= bsm.SMS
    if nb == 0:
        assert p == 1


def _rows_topology(counts, grid_n, seed):
    """Canonical (col, row) arrays whose block-rows hold ``counts`` slots."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(len(counts)), counts)
    cols = np.concatenate([rng.choice(grid_n, k, replace=False) for k in counts])
    order = np.lexsort((rows, cols))
    return rng, rows[order].astype(np.int32), cols[order].astype(np.int32)


@pytest.mark.parametrize("case", [
    # (block-row counts, grid_n, bm, bn, batch)
    ([0, 40, 0], 42, 8, 8, 100),
    ([1, 2, 7, 33], 35, 5, 5, 128),
    ([4, 4, 4, 4, 4, 4, 4, 4], 32, 16, 8, 33),
    ([0, 3, 0, 9, 1], 12, 8, 16, 7),
])
def test_ordered_sum_of_dx_runs_matches_the_plain_dx(case):
    """Kernel D's split, on the CPU: each run's partial from the plain
    product over its slots, the partials added in index order, equals the
    unsplit plain version, and uncovered block-rows are exactly 0."""
    counts, grid_n, bm, bn, batch = case
    rng, rows, cols = _rows_topology(counts, grid_n, seed=len(counts))
    grid_m, nb = len(counts), len(rows)
    meta = tsp.BlockMeta(grid_m * bm, grid_n * bn, bm, bn)
    t = block_device_arrays(torch.as_tensor(rows), torch.as_tensor(cols), meta=meta)
    v = torch.as_tensor(rng.standard_normal((nb, bm, bn)).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal((batch, grid_n * bn)).astype(np.float32))
    want = bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=grid_m)
    p = bsm.dx_parts(nb, grid_m, batch, bm)
    assert p > 1
    row_ptr = tsp.segment_offsets(t.rows_r, grid_m).tolist()
    partials = torch.zeros((p, batch, grid_m * bm))
    for r in range(grid_m):
        for q, (a, b) in enumerate(bsm.split_runs(row_ptr[r], row_ptr[r + 1], p)):
            part = bsm.bsmm_dx_plain(dy, v, t.rows_r[a:b], t.cols_r[a:b], None, t.perm_r[a:b],
                                     grid_m=grid_m)
            partials[q, :, r * bm:(r + 1) * bm] = part[:, r * bm:(r + 1) * bm]
    got = partials[0].clone()
    for q in range(1, p):
        got += partials[q]
    torch.testing.assert_close(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    uncovered = [r for r, k in enumerate(counts) if k == 0]
    tiles = got.reshape(batch, grid_m, bm)[:, uncovered]
    assert torch.equal(tiles, torch.zeros_like(tiles))
    assert not torch.signbit(tiles).any()  # +0: a split of an empty range sums to +0


def test_row_ptr_is_computed_once_per_topology_tensor():
    """Kernel D's row offsets come from the same once-per-tensor cache as
    kernel C's column offsets."""
    rows_r = torch.tensor([1, 1, 1, 3], dtype=torch.int32)
    first = bsm._offsets_once(rows_r, 4)
    assert first.tolist() == [0, 0, 3, 3, 4]
    assert bsm._offsets_once(rows_r, 4) is first
    key = (id(rows_r), 4)
    del rows_r, first
    assert key not in bsm._OFFSETS


# -- kernel A's route ------------------------------------------------------------


def _engine(compact: bool):
    model = SparseMLP(mlp_config("cifar10"), seed=0, device="cpu")
    return SparseInferenceEngine(model, compaction=PruningSchedule(tau=0, period=1,
                                                                   percentile=30.0),
                                 compact=compact, device="cpu")


@pytest.mark.parametrize("compact", [True, False])
def test_coo_route_on_the_served_model(compact):
    """The engine's host offsets pick the staged route for the output layer
    (10 segments of 2,800 slots compacted, 4,000 not) and one thread per
    output for the hidden layers (at most 131 slots a segment)."""
    engine = _engine(compact)
    longest, routes = [], []
    for t, topo in zip(engine._topo, engine.model.topos):
        seg_ptr = tsp.registered_offsets(t.cols)
        longest.append(tsp._longest_segment(seg_ptr, topo.nnz, topo.out_dim))
        assert longest[-1] == int(np.diff(topo.col_ptr()).max())
        routes.append(tsp.coo_route(longest[-1]))
    assert routes == [tsp.COO_THREAD] * 3 + [tsp.COO_STAGED]
    assert longest[-1] == (2800 if compact else 4000)
    assert max(longest[:3]) < tsp.COO_LONG_SEGMENT <= longest[3]


def test_coo_route_without_host_offsets_follows_the_mean_segment():
    seg_ptr = tsp.offsets_to_device(np.array([0, 2000, 2000, 2001]), torch.device("cpu"))
    assert tsp._longest_segment(seg_ptr, 2001, 3) == 2000
    same_values = seg_ptr.clone()  # not made on the host: the mean decides
    assert tsp._longest_segment(same_values, 2001, 3) == 667
    assert tsp._longest_segment(None, 2001, 3) == 667
    assert tsp._longest_segment(None, 0, 0) == 0
    assert tsp.coo_route(667) == tsp.COO_STAGED and tsp.coo_route(20) == tsp.COO_THREAD
    key = id(seg_ptr)
    del seg_ptr
    assert key not in tsp._LONGEST
    empty = tsp.offsets_to_device(np.array([0]), torch.device("cpu"))
    assert tsp._longest_segment(empty, 0, 0) == 0
