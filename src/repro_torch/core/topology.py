"""SET topology evolution (Mocanu et al. 2018) for both sparsity
granularities. Twin of ``repro.core.topology``.

Paper Algorithm 2, weight pruning-regrowing cycle:

* element granularity (paper-faithful): remove the zeta-tail of the
  smallest positive and of the largest negative weights (and exact zeros),
  regrow as many at random vacant positions, drawn by the init scheme;
* block granularity: the prune criterion is the block's mean |w|; regrowth
  samples vacant tiles uniformly, and new blocks are zero-init so they
  change nothing until gradients flow into them.

Two substrates run the same cycle:

* **Host (numpy)** — :func:`evolve_element`, :func:`evolve_block`: numpy
  copies of the reference's algorithm and draws, so the same rng gives the
  same topology.
* **Device (torch)** — :func:`evolve_element_device`,
  :func:`evolve_block_device` (DESIGN.md §3): fixed-capacity arrays (SET
  keeps nnz and n_blocks), per-sign zeta-tail pruning by stable ranks,
  regrowth by candidate vacancy sampling, with no shape that depends on
  the data and no host sync, so an epoch and its evolution stay on the
  device. Each is split in two: the draws (:func:`evolution_draws`, from
  one ``torch.Generator``; the reference draws from ``jax.random``, so
  the two give other numbers) and the algorithm, fed them. The numpy
  versions fed the same draws (``*_device_reference``) are the oracle the
  card is held to. :func:`evolve_element_layers_device` and
  :func:`evolve_block_layers_device` evolve every layer of a model and
  rebuild its device arrays and the kernels' plans on the device
  (:func:`element_device_arrays`, :func:`block_device_arrays`).

``RetainValidUpdates`` (Algorithm 1, line 14) filters updates computed
against a stale topology down to the connections or tiles that still exist.

The connection-shard helpers at the end (:func:`element_shard_bounds` and
its kin) are numpy copies of the reference's, for the out-of-core stream
(``repro_torch.xl``, DESIGN.md §7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.sparsity import (
    BlockMeta,
    BlockTopoArrays,
    BlockTopology,
    ElemTopoArrays,
    ElementTopology,
    _init_numpy,
    register_device_plans,
    route_hints,
)
from repro_torch.kernels.block_sparse_matmul import trust_block_arrays

__all__ = [
    "EvolutionResult",
    "block_device_arrays",
    "check_element_shards",
    "element_device_arrays",
    "element_row_order",
    "element_shard_bounds",
    "element_shard_key_intervals",
    "evolution_draws",
    "evolve_block",
    "evolve_block_device",
    "evolve_block_device_reference",
    "evolve_block_layers_device",
    "evolve_element",
    "evolve_element_device",
    "evolve_element_device_reference",
    "evolve_element_layers_device",
    "pad_shard",
    "prune_indices_by_magnitude",
    "retain_valid_updates_block",
    "retain_valid_updates_element",
]


class EvolutionResult(NamedTuple):
    topology: object          # ElementTopology | BlockTopology
    values: np.ndarray        # re-aligned weight values
    momentum: Optional[np.ndarray]  # re-aligned momentum (reset on new slots)
    n_pruned: int
    n_grown: int


def prune_indices_by_magnitude(values: np.ndarray, zeta: float) -> np.ndarray:
    """Paper-exact criterion: indices of the zeta-tail of smallest positive
    and the zeta-tail of largest negative weights (plus exact zeros)."""
    v = np.asarray(values)
    pos = np.flatnonzero(v > 0)
    neg = np.flatnonzero(v < 0)
    zero = np.flatnonzero(v == 0)
    k_pos = int(zeta * pos.size)
    k_neg = int(zeta * neg.size)
    drop = [zero]
    if k_pos > 0:
        drop.append(pos[np.argsort(v[pos])[:k_pos]])          # smallest positive
    if k_neg > 0:
        drop.append(neg[np.argsort(v[neg])[::-1][:k_neg]])    # largest negative
    return np.concatenate(drop)


def evolve_element(
    topo: ElementTopology,
    values: np.ndarray,
    zeta: float,
    rng: np.random.Generator,
    momentum: Optional[np.ndarray] = None,
    init_scheme: str = "normal",
) -> EvolutionResult:
    """Prune the zeta-tail per sign (:func:`prune_indices_by_magnitude`),
    regrow as many connections at vacant positions with ``init_scheme``
    values and zero momentum, and return them in canonical (col, row)
    order. The draws come in the reference's order: the vacancies, then the
    values."""
    values = np.asarray(values, np.float32)
    drop = prune_indices_by_magnitude(values, zeta)
    keep = np.setdiff1d(np.arange(topo.nnz), drop, assume_unique=False)

    rows_k, cols_k = topo.rows[keep], topo.cols[keep]
    vals_k = values[keep]
    mom_k = momentum[keep] if momentum is not None else None

    n_grow = topo.nnz - keep.size
    flat_existing = rows_k.astype(np.int64) * topo.out_dim + cols_k
    new_flat = _sample_vacant(topo.in_dim * topo.out_dim, flat_existing, n_grow, rng)
    new_rows = (new_flat // topo.out_dim).astype(np.int32)
    new_cols = (new_flat % topo.out_dim).astype(np.int32)
    new_vals = _init_numpy(rng, (n_grow,), fan_in_dense=topo.in_dim, scheme=init_scheme)

    rows = np.concatenate([rows_k, new_rows])
    cols = np.concatenate([cols_k, new_cols])
    vals = np.concatenate([vals_k, new_vals])
    mom = (
        np.concatenate([mom_k, np.zeros(n_grow, np.float32)])
        if mom_k is not None
        else None
    )
    order = np.lexsort((rows, cols))
    new_topo = ElementTopology(topo.in_dim, topo.out_dim, rows[order], cols[order])
    return EvolutionResult(
        new_topo, vals[order], mom[order] if mom is not None else None,
        int(drop.size), int(n_grow),
    )


def retain_valid_updates_element(
    update_vals: np.ndarray,
    old: ElementTopology,
    new: ElementTopology,
) -> np.ndarray:
    """Map an update aligned to ``old`` onto ``new``; vanished entries -> 0.

    Paper Algorithm 1 line 14: gradients computed on a stale topology are
    applied only where the connection still exists."""
    out = np.zeros(new.nnz, np.float32)
    old_flat = old.rows.astype(np.int64) * old.out_dim + old.cols
    new_flat = new.rows.astype(np.int64) * new.out_dim + new.cols
    order_new = np.argsort(new_flat)
    sorted_new = new_flat[order_new]
    pos = np.searchsorted(sorted_new, old_flat)
    pos = np.clip(pos, 0, sorted_new.size - 1)
    hit = sorted_new[pos] == old_flat
    out[order_new[pos[hit]]] = update_vals[hit]
    return out


def evolve_block(
    topo: BlockTopology,
    values: np.ndarray,
    zeta: float,
    rng: np.random.Generator,
    momentum: Optional[np.ndarray] = None,
    protect_coverage: bool = True,
) -> EvolutionResult:
    """Prune the zeta-tail of blocks by mean |w|, regrow vacant tiles (zero-init)."""
    meta = topo.meta
    values = np.asarray(values, np.float32)
    nb = topo.n_blocks
    scores = np.abs(values).mean(axis=(1, 2))
    k = int(zeta * nb)
    order = np.argsort(scores)
    drop: list = []
    if protect_coverage:
        col_counts = np.bincount(topo.cols, minlength=meta.grid_n)
        for i in order:
            if len(drop) >= k:
                break
            c = topo.cols[i]
            if col_counts[c] > 1:
                col_counts[c] -= 1
                drop.append(i)
    else:
        drop = list(order[:k])
    drop = np.asarray(drop, np.int64)
    keep = np.setdiff1d(np.arange(nb), drop)

    rows_k, cols_k = topo.rows[keep], topo.cols[keep]
    vals_k = values[keep]
    mom_k = momentum[keep] if momentum is not None else None

    n_grow = nb - keep.size
    flat_existing = rows_k.astype(np.int64) * meta.grid_n + cols_k
    new_flat = _sample_vacant(meta.total_blocks, flat_existing, n_grow, rng)
    new_rows = (new_flat // meta.grid_n).astype(np.int32)
    new_cols = (new_flat % meta.grid_n).astype(np.int32)
    new_vals = np.zeros((n_grow, meta.block_m, meta.block_n), np.float32)

    rows = np.concatenate([rows_k, new_rows])
    cols = np.concatenate([cols_k, new_cols])
    vals = np.concatenate([vals_k, new_vals], axis=0)
    mom = (
        np.concatenate(
            [mom_k, np.zeros((n_grow, meta.block_m, meta.block_n), np.float32)]
        )
        if mom_k is not None
        else None
    )
    order2 = np.lexsort((rows, cols))
    new_topo = BlockTopology(meta, rows[order2], cols[order2])
    return EvolutionResult(
        new_topo, vals[order2], mom[order2] if mom is not None else None,
        int(drop.size), int(n_grow),
    )


def retain_valid_updates_block(
    update_blocks: np.ndarray,
    old: BlockTopology,
    new: BlockTopology,
) -> np.ndarray:
    """Block-granularity RetainValidUpdates (vanished blocks are dropped)."""
    meta = new.meta
    out = np.zeros((new.n_blocks, meta.block_m, meta.block_n), np.float32)
    old_flat = old.rows.astype(np.int64) * meta.grid_n + old.cols
    new_flat = new.rows.astype(np.int64) * meta.grid_n + new.cols
    order_new = np.argsort(new_flat)
    sorted_new = new_flat[order_new]
    pos = np.searchsorted(sorted_new, old_flat)
    pos = np.clip(pos, 0, sorted_new.size - 1)
    hit = sorted_new[pos] == old_flat
    out[order_new[pos[hit]]] = update_blocks[hit]
    return out


# ---------------------------------------------------------------------------
# Device-resident evolution (DESIGN.md §3)
#
# Fixed-capacity formulation: SET keeps nnz (or n_blocks) constant, so the
# whole prune/regrow cycle runs on arrays of static shape. Dropped slots are
# overwritten in place (fresh position and value, momentum 0) and the result
# is re-sorted to the canonical (col, row) order. Only the number of drops
# depends on the data, and it lives in flag and rank arithmetic, never in a
# shape, so nothing reads the device from the host. Every sort is stable, as
# ``jnp.argsort`` is: ties keep their slot order.
# ---------------------------------------------------------------------------


def _check_flat(total: int) -> None:
    if total >= 2**31:
        raise ValueError(f"flat position encoding needs a grid of < 2**31 positions, got {total}")


def _init_draw(generator: torch.Generator, n: int, *, fan_in_dense: int,
               scheme: str) -> torch.Tensor:
    """``n`` f32 values of ``scheme`` (the families and scales of
    ``sparsity._init_numpy``) from ``generator``, on its device."""
    dev = generator.device
    if scheme == "normal":
        return torch.randn(n, generator=generator, device=dev) * 0.05
    if scheme in ("he_uniform", "xavier"):
        limit = float(np.sqrt((6.0 if scheme == "he_uniform" else 3.0) / max(1, fan_in_dense)))
        return torch.empty(n, device=dev).uniform_(-limit, limit, generator=generator)
    if scheme == "zeros":
        return torch.zeros(n, device=dev)
    raise ValueError(f"unknown init scheme {scheme!r}")


def evolution_draws(generator: torch.Generator, n: int, total: int, *, fan_in_dense: int,
                    scheme: Optional[str]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The random numbers one layer's device evolution takes, from
    ``generator`` on its device: ``2 n`` int32 candidate flat positions,
    uniform in [0, total), and, with a ``scheme``, ``n`` initial values of it
    for the regrown slots (None without: blocks regrow zeros). The
    reference draws the same kinds from ``jax.random``."""
    cand = torch.randint(0, total, (2 * n,), generator=generator, device=generator.device,
                         dtype=torch.int32)
    init = None if scheme is None else _init_draw(generator, n, fan_in_dense=fan_in_dense,
                                                  scheme=scheme)
    return cand, init


def _element_drop_flags(v: torch.Tensor, zeta: float) -> torch.Tensor:
    """The paper's criterion as flags: the zeta-tail of the smallest
    positive and of the largest negative weights, plus exact zeros. Both
    tails are the smallest |v| within their sign, so one stable sort of |v|
    ranks both. Each tail's size is floor(f32(zeta) * f32(count)), in f32 as
    the reference computes it (the host path's ``int(zeta * count)`` is f64
    and may differ by one)."""
    pos, neg = v > 0, v < 0
    z = float(np.float32(zeta))
    k_pos = torch.floor(pos.sum().to(torch.float32) * z).to(torch.int64)
    k_neg = torch.floor(neg.sum().to(torch.float32) * z).to(torch.int64)
    order = torch.sort(v.abs(), stable=True).indices

    def rank(flags: torch.Tensor) -> torch.Tensor:
        ranks = torch.cumsum(flags.index_select(0, order), 0) - 1
        return torch.empty_like(ranks).scatter_(0, order, ranks)

    return (v == 0) | (pos & (rank(pos) < k_pos)) | (neg & (rank(neg) < k_neg))


def _regrow_flat(cand: torch.Tensor, old_flat: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """One fresh vacant flat position per dropped slot, from ``cand`` (the
    ``2 n`` candidates). A candidate is valid if no old position (kept or
    dropped) holds it and it is the first of its value among the
    candidates; valid ones are dealt out, in order, to the dropped slots in
    slot order. A dropped slot past the valid supply keeps its old, now
    vacant, position (the dense layer's every slot: it has no vacancy)."""
    n, c = old_flat.shape[0], cand.shape[0]
    if n == 0:
        return old_flat
    sorted_old = torch.sort(old_flat).values
    idx = torch.searchsorted(sorted_old, cand).clamp(0, n - 1)
    occupied = sorted_old.index_select(0, idx) == cand
    sc, ordc = torch.sort(cand, stable=True)
    first_sorted = torch.ones(c, dtype=torch.bool, device=cand.device)
    first_sorted[1:] = sc[1:] != sc[:-1]
    valid = torch.empty_like(first_sorted).scatter_(0, ordc, first_sorted) & ~occupied
    n_valid = valid.sum()
    # a stable partition, valid first: cand[argsort(~valid)] without a sort
    pos = torch.where(valid, torch.cumsum(valid, 0) - 1, n_valid + torch.cumsum(~valid, 0) - 1)
    compact = torch.empty_like(cand).scatter_(0, pos, cand)
    drop_rank = torch.cumsum(drop, 0) - 1
    take = compact.index_select(0, drop_rank.clamp(0, c - 1))
    return torch.where(drop & (drop_rank < n_valid), take, old_flat)


def evolve_element_device(
    rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, momentum: torch.Tensor,
    cand: torch.Tensor, init_values: torch.Tensor, *, in_dim: int, out_dim: int, zeta: float,
):
    """SET on fixed-capacity COO arrays where they live, fed its draws
    (:func:`evolution_draws`: ``cand`` (2 nnz,) int32, ``init_values``
    (nnz,)). Returns ``(rows, cols, values, momentum, n_pruned)`` in the
    canonical (col, row) order, ``n_pruned`` a device scalar: the criterion
    of :func:`evolve_element`, regrown slots taking their position from
    ``cand`` and their value from ``init_values``, with momentum 0."""
    _check_flat(in_dim * out_dim)
    drop = _element_drop_flags(values, zeta)
    new_flat = _regrow_flat(cand, rows * out_dim + cols, drop)
    vals = torch.where(drop, init_values.to(values.dtype), values)
    mom = torch.where(drop, torch.zeros((), dtype=momentum.dtype, device=momentum.device),
                      momentum)
    new_rows, new_cols = new_flat // out_dim, new_flat % out_dim
    order = torch.sort(new_cols * in_dim + new_rows, stable=True).indices
    return (new_rows.index_select(0, order), new_cols.index_select(0, order),
            vals.index_select(0, order), mom.index_select(0, order), drop.sum())


def _regrow_flat_reference(cand: np.ndarray, old_flat: np.ndarray, drop: np.ndarray) -> np.ndarray:
    """numpy version of :func:`_regrow_flat`."""
    n, c = old_flat.size, cand.size
    sorted_old = np.sort(old_flat)
    idx = np.clip(np.searchsorted(sorted_old, cand), 0, n - 1)
    occupied = sorted_old[idx] == cand
    ordc = np.argsort(cand, kind="stable")
    sc = cand[ordc]
    first_sorted = np.ones(c, bool)
    first_sorted[1:] = sc[1:] != sc[:-1]
    uniq = np.zeros(c, bool)
    uniq[ordc] = first_sorted
    valid = uniq & ~occupied
    compact = cand[np.argsort(~valid, kind="stable")]
    drop_rank = np.cumsum(drop) - 1
    take = compact[np.clip(drop_rank, 0, c - 1)]
    return np.where(drop & (drop_rank < int(valid.sum())), take, old_flat)


def evolve_element_device_reference(
    rows: np.ndarray, cols: np.ndarray, values: np.ndarray, momentum: np.ndarray,
    cand: np.ndarray, init_values: np.ndarray, *, in_dim: int, out_dim: int, zeta: float,
):
    """numpy version of :func:`evolve_element_device`, fed the same draws:
    the reference's ``evolve_element_device_reference`` with the draws
    given instead of a jax key (two stable per-sign sorts, f32 tail
    sizes). The oracle the card's evolution is held to."""
    v = np.asarray(values, np.float32)
    nnz = v.shape[0]
    pos, neg = v > 0, v < 0
    k_pos = int(np.floor(np.float32(zeta) * np.float32(pos.sum())))
    k_neg = int(np.floor(np.float32(zeta) * np.float32(neg.sum())))

    def ranks(keys):
        r = np.zeros(nnz, np.int64)
        r[np.argsort(keys, kind="stable")] = np.arange(nnz)
        return r

    drop = ((v == 0) | (pos & (ranks(np.where(pos, v, np.inf)) < k_pos))
            | (neg & (ranks(np.where(neg, -v, np.inf)) < k_neg)))
    old_flat = (np.asarray(rows, np.int64) * out_dim + cols).astype(np.int32)
    new_flat = _regrow_flat_reference(np.asarray(cand, np.int32), old_flat, drop)
    vals = np.where(drop, np.asarray(init_values, np.float32), v)
    mom = np.where(drop, np.float32(0), np.asarray(momentum, np.float32))
    new_rows, new_cols = new_flat // out_dim, new_flat % out_dim
    order = np.argsort(new_cols.astype(np.int64) * in_dim + new_rows, kind="stable")
    return (new_rows[order].astype(np.int32), new_cols[order].astype(np.int32), vals[order],
            mom[order], int(drop.sum()))


def _block_drop_flags(scores: torch.Tensor, cols: torch.Tensor, k: int):
    """The blocks to drop, and how many: the reference's scan over the
    score-sorted order (a block drops while its column keeps another slot
    and fewer than ``k`` have dropped) as one vectorised rule. A block is
    droppable when its rank among its column's blocks, in score order, is
    below the column's count - 1; the first ``k`` droppable blocks in score
    order drop."""
    nb = scores.shape[0]
    order = torch.sort(scores, stable=True).indices
    by_col_cols, by_col = torch.sort(cols.index_select(0, order).long(), stable=True)
    start = torch.searchsorted(by_col_cols, by_col_cols)
    count = torch.searchsorted(by_col_cols, by_col_cols, right=True) - start
    rank = torch.arange(nb, device=scores.device) - start
    droppable = torch.empty(nb, dtype=torch.bool, device=scores.device).scatter_(
        0, by_col, rank < count - 1)
    drop_sorted = droppable & (torch.cumsum(droppable, 0) <= k)
    drop = torch.empty_like(drop_sorted).scatter_(0, order, drop_sorted)
    return drop, drop_sorted.sum()


def evolve_block_device(
    rows: torch.Tensor, cols: torch.Tensor, values: torch.Tensor, momentum: torch.Tensor,
    cand: torch.Tensor, *, meta: BlockMeta, zeta: float,
):
    """Block SET where the arrays live, fed its candidates (``cand``
    (2 n_blocks,) int32, :func:`evolution_draws`): the ``int(zeta *
    n_blocks)`` blocks of the lowest mean |w| drop, each only while its
    block-column keeps another slot (coverage, as :func:`evolve_block`);
    vacant tiles regrow zero-init with momentum 0. Returns ``(rows, cols,
    values, momentum, n_pruned)`` in the canonical (col, row) order."""
    _check_flat(meta.total_blocks)
    k = int(zeta * values.shape[0])
    drop, n_drop = _block_drop_flags(values.abs().mean(dim=(1, 2)), cols, k)
    new_flat = _regrow_flat(cand, rows * meta.grid_n + cols, drop)
    gone = drop[:, None, None]
    vals = torch.where(gone, torch.zeros((), dtype=values.dtype, device=values.device), values)
    mom = torch.where(gone, torch.zeros((), dtype=momentum.dtype, device=momentum.device),
                      momentum)
    new_rows, new_cols = new_flat // meta.grid_n, new_flat % meta.grid_n
    order = torch.sort(new_cols * meta.grid_m + new_rows, stable=True).indices
    return (new_rows.index_select(0, order), new_cols.index_select(0, order),
            vals.index_select(0, order), mom.index_select(0, order), n_drop)


def evolve_block_device_reference(
    rows: np.ndarray, cols: np.ndarray, values: np.ndarray, momentum: np.ndarray,
    cand: np.ndarray, *, meta: BlockMeta, zeta: float, scores: Optional[np.ndarray] = None,
):
    """numpy version of :func:`evolve_block_device`, fed the same
    candidates, with the reference's sequential scan over the score-sorted
    order. ``scores`` (the blocks' mean |w|) are computed here unless
    given: a mean of a tile's floats may differ in its last bits between
    two devices, so a comparison of the drop decision feeds both the same
    scores."""
    v = np.asarray(values, np.float32)
    nb = v.shape[0]
    k = int(zeta * nb)
    if scores is None:
        scores = np.abs(v).mean(axis=(1, 2))
    counts = np.bincount(cols, minlength=meta.grid_n)
    drop = np.zeros(nb, bool)
    n_drop = 0
    for i in np.argsort(scores, kind="stable"):
        if counts[cols[i]] > 1 and n_drop < k:
            counts[cols[i]] -= 1
            n_drop += 1
            drop[i] = True
    old_flat = (np.asarray(rows, np.int64) * meta.grid_n + cols).astype(np.int32)
    new_flat = _regrow_flat_reference(np.asarray(cand, np.int32), old_flat, drop)
    vals = np.where(drop[:, None, None], np.float32(0), v)
    mom = np.where(drop[:, None, None], np.float32(0), np.asarray(momentum, np.float32))
    new_rows, new_cols = new_flat // meta.grid_n, new_flat % meta.grid_n
    order = np.argsort(new_cols.astype(np.int64) * meta.grid_m + new_rows, kind="stable")
    return (new_rows[order].astype(np.int32), new_cols[order].astype(np.int32), vals[order],
            mom[order], n_drop)


def _first(keys: torch.Tensor) -> torch.Tensor:
    flags = torch.ones_like(keys)
    flags[1:] = (keys[1:] != keys[:-1]).to(keys.dtype)
    return flags


def _dual_order_views(rows: torch.Tensor, cols: torch.Tensor, n_cols: int):
    """Both granularities' device views from canonical (col, row)-sorted
    coordinates, where they live: the segment-boundary flags and the
    row-sorted mirror and its permutation (``n_cols``, the column key's
    cardinality, orders it). Fields in ``ElemTopoArrays``' and
    ``BlockTopoArrays``' order."""
    perm_r = torch.sort(rows.long() * n_cols + cols.long(), stable=True).indices
    rows_r, cols_r = rows.index_select(0, perm_r), cols.index_select(0, perm_r)
    return rows, cols, _first(cols), rows_r, cols_r, _first(rows_r), perm_r.to(torch.int32)


def element_device_arrays(rows: torch.Tensor, cols: torch.Tensor, *, in_dim: int, out_dim: int,
                          longest: Optional[Tuple[int, int]] = None) -> ElemTopoArrays:
    """Device-resident analogue of ``ElementTopology.device_arrays``: the
    dual-order views of canonical (col, row)-sorted int32 coordinates, and
    with them, on the device, what kernels A and F read of a topology
    (:func:`sparsity.register_device_plans`): no host round trip, no sync.
    The coordinates are trusted, not checked, so they must be canonical and
    in range, as :func:`evolve_element_device` returns them. ``longest`` is
    kernel A's (column, row) route hint; without it, the mean segment."""
    _check_flat(in_dim * out_dim)
    arrays = ElemTopoArrays(*_dual_order_views(rows, cols, out_dim))
    if longest is None:
        longest = route_hints(arrays, in_dim, out_dim)
    register_device_plans(arrays, in_dim, out_dim, longest)
    return arrays


def block_device_arrays(
    rows: torch.Tensor, cols: torch.Tensor, *, meta: BlockMeta
) -> BlockTopoArrays:
    """Device-resident analogue of ``BlockTopology.device_arrays``: the
    first-visit flags and the row-sorted permutation from canonical
    (col, row)-sorted int32 coordinates, computed where they live."""
    return BlockTopoArrays(*_dual_order_views(rows, cols, meta.grid_n))


def evolve_element_layers_device(
    topo_arrays: Sequence[ElemTopoArrays], values, velocity, generator: torch.Generator, *,
    layer_dims, zeta: float, init_scheme: str = "he_uniform", probe: bool = False,
):
    """Device-resident SET for a whole element-sparse MLP: every layer, in
    order, draws from the one ``generator`` (:func:`evolution_draws`), evolves
    (:func:`evolve_element_device`) and gets its new device arrays and plans
    (:func:`element_device_arrays`, kernel A's route hint carried from the
    layer's old arrays). Returns ``(topo_arrays, values, velocity,
    n_pruned)``, ``n_pruned`` the per-layer pruned counts as one device
    tensor; nothing syncs. ``probe`` (the reference's churn probe) comes
    with the probes slice."""
    if probe:
        raise NotImplementedError(
            "training-dynamics probes come with the probes slice (ROADMAP Queue 1, item 4)")
    new_topo, new_vals, new_vel, n_pruned = [], [], [], []
    for l, arrays in enumerate(topo_arrays):
        n_in, n_out = layer_dims[l], layer_dims[l + 1]
        cand, init = evolution_draws(generator, arrays.rows.shape[0], n_in * n_out,
                                     fan_in_dense=n_in, scheme=init_scheme)
        rows, cols, vals, mom, pruned = evolve_element_device(
            arrays.rows, arrays.cols, values[l], velocity[l], cand, init,
            in_dim=n_in, out_dim=n_out, zeta=zeta)
        new_topo.append(element_device_arrays(rows, cols, in_dim=n_in, out_dim=n_out,
                                              longest=route_hints(arrays, n_in, n_out)))
        new_vals.append(vals)
        new_vel.append(mom)
        n_pruned.append(pruned)
    return tuple(new_topo), tuple(new_vals), tuple(new_vel), torch.stack(n_pruned)


def evolve_block_layers_device(
    topo_arrays: Sequence[BlockTopoArrays], values, velocity, generator: torch.Generator, *,
    metas: Sequence[BlockMeta], zeta: float,
):
    """Device-resident SET for a whole block-sparse MLP, as
    :func:`evolve_element_layers_device`: per layer, the candidates from
    the one ``generator``, :func:`evolve_block_device`, and the new arrays
    (:func:`block_device_arrays`), registered as checked for kernels C, D
    and E (they are canonical and in the grid by construction). Returns
    ``(topo_arrays, values, velocity, n_pruned)``; nothing syncs."""
    new_topo, new_vals, new_vel, n_pruned = [], [], [], []
    for l, arrays in enumerate(topo_arrays):
        meta = metas[l]
        cand, _ = evolution_draws(generator, arrays.rows.shape[0], meta.total_blocks,
                                  fan_in_dense=meta.in_dim, scheme=None)
        rows, cols, vals, mom, pruned = evolve_block_device(
            arrays.rows, arrays.cols, values[l], velocity[l], cand, meta=meta, zeta=zeta)
        t = block_device_arrays(rows, cols, meta=meta)
        trust_block_arrays(t, meta.grid_m, meta.grid_n)
        new_topo.append(t)
        new_vals.append(vals)
        new_vel.append(mom)
        n_pruned.append(pruned)
    return tuple(new_topo), tuple(new_vals), tuple(new_vel), torch.stack(n_pruned)


def _sample_vacant(
    total: int, occupied_flat: np.ndarray, k: int, rng: np.random.Generator
) -> np.ndarray:
    """Sample k distinct flat positions not in ``occupied_flat``."""
    if k == 0:
        return np.empty(0, np.int64)
    occupied = np.sort(np.asarray(occupied_flat, np.int64))
    n_vacant = total - occupied.size
    if k > n_vacant:
        raise ValueError(f"cannot grow {k} into {n_vacant} vacant positions")
    if total <= 4 * (occupied.size + k):
        # dense regime: enumerate vacants
        mask = np.ones(total, bool)
        mask[occupied] = False
        vac = np.flatnonzero(mask)
        return rng.choice(vac, size=k, replace=False).astype(np.int64)
    # sparse regime: rejection sampling (expected < 2 rounds)
    picked: set = set()
    occ = set(occupied.tolist())
    while len(picked) < k:
        cand = rng.integers(0, total, size=2 * (k - len(picked)))
        for c in cand:
            ci = int(c)
            if ci not in occ and ci not in picked:
                picked.add(ci)
                if len(picked) == k:
                    break
    return np.fromiter(picked, np.int64, k)


# ---------------------------------------------------------------------------
# Connection shards (out-of-core substrate, DESIGN.md §7)
#
# A layer's canonical (col, row)-sorted COO arrays are partitioned into
# fixed-capacity contiguous slices. Because the canonical order sorts by the
# segment key (col), every slice is itself a valid sorted-segment-reduction
# operand: the streamed forward visits shards in canonical order and the
# accumulated result is the same segment sum the in-core path computes. The
# row-sorted dual order is sliced the same way (through perm_r) for the
# streamed dX pass. Host-side helpers only: the device never sees more than
# one padded shard (plus its double-buffered successor) at a time.
# ---------------------------------------------------------------------------


def element_shard_bounds(nnz: int, capacity: int) -> list:
    """Half-open [lo, hi) slices partitioning ``nnz`` canonical slots into
    contiguous shards of at most ``capacity`` (only the last is ragged)."""
    if nnz <= 0:
        raise ValueError(f"nnz must be positive, got {nnz}")
    if capacity <= 0:
        raise ValueError(f"shard capacity must be positive, got {capacity}")
    return [(lo, min(lo + capacity, nnz)) for lo in range(0, nnz, capacity)]


def element_shard_key_intervals(
    rows: np.ndarray, cols: np.ndarray, in_dim: int, out_dim: int, capacity: int
) -> np.ndarray:
    """Canonical-key ownership intervals per shard, shape (n_shards + 1,).

    The canonical sort key of a connection is ``col * in_dim + row``. Shard s
    owns the half-open key interval ``[edges[s], edges[s+1])``: it starts at
    the shard's own first key (shard 0 starts at 0) and the last shard ends
    at ``out_dim * in_dim``. Intervals tile the whole flat position space, so
    shard-local regrowth that samples vacancies inside its own interval can
    check occupancy against the shard's own keys alone and still preserve
    global uniqueness AND cross-shard canonical ordering (xl/evolve.py).
    """
    keys = cols.astype(np.int64) * in_dim + rows.astype(np.int64)
    bounds = element_shard_bounds(keys.shape[0], capacity)
    edges = np.empty(len(bounds) + 1, np.int64)
    edges[0] = 0
    for s, (lo, _) in enumerate(bounds[1:], start=1):
        edges[s] = keys[lo]
    edges[-1] = np.int64(out_dim) * np.int64(in_dim)
    return edges


def element_row_order(rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Permutation mapping row-order slot i -> canonical slot (int64: XL
    layers may exceed int32 nnz). The host mirror of the ``perm_r`` field
    in ``ElemTopoArrays``; XL keeps it as a (possibly memmapped) host leaf
    and slices it per shard for the streamed dX pass."""
    return np.lexsort((cols, rows)).astype(np.int64)


def pad_shard(arr: np.ndarray, capacity: int, fill) -> np.ndarray:
    """Pad a ragged final shard slice up to the static capacity with
    ``fill`` (segment sentinel for segment ids, 0 for gather ids/values)."""
    n = arr.shape[0]
    if n == capacity:
        return arr
    if n > capacity:
        raise ValueError(f"slice of {n} exceeds capacity {capacity}")
    out = np.full((capacity,), fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def check_element_shards(
    rows: np.ndarray,
    cols: np.ndarray,
    perm_r: np.ndarray,
    in_dim: int,
    out_dim: int,
    capacity: int,
) -> None:
    """Invariant checker for a sharded layer (tests + evolution self-check):

    * global canonical (col, row) order and unique flat positions;
    * every capacity-slice is therefore itself segment-sorted (cols
      non-decreasing within each shard);
    * ``perm_r`` is a true permutation whose image is (row, col)-sorted:
      every capacity-slice of the row order is a valid dX shard.
    """
    nnz = rows.shape[0]
    assert cols.shape[0] == nnz and perm_r.shape[0] == nnz
    assert (rows >= 0).all() and (rows < in_dim).all()
    assert (cols >= 0).all() and (cols < out_dim).all()
    keys = cols.astype(np.int64) * in_dim + rows.astype(np.int64)
    assert (np.diff(keys) > 0).all(), "canonical (col,row) order violated"
    sorted_perm = np.sort(np.asarray(perm_r, np.int64))
    assert (sorted_perm == np.arange(nnz)).all(), "perm_r is not a permutation"
    rkeys = (
        rows[perm_r].astype(np.int64) * out_dim + cols[perm_r].astype(np.int64)
    )
    assert (np.diff(rkeys) > 0).all(), "row-sorted dual order violated"
    # per-shard segment sortedness is implied by the global order; spot-check
    # the slicing arithmetic anyway so capacity bugs fail loudly here
    for lo, hi in element_shard_bounds(nnz, capacity):
        assert (np.diff(cols[lo:hi].astype(np.int64)) >= 0).all()
