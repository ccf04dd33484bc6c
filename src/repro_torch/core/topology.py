"""SET topology evolution (Mocanu et al. 2018), on the host. Twin of the
host half of ``repro.core.topology``: numpy copies of the reference's
algorithm and draws, so the same rng gives the same topology.

Paper Algorithm 2, weight pruning-regrowing cycle:

* element granularity (paper-faithful): remove the zeta-tail of the
  smallest positive and of the largest negative weights (and exact zeros),
  regrow as many at random vacant positions, drawn by the init scheme;
* block granularity: the prune criterion is the block's mean |w|; regrowth
  samples vacant tiles uniformly, and new blocks are zero-init so they
  change nothing until gradients flow into them.

``RetainValidUpdates`` (Algorithm 1, line 14) filters updates computed
against a stale topology down to the connections or tiles that still exist.

:func:`block_device_arrays` builds the kernels' dual-order views from
canonical coordinates where they live, without a host round trip. The
device-resident evolution (``evolve_element_device``,
``evolve_block_device``) comes with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.sparsity import (
    BlockMeta,
    BlockTopoArrays,
    BlockTopology,
    ElementTopology,
    _init_numpy,
)

__all__ = [
    "EvolutionResult",
    "block_device_arrays",
    "evolve_block",
    "evolve_element",
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


def block_device_arrays(
    rows: torch.Tensor, cols: torch.Tensor, *, meta: BlockMeta
) -> BlockTopoArrays:
    """Device-resident analogue of ``BlockTopology.device_arrays``: the
    first-visit flags and the row-sorted permutation from canonical
    (col, row)-sorted int32 coordinates, computed where they live."""
    key = rows.long() * meta.grid_n + cols.long()
    perm_r = torch.argsort(key, stable=True).to(torch.int32)
    rows_r = rows[perm_r.long()]
    cols_r = cols[perm_r.long()]

    def first(keys: torch.Tensor) -> torch.Tensor:
        flags = torch.ones_like(keys)
        flags[1:] = (keys[1:] != keys[:-1]).to(keys.dtype)
        return flags

    return BlockTopoArrays(rows, cols, first(cols), rows_r, cols_r, first(rows_r), perm_r)


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
