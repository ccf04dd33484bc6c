"""Neuron importance (paper Eq. 4) and Importance Pruning (Algorithm 2),
element and block granularity. Host numpy, as in the reference.

Importance of neuron j in layer l is its graph *strength*:

    I_j = sum_{i in Gamma_j} |w_ij|

i.e. the L1 norm of the incoming-weight column.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core.sparsity import BlockTopology, ElementTopology

__all__ = [
    "element_degrees",
    "neuron_importance_element",
    "neuron_importance_block",
    "importance_prune_element",
    "importance_prune_block",
    "ImportancePruneResult",
    "PruningSchedule",
]


class ImportancePruneResult(NamedTuple):
    topology: object
    values: np.ndarray
    momentum: Optional[np.ndarray]
    pruned_neurons: np.ndarray  # neuron (column) ids that were pruned
    removed_params: int


@dataclasses.dataclass(frozen=True)
class PruningSchedule:
    """Algorithm 2 schedule: prune every ``period`` epochs once epoch >= tau."""

    tau: int = 200
    period: int = 10
    threshold: Optional[float] = None
    percentile: Optional[float] = None  # e.g. 5.0 for the 5th percentile
    enabled: bool = True

    def should_prune(self, epoch: int) -> bool:
        return self.enabled and epoch >= self.tau and epoch % self.period == 0

    def resolve_threshold(self, importance: np.ndarray) -> float:
        if self.threshold is not None:
            return float(self.threshold)
        if self.percentile is not None:
            return float(np.percentile(importance, self.percentile))
        raise ValueError("PruningSchedule needs threshold or percentile")


def element_degrees(topo: ElementTopology) -> Tuple[np.ndarray, np.ndarray]:
    """(out_degree per input row, in_degree per output column).

    A hidden neuron with in-degree 0 computes ``act(bias)`` (a constant) and
    one with out-degree 0 feeds nothing downstream — both are what
    deployment-time compaction (serve/compact.py) physically eliminates."""
    row_deg = np.bincount(topo.rows, minlength=topo.in_dim)
    col_deg = np.bincount(topo.cols, minlength=topo.out_dim)
    return row_deg, col_deg


def neuron_importance_element(
    topo: ElementTopology, values: np.ndarray
) -> np.ndarray:
    """I_j per output neuron (length out_dim)."""
    imp = np.zeros(topo.out_dim, np.float64)
    np.add.at(imp, topo.cols, np.abs(np.asarray(values, np.float64)))
    return imp.astype(np.float32)


def importance_prune_element(
    topo: ElementTopology,
    values: np.ndarray,
    schedule: PruningSchedule,
    momentum: Optional[np.ndarray] = None,
    protected: Optional[np.ndarray] = None,
) -> ImportancePruneResult:
    """Remove all incoming weights of neurons with importance below threshold.

    ``protected`` marks columns that must never be pruned (e.g. output units).
    """
    values = np.asarray(values, np.float32)
    imp = neuron_importance_element(topo, values)
    # only columns with at least one incoming connection are prunable —
    # zero-degree neurons have nothing to remove and must not be reported
    # in pruned_neurons (they would over-count the prune)
    live = np.zeros(topo.out_dim, bool)
    live[topo.cols] = True
    t = schedule.resolve_threshold(imp[live])
    prune_mask = (imp < t) & live
    if protected is not None:
        prune_mask[protected] = False
    # never prune ALL live neurons
    if prune_mask[live].all() and live.any():
        keep_one = int(np.flatnonzero(live)[np.argmax(imp[live])])
        prune_mask[keep_one] = False
    pruned = np.flatnonzero(prune_mask)
    keep = ~np.isin(topo.cols, pruned)
    removed = int(topo.nnz - keep.sum())
    new_topo = ElementTopology(
        topo.in_dim, topo.out_dim, topo.rows[keep], topo.cols[keep]
    )
    return ImportancePruneResult(
        new_topo,
        values[keep],
        momentum[keep] if momentum is not None else None,
        pruned,
        removed,
    )


# ---------------------------------------------------------------------------
# block granularity
# ---------------------------------------------------------------------------


def neuron_importance_block(topo: BlockTopology, values: np.ndarray) -> np.ndarray:
    """Per-neuron strength from block storage (length padded_out)."""
    meta = topo.meta
    col_strength = np.abs(np.asarray(values, np.float64)).sum(axis=1)  # (nb, bn)
    imp = np.zeros((meta.grid_n, meta.block_n), np.float64)
    np.add.at(imp, topo.cols, col_strength)
    return imp.reshape(-1).astype(np.float32)


def importance_prune_block(
    topo: BlockTopology,
    values: np.ndarray,
    schedule: PruningSchedule,
    momentum: Optional[np.ndarray] = None,
    protected: Optional[np.ndarray] = None,
) -> ImportancePruneResult:
    """Zero pruned neurons' columns; free blocks that become empty.

    Freed capacity is dropped from the arrays (the truly-sparse claim: memory
    shrinks), except that each block-column keeps >= 1 slot (the coverage
    invariant, so every output tile has a slot that writes it).
    """
    meta = topo.meta
    values = np.asarray(values, np.float32).copy()
    imp = neuron_importance_block(topo, values)
    live = imp > 0
    t = schedule.resolve_threshold(imp[live]) if live.any() else 0.0
    prune_mask = imp < t
    if protected is not None:
        prune_mask[protected[: prune_mask.size]] = False
    prune_mask[meta.out_dim:] = False  # padding cols are not neurons
    if prune_mask.all():
        prune_mask[int(np.argmax(imp))] = False
    pruned = np.flatnonzero(prune_mask)

    nnz_before = int(np.count_nonzero(values))
    pm = prune_mask.reshape(meta.grid_n, meta.block_n)
    values[:, :, :] = np.where(pm[topo.cols][:, None, :], 0.0, values)
    if momentum is not None:
        momentum = np.asarray(momentum, np.float32).copy()
        momentum[:, :, :] = np.where(pm[topo.cols][:, None, :], 0.0, momentum)
    removed = nnz_before - int(np.count_nonzero(values))

    # free all-zero blocks (keep one slot per column for coverage)
    empty = np.abs(values).sum(axis=(1, 2)) == 0
    col_counts = np.bincount(topo.cols, minlength=meta.grid_n)
    keep = np.ones(topo.n_blocks, bool)
    for i in np.flatnonzero(empty):
        c = topo.cols[i]
        if col_counts[c] > 1:
            keep[i] = False
            col_counts[c] -= 1
    new_topo = BlockTopology(meta, topo.rows[keep], topo.cols[keep])
    return ImportancePruneResult(
        new_topo,
        values[keep],
        momentum[keep] if momentum is not None else None,
        pruned,
        removed,
    )
