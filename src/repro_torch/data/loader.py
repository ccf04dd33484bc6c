"""Sharded, deterministic host data loader (numpy only), copied from
``repro.data.loader`` so the port gives the same epoch order for the same
seed.

Each data-parallel group reads only its shard (``shard_id``/``num_shards``);
epochs reshuffle with a per-epoch PRNG derived from (seed, epoch), so a
restart reproduces the exact stream. Batches are yielded as numpy; the
trainer's fused epoch ships only ``epoch_order`` to the device and gathers
the batches there.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

__all__ = ["ShardedLoader"]


@dataclasses.dataclass
class ShardedLoader:
    x: np.ndarray
    y: np.ndarray
    batch_size: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    drop_remainder: bool = True

    def __post_init__(self):
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(f"shard_id {self.shard_id} not in [0, {self.num_shards})")
        n = self.x.shape[0]
        idx = np.arange(n)
        self._shard_idx = idx[self.shard_id :: self.num_shards]

    @property
    def steps_per_epoch(self) -> int:
        n = self._shard_idx.size
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's shuffled sample indices (remainder already dropped if
        configured). This is the whole host-side contribution to an epoch —
        the fused trainer ships it to the device and gathers batches there."""
        rng = np.random.default_rng((self.seed * 1_000_003 + epoch) & 0x7FFFFFFF)
        order = rng.permutation(self._shard_idx)
        n_full = (
            order.size // self.batch_size * self.batch_size
            if self.drop_remainder
            else order.size
        )
        return order[:n_full]

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.epoch_order(epoch)
        for s in range(0, order.size, self.batch_size):
            sel = order[s : s + self.batch_size]
            yield self.x[sel], self.y[sel]
