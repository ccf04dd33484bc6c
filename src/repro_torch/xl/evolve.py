"""Shard-wise SET evolution for the out-of-core substrate (DESIGN.md §7).

Twin of ``repro.xl.evolve``: numpy only, on the port's copies of the shard
helpers and of ``_init_numpy``, so the same values and rng state give the
same thresholds, topology and values as the reference's.

The paper's prune criterion is *global* per layer — the zeta-tail of the
smallest positive and largest negative weights — but the whole-layer
``evolve_element`` materializes and argsorts the full ``(nnz,)`` value
array, which is exactly what an out-of-core layer cannot afford. Here the
global thresholds come from a **streamed two-pass quantile sketch**:

  1. *count pass* — stream shards, count positives/negatives/zeros and the
     nonzero-|v| range;
  2. *histogram pass* — stream shards again, per-sign |v| histograms over
     that range; invert the CDF to the bin holding the k-th smallest;
  3. *boundary resolution* — stream only the boundary bin's values (about
     nnz/bins of them, the sole data-dependent allocation) and select the
     exact k-th order statistic inside it, with deterministic canonical-
     stream-order tie handling.

The resulting threshold is the *exact* per-sign quantile — the sketch
"tolerance" collapses to tie-ordering — so the shard-wise pass prunes
exactly ``int(zeta * n_pos) + int(zeta * n_neg) + n_zero`` connections, the
same count as the whole-layer oracle.

Regrowth is drawn **per shard**: shard s owns the canonical-key interval
``[edges[s], edges[s+1])`` (``core.topology.element_shard_key_intervals``),
so sampling vacancies inside its own interval needs only the shard's own
keys for the occupancy check, preserves global uniqueness and cross-shard
canonical order, and keeps every shard at constant capacity (regrow count
== local prune count). The distributional difference vs whole-layer uniform
regrowth: new connections land proportionally to where pruning happened
rather than uniformly over all vacancies — the low-magnitude tail is close
to uniform over shards in practice (asserted distributionally in tests).

After the values move, the row-sorted dual order is rebuilt by an external
k-way merge of the shards' locally row-sorted runs (spilled to disk-backed
scratch in the memmapped regime, block-buffered readers) — no whole-layer
argsort, O(shards * block) merge memory.
"""
from __future__ import annotations

import dataclasses
import heapq
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.sparsity import _init_numpy
from repro_torch.core.topology import (
    element_shard_bounds,
    element_shard_key_intervals,
)

__all__ = [
    "SignThreshold",
    "streamed_sign_thresholds",
    "evolve_layer_streamed",
    "evolve_model_streamed",
]


@dataclasses.dataclass(frozen=True)
class SignThreshold:
    """Exact prune rule for one sign class: prune every |v| in a bin below
    ``boundary_bin``; inside it, every |v| below ``cutoff`` plus the first
    ``ties`` entries equal to it (canonical stream order)."""

    k: int               # target prune count (int(zeta * n_sign))
    boundary_bin: int
    cutoff: float        # exact k-th smallest |v| of this sign
    ties: int            # cutoff-equal entries to prune, in stream order


def _bin_of(absv: np.ndarray, lo: float, width: float, bins: int) -> np.ndarray:
    idx = np.floor((absv - lo) / width).astype(np.int64)
    return np.clip(idx, 0, bins - 1)


def streamed_sign_thresholds(
    values, capacity: int, zeta: float, *, bins: int = 8192
) -> Tuple[Optional[SignThreshold], Optional[SignThreshold], dict]:
    """Two-pass (plus boundary-bin) streamed quantile sketch over a host
    value leaf. Returns (pos, neg) thresholds (None when that sign prunes
    nothing) and the pass statistics."""
    nnz = values.shape[0]
    bounds = element_shard_bounds(nnz, capacity)

    # pass 1: sign counts + nonzero |v| range
    n_pos = n_neg = n_zero = 0
    lo, hi = np.inf, -np.inf
    for a, b in bounds:
        v = np.asarray(values[a:b], np.float32)
        n_pos += int((v > 0).sum())
        n_neg += int((v < 0).sum())
        n_zero += int((v == 0).sum())
        nz = np.abs(v[v != 0])
        if nz.size:
            lo = min(lo, float(nz.min()))
            hi = max(hi, float(nz.max()))
    stats = {"n_pos": n_pos, "n_neg": n_neg, "n_zero": n_zero}
    k_pos = int(zeta * n_pos)  # same float64 arithmetic as evolve_element
    k_neg = int(zeta * n_neg)
    if k_pos == 0 and k_neg == 0:
        return None, None, stats
    width = max((hi - lo) / bins, np.finfo(np.float32).tiny)

    # pass 2: per-sign histograms
    hist = {s: np.zeros(bins, np.int64) for s in (+1, -1)}
    for a, b in bounds:
        v = np.asarray(values[a:b], np.float32)
        for s in (+1, -1):
            sel = v > 0 if s > 0 else v < 0
            if sel.any():
                idx = _bin_of(np.abs(v[sel]), lo, width, bins)
                np.add.at(hist[s], idx, 1)

    # pass 3: exact selection inside the boundary bin
    def resolve(sign: int, k: int) -> Optional[SignThreshold]:
        if k <= 0:
            return None
        cum = np.cumsum(hist[sign])
        b_idx = int(np.searchsorted(cum, k))
        below = int(cum[b_idx - 1]) if b_idx > 0 else 0
        need = k - below
        bucket: List[np.ndarray] = []
        for a, b in bounds:
            v = np.asarray(values[a:b], np.float32)
            sel = v > 0 if sign > 0 else v < 0
            av = np.abs(v[sel])
            inb = av[_bin_of(av, lo, width, bins) == b_idx]
            if inb.size:
                bucket.append(inb)
        boundary = (
            np.sort(np.concatenate(bucket)) if bucket
            else np.empty(0, np.float32)
        )
        assert boundary.size >= need, (boundary.size, need)
        cutoff = float(boundary[need - 1])
        ties = need - int((boundary < cutoff).sum())
        return SignThreshold(k=k, boundary_bin=b_idx, cutoff=cutoff, ties=ties)

    stats.update(lo=lo, hi=hi, width=width, bins=bins)
    return resolve(+1, k_pos), resolve(-1, k_neg), stats


def _prune_mask(
    v: np.ndarray,
    thr: Optional[SignThreshold],
    sign: int,
    lo: float,
    width: float,
    bins: int,
    ties_left: List[int],
) -> np.ndarray:
    """This shard's prune flags for one sign class; ``ties_left`` is the
    mutable cross-shard tie budget (canonical stream order)."""
    if thr is None:
        return np.zeros(v.shape, bool)
    sel = v > 0 if sign > 0 else v < 0
    av = np.abs(v).astype(np.float32)
    b = _bin_of(av, lo, width, bins)
    mask = sel & (b < thr.boundary_bin)
    in_b = sel & (b == thr.boundary_bin)
    mask |= in_b & (av < thr.cutoff)
    if ties_left[0] > 0:
        tie = in_b & (av == thr.cutoff)
        tie_idx = np.flatnonzero(tie)[: ties_left[0]]
        ties_left[0] -= tie_idx.size
        m2 = np.zeros(v.shape, bool)
        m2[tie_idx] = True
        mask |= m2
    return mask


def evolve_layer_streamed(
    st,
    zeta: float,
    rng: np.random.Generator,
    *,
    capacity: int,
    init_scheme: str = "he_uniform",
    bins: int = 8192,
) -> dict:
    """One layer's shard-wise prune/regrow cycle on an ``XLLayerState``.

    Streams the layer three+1 times (sketch passes + the mutation pass);
    every allocation is O(capacity) except the boundary-bin collection
    (~nnz/bins). Returns the evolution stats (prune counts, thresholds).
    """
    nnz = st.nnz
    bounds = element_shard_bounds(nnz, capacity)
    thr_pos, thr_neg, stats = streamed_sign_thresholds(
        st.values, capacity, zeta, bins=bins
    )
    edges = element_shard_key_intervals(
        st.rows, st.cols, st.in_dim, st.out_dim, capacity
    )
    ties_pos, ties_neg = (
        [thr_pos.ties if thr_pos else 0],
        [thr_neg.ties if thr_neg else 0],
    )
    lo_v = stats.get("lo", 0.0)
    width = stats.get("width", 1.0)
    n_pruned = n_fallback = 0
    for s, (a, b) in enumerate(bounds):
        v = np.asarray(st.values[a:b], np.float32)
        rows = np.asarray(st.rows[a:b])
        cols = np.asarray(st.cols[a:b])
        vel = np.asarray(st.velocity[a:b], np.float32)
        drop = (v == 0)
        drop |= _prune_mask(v, thr_pos, +1, lo_v, width, bins, ties_pos)
        drop |= _prune_mask(v, thr_neg, -1, lo_v, width, bins, ties_neg)
        k_s = int(drop.sum())
        n_pruned += k_s
        if k_s == 0:
            continue
        keys = cols.astype(np.int64) * st.in_dim + rows.astype(np.int64)
        kept_keys = np.sort(keys[~drop])
        interval = (int(edges[s]), int(edges[s + 1]))
        new_keys, fallback = _sample_interval_vacancies(
            rng, interval, kept_keys, k_s, keys[drop]
        )
        n_fallback += fallback
        new_vals = _init_numpy(
            rng, (k_s,), fan_in_dense=st.in_dim, scheme=init_scheme
        )
        # rebuild the shard: survivors + regrown, re-sorted by canonical key
        out_keys = np.concatenate([keys[~drop], new_keys])
        out_vals = np.concatenate([v[~drop], new_vals])
        out_vel = np.concatenate([vel[~drop], np.zeros(k_s, np.float32)])
        order = np.argsort(out_keys, kind="stable")
        out_keys = out_keys[order]
        st.cols[a:b] = (out_keys // st.in_dim).astype(np.int32)
        st.rows[a:b] = (out_keys % st.in_dim).astype(np.int32)
        st.values[a:b] = out_vals[order]
        st.velocity[a:b] = out_vel[order]
    _rebuild_row_order_streamed(st, capacity)
    stats.update(
        n_pruned=n_pruned,
        n_grown=n_pruned,
        n_fallback=n_fallback,
        cutoff_pos=thr_pos.cutoff if thr_pos else None,
        cutoff_neg=thr_neg.cutoff if thr_neg else None,
    )
    return stats


def _sample_interval_vacancies(
    rng: np.random.Generator,
    interval: Tuple[int, int],
    kept_keys: np.ndarray,
    k: int,
    dropped_keys: np.ndarray,
) -> Tuple[np.ndarray, int]:
    """``k`` distinct canonical keys inside ``interval`` avoiding
    ``kept_keys``. When the interval is too saturated to yield enough fresh
    vacancies (bounded rejection rounds), the remainder reuses the dropped
    slots' own keys — position kept, value re-initialized — the same
    vanishing-probability fallback the device regrowth uses."""
    lo, hi = interval
    vacant = (hi - lo) - kept_keys.size
    picked: set = set()
    rounds = 0
    while len(picked) < min(k, vacant) and rounds < 16:
        cand = rng.integers(lo, hi, size=2 * (k - len(picked)))
        pos = np.searchsorted(kept_keys, cand)
        pos = np.clip(pos, 0, max(0, kept_keys.size - 1))
        occ = (
            kept_keys[pos] == cand if kept_keys.size else
            np.zeros(cand.shape, bool)
        )
        for c in cand[~occ]:
            ci = int(c)
            if ci not in picked:
                picked.add(ci)
                if len(picked) == k:
                    break
        rounds += 1
    new = np.fromiter(picked, np.int64, len(picked))
    n_fallback = k - new.size
    if n_fallback:
        reuse = np.setdiff1d(dropped_keys, new)[:n_fallback]
        assert reuse.size == n_fallback
        new = np.concatenate([new, reuse.astype(np.int64)])
    return new, n_fallback


def _scratch_like(ref: np.ndarray, n: int, name: str) -> np.ndarray:
    """int64 scratch of length ``n``: spilled to a sibling memmap when the
    layer's leaves are themselves memmapped (the out-of-core regime — the
    scratch must not claim O(nnz) RSS either), plain memory otherwise."""
    if isinstance(ref, np.memmap) and getattr(ref, "filename", None):
        path = Path(ref.filename).with_suffix(f".{name}.tmp")
        return np.memmap(path, dtype=np.int64, mode="w+", shape=(n,))
    return np.empty(n, np.int64)


def _release_scratch(arr: np.ndarray) -> None:
    if isinstance(arr, np.memmap) and getattr(arr, "filename", None):
        path = Path(arr.filename)
        del arr
        path.unlink(missing_ok=True)


def _rebuild_row_order_streamed(
    st, capacity: int, block: int = 8192, write_chunk: int = 65536
):
    """Rebuild ``perm_r`` as an external k-way merge of the shards' locally
    row-sorted runs. Two phases, both with bounded working set:

    1. each shard's connections are sorted by (row, col) and the sorted
       (key, canonical-index) run is spilled to scratch — one O(capacity)
       sort at a time, scratch on disk whenever the layer's own leaves are
       memmapped;
    2. ``heapq.merge`` over *block-buffered* readers of those runs — every
       live reader holds one ``block``-sized window, so the merge's host
       memory is O(shards * block), never O(nnz) — writing the merged
       permutation to the leaf in fixed-size chunks.
    """
    bounds = element_shard_bounds(st.nnz, capacity)
    run_keys = _scratch_like(st.perm_r, st.nnz, "rkeys")
    run_idx = _scratch_like(st.perm_r, st.nnz, "ridx")
    for a, b in bounds:
        rows = np.asarray(st.rows[a:b], np.int64)
        cols = np.asarray(st.cols[a:b], np.int64)
        keys = rows * st.out_dim + cols
        order = np.argsort(keys, kind="stable")
        run_keys[a:b] = keys[order]
        run_idx[a:b] = order + a

    def reader(a, b):
        for lo in range(a, b, block):
            hi = min(lo + block, b)
            k = np.asarray(run_keys[lo:hi]).tolist()
            i = np.asarray(run_idx[lo:hi]).tolist()
            yield from zip(k, i)

    pos = 0
    buf = np.empty(write_chunk, np.int64)
    fill = 0
    for _, canonical in heapq.merge(*(reader(a, b) for a, b in bounds)):
        buf[fill] = canonical
        fill += 1
        if fill == write_chunk:
            st.perm_r[pos : pos + fill] = buf
            pos += fill
            fill = 0
    if fill:
        st.perm_r[pos : pos + fill] = buf[:fill]
    _release_scratch(run_keys)
    _release_scratch(run_idx)


def evolve_model_streamed(
    state, zeta: float, rng: np.random.Generator, *, bins: int = 8192
) -> List[dict]:
    """Shard-wise evolution over every layer of an ``XLModelState``; bumps
    ``topo_version`` so the executor drops its device-cached index shards."""
    out = []
    for st in state.layers:
        out.append(
            evolve_layer_streamed(
                st, zeta, rng,
                capacity=state.plan.shard_capacity,
                init_scheme=state.init, bins=bins,
            )
        )
    state.topo_version += 1
    return out
