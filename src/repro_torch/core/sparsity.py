"""Truly sparse weight representations, at two granularities.

PyTorch twin of ``repro.core.sparsity``. Topology lives in host numpy with
the same lexsort and the same Erdős–Rényi draws as the reference, so a seed
gives the same connections (and the same initial values) bit for bit:

* ``ElementTopology`` — COO connections, the paper-faithful path;
  ``ElemTopoArrays`` holds its dual-order views as int32 tensors on the
  device, and the segment offsets of both orders and kernel F's run plan
  are made with them, once: on the host from the topology
  (``ElementTopology.device_arrays``), or on the device from arrays that
  device SET evolution made (:func:`register_device_plans`).
  The product primitive :func:`coo_matmul_T` is kernel A
  (``csrc/coo_matmul_T.cu``), with an optional bias (+ All-ReLU) epilogue
  in its store, for CUDA tensors and its plain PyTorch version for CPU
  tensors; it serves the forward and, over the row-sorted dual order, dX.
  The per-slot weight gradient :func:`coo_dw` is kernel F
  (``csrc/coo_dw.cu``), a warp a run of one column's slots, with the
  backward of A's epilogue (kernel G's work: dz and the bias's gradient)
  in the same pass.
* ``BlockTopology`` — live (block_m, block_n) tiles stored as a compact
  ``(n_blocks, bm, bn)`` stack plus int32 block coordinates;
  ``BlockTopoArrays`` holds the same dual-order views. Its products are
  kernels C, D and E (``kernels/block_sparse_matmul.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import takes_plain
from repro_torch.kernels import build

__all__ = [
    "BlockMeta",
    "BlockTopoArrays",
    "BlockTopology",
    "ElemTopoArrays",
    "ElementTopology",
    "COO_LONG_SEGMENT",
    "DW_RUN",
    "DwRuns",
    "coo_dw",
    "coo_dw_epilogue",
    "coo_dw_plain",
    "coo_epilogue",
    "coo_matmul_T",
    "coo_matmul_T_plain",
    "coo_route",
    "density_from_epsilon",
    "dw_plan",
    "dw_runs",
    "dw_runs_capacity",
    "dw_runs_device",
    "element_spmm",
    "element_spmm_segment",
    "erdos_renyi_nnz",
    "offsets_to_device",
    "register_device_plans",
    "registered_offsets",
    "route_hints",
    "segment_offsets",
    "spmm_chunk_for",
]


def density_from_epsilon(epsilon: float, n_in: int, n_out: int) -> float:
    """SET's Erdős–Rényi density: p = eps * (n_in + n_out) / (n_in * n_out)."""
    return min(1.0, float(epsilon) * (n_in + n_out) / (n_in * n_out))


def erdos_renyi_nnz(epsilon: float, n_in: int, n_out: int) -> int:
    return max(1, int(round(density_from_epsilon(epsilon, n_in, n_out) * n_in * n_out)))


def _first_flags(keys: np.ndarray) -> np.ndarray:
    first = np.ones_like(keys, dtype=np.int32)
    if keys.size > 1:
        first[1:] = (keys[1:] != keys[:-1]).astype(np.int32)
    return first


# ---------------------------------------------------------------------------
# Block sparsity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    """Static metadata of a block-sparse matrix."""

    in_dim: int
    out_dim: int
    block_m: int = 128
    block_n: int = 128

    @property
    def grid_m(self) -> int:
        return -(-self.in_dim // self.block_m)

    @property
    def grid_n(self) -> int:
        return -(-self.out_dim // self.block_n)

    @property
    def padded_in(self) -> int:
        return self.grid_m * self.block_m

    @property
    def padded_out(self) -> int:
        return self.grid_n * self.block_n

    @property
    def total_blocks(self) -> int:
        return self.grid_m * self.grid_n


class BlockTopoArrays(NamedTuple):
    """Device-side block topology. All int32 tensors, shape (n_blocks,).

    Canonical order is sorted by (col, row), so each output block-column's
    slots are one contiguous range (kernels C and E). The ``*_r`` fields are
    the same tiles sorted by (row, col) for kernel D; ``perm_r[i]`` maps
    row-ordered slot i back to the canonical slot owning its values.
    ``first_col``/``first_row`` are 1 where the sort key changes; the
    kernels walk offsets instead and do not read them.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    first_col: torch.Tensor
    rows_r: torch.Tensor
    cols_r: torch.Tensor
    first_row: torch.Tensor
    perm_r: torch.Tensor


class BlockTopology:
    """Host-side (numpy) block topology with SET bookkeeping.

    Invariants, checked at construction (the kernels index through these
    coordinates unchecked):
      * slots sorted by (col, row); positions unique and inside the grid;
      * every block-column in [0, grid_n) is covered by >= 1 slot, so every
        output neuron has a tile that writes it.
    """

    def __init__(self, meta: BlockMeta, rows: np.ndarray, cols: np.ndarray):
        self.meta = meta
        order = np.lexsort((rows, cols))
        self.rows = np.asarray(rows, np.int32)[order]
        self.cols = np.asarray(cols, np.int32)[order]
        self._check()

    @classmethod
    def erdos_renyi(
        cls, meta: BlockMeta, density: float, rng: np.random.Generator
    ) -> "BlockTopology":
        """Sample an ER block topology with ~density fraction of live blocks."""
        total = meta.total_blocks
        n_blocks = int(np.clip(round(density * total), meta.grid_n, total))
        flat = rng.choice(total, size=n_blocks, replace=False).astype(np.int64)
        rows = (flat // meta.grid_n).astype(np.int32)
        cols = (flat % meta.grid_n).astype(np.int32)
        rows, cols = _ensure_coverage(meta, rows, cols, rng)
        return cls(meta, rows, cols)

    @classmethod
    def from_epsilon(
        cls, meta: BlockMeta, epsilon: float, rng: np.random.Generator
    ) -> "BlockTopology":
        return cls.erdos_renyi(
            meta, density_from_epsilon(epsilon, meta.in_dim, meta.out_dim), rng
        )

    @property
    def n_blocks(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        return self.n_blocks / self.meta.total_blocks

    @property
    def n_params(self) -> int:
        return self.n_blocks * self.meta.block_m * self.meta.block_n

    def _check(self) -> None:
        m = self.meta
        if self.rows.shape != self.cols.shape:
            raise ValueError("rows and cols differ in shape")
        if self.rows.size and not (
            0 <= self.rows.min() and self.rows.max() < m.grid_m
            and 0 <= self.cols.min() and self.cols.max() < m.grid_n
        ):
            raise ValueError(
                f"block coordinates out of range for a {m.grid_m}x{m.grid_n} grid"
            )
        flat = self.rows.astype(np.int64) * m.grid_n + self.cols
        if np.unique(flat).size != flat.size:
            raise ValueError("duplicate block positions")
        if np.unique(self.cols).size != m.grid_n:
            raise ValueError(
                "coverage invariant violated: some output block-column has no slot"
            )

    def device_arrays(self, device: torch.device) -> BlockTopoArrays:
        rows, cols = self.rows, self.cols
        perm_r = np.lexsort((cols, rows)).astype(np.int32)
        rows_r = rows[perm_r]
        cols_r = cols[perm_r]
        return BlockTopoArrays(*(
            torch.as_tensor(a, device=device)
            for a in (rows, cols, _first_flags(cols), rows_r, cols_r,
                      _first_flags(rows_r), perm_r)
        ))

    def init_values(
        self, rng: np.random.Generator, *, dtype: torch.dtype = torch.float32,
        scheme: str = "he_uniform", device: torch.device,
    ) -> torch.Tensor:
        """(n_blocks, bm, bn) values, the reference's draw. As there, the
        part of a tile that lies in a padded grid's margin is drawn too: the
        padded inputs are zeros and the padded outputs are sliced away, so
        it never reaches the product."""
        m = self.meta
        shape = (self.n_blocks, m.block_m, m.block_n)
        vals = _init_numpy(rng, shape, fan_in_dense=m.in_dim, scheme=scheme)
        return torch.as_tensor(vals, device=device).to(dtype)

    def to_dense(self, values: torch.Tensor) -> torch.Tensor:
        """Scatter block values into the dense (in_dim, out_dim) matrix."""
        m = self.meta
        dense = torch.zeros(
            (m.grid_m, m.block_m, m.grid_n, m.block_n),
            dtype=values.dtype, device=values.device,
        )
        rows = torch.as_tensor(self.rows, device=values.device).long()
        cols = torch.as_tensor(self.cols, device=values.device).long()
        dense[rows, :, cols, :] = values
        dense = dense.reshape(m.padded_in, m.padded_out)
        return dense[: m.in_dim, : m.out_dim]


def _ensure_coverage(
    meta: BlockMeta, rows: np.ndarray, cols: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Swap surplus slots into uncovered block-columns (keeps slot count).
    The reference's algorithm and draws, so a seed gives the same tiles."""
    covered = np.zeros(meta.grid_n, bool)
    covered[cols] = True
    missing = np.flatnonzero(~covered)
    if missing.size == 0:
        return rows, cols
    # donate slots from columns having > 1 block
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=meta.grid_n)
    donors = [i for i in order if counts[cols[i]] > 1]
    if len(donors) < missing.size:
        raise ValueError(
            f"cannot cover {missing.size} empty block-columns with "
            f"{len(donors)} donor slots; raise density"
        )
    di = 0
    rows = rows.copy()
    cols = cols.copy()
    for c in missing:
        while True:
            slot = donors[di]
            di += 1
            if counts[cols[slot]] > 1:
                counts[cols[slot]] -= 1
                break
        cols[slot] = c
        rows[slot] = rng.integers(meta.grid_m)
    # dedupe (rare): if the random row collides within the column, redraw it
    flat = rows.astype(np.int64) * meta.grid_n + cols
    while np.unique(flat).size != flat.size:
        uniq, _, cnt = np.unique(flat, return_index=True, return_counts=True)
        for f, c0 in zip(uniq, cnt):
            if c0 > 1:
                for d in np.flatnonzero(flat == f)[1:]:
                    rows[d] = rng.integers(meta.grid_m)
        flat = rows.astype(np.int64) * meta.grid_n + cols
    return rows, cols


# ---------------------------------------------------------------------------
# Element sparsity (paper-faithful COO)
# ---------------------------------------------------------------------------


class ElemTopoArrays(NamedTuple):
    """Device-side dual-order COO topology. All int32 tensors, shape (nnz,).

    Canonical order is sorted by (col, row), so ``cols`` is non-decreasing
    and the forward product is a sorted segment reduction. The ``*_r``
    fields are the same connections sorted by (row, col) for the dX pass of
    the training slice; ``perm_r[j]`` maps row-ordered slot j back to the
    canonical slot owning its value. ``first_col``/``first_row`` are 1 where
    the sort key changes.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    first_col: torch.Tensor
    rows_r: torch.Tensor
    cols_r: torch.Tensor
    first_row: torch.Tensor
    perm_r: torch.Tensor


class ElementTopology:
    """Host-side COO topology for the paper's SET-MLP path.

    rows/cols are int32 (nnz,) with unique positions, sorted by (col, row).
    """

    def __init__(self, in_dim: int, out_dim: int, rows: np.ndarray, cols: np.ndarray):
        # imported here: obs imports the modules that import this one
        from repro_torch import obs

        self.in_dim = int(in_dim)
        self.out_dim = int(out_dim)
        # host work that set-up pays for at full width: traced as one span
        # with the sort's and the uniqueness check's seconds
        with obs.span("topology.build", nnz=int(np.shape(rows)[0])) as sp:
            t0 = time.perf_counter()
            order = np.lexsort((rows, cols))
            self.rows = np.asarray(rows, np.int32)[order]
            self.cols = np.asarray(cols, np.int32)[order]
            t1 = time.perf_counter()
            # kernel A gathers and writes through these indices unchecked
            if self.rows.size and not (
                0 <= self.rows.min() and self.rows.max() < self.in_dim
                and 0 <= self.cols.min() and self.cols.max() < self.out_dim
            ):
                raise ValueError(
                    f"connections out of range for a {self.in_dim}x{self.out_dim} layer"
                )
            flat = self.rows.astype(np.int64) * out_dim + self.cols
            if np.unique(flat).size != flat.size:
                raise ValueError("duplicate connections")
            sp.set(sort_s=t1 - t0, unique_s=time.perf_counter() - t1)

    @classmethod
    def erdos_renyi(
        cls, in_dim: int, out_dim: int, epsilon: float, rng: np.random.Generator
    ) -> "ElementTopology":
        nnz = erdos_renyi_nnz(epsilon, in_dim, out_dim)
        nnz = min(nnz, in_dim * out_dim)
        flat = rng.choice(in_dim * out_dim, size=nnz, replace=False).astype(np.int64)
        return cls(in_dim, out_dim, (flat // out_dim), (flat % out_dim))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def density(self) -> float:
        return self.nnz / (self.in_dim * self.out_dim)

    def device_arrays(self, device: torch.device) -> ElemTopoArrays:
        """The dual-order views on ``device``. The segment offsets of both
        orders (:meth:`col_ptr`, :meth:`row_ptr`) are made with them from the
        host's arrays and registered to ``cols`` and ``rows_r``, so that
        kernel A finds them, and its route, with no device sync; so is
        kernel F's run plan (:func:`dw_runs`), to ``cols``. The indices were
        range-checked at construction, so kernels A and F gather through
        them unchecked."""
        rows, cols = self.rows, self.cols
        perm_r = np.lexsort((cols, rows)).astype(np.int32)
        rows_r = rows[perm_r]
        cols_r = cols[perm_r]
        arrays = ElemTopoArrays(*(
            torch.as_tensor(a, device=device)
            for a in (rows, cols, _first_flags(cols), rows_r, cols_r,
                      _first_flags(rows_r), perm_r)
        ))
        col_ptr = self.col_ptr()
        _register_offsets(arrays.cols, offsets_to_device(col_ptr, device))
        _register_offsets(arrays.rows_r, offsets_to_device(self.row_ptr(), device))
        _remember(_DW_RUNS, arrays.cols, _runs_to_device(rows, col_ptr, device))
        _trust_indices(arrays.rows, self.in_dim)  # kernel F's gather
        return arrays

    def col_ptr(self) -> np.ndarray:
        """int64 (out_dim + 1,) offsets of each column's slot range in the
        canonical order: kernel A's ``seg_ptr`` for the forward product."""
        return np.searchsorted(self.cols, np.arange(self.out_dim + 1)).astype(np.int64)

    def row_ptr(self) -> np.ndarray:
        """int64 (in_dim + 1,) offsets of each row's slot range in the
        row-sorted dual order (``rows_r``): kernel A's ``seg_ptr`` for dX."""
        return np.searchsorted(np.sort(self.rows), np.arange(self.in_dim + 1)).astype(np.int64)

    def init_values(
        self, rng: np.random.Generator, *, dtype: torch.dtype = torch.float32,
        scheme: str = "he_uniform", device: torch.device,
    ) -> torch.Tensor:
        vals = _init_numpy(rng, (self.nnz,), fan_in_dense=self.in_dim, scheme=scheme)
        return torch.as_tensor(vals, device=device).to(dtype)

    def to_dense(self, values: torch.Tensor) -> torch.Tensor:
        """Scatter ``values`` (nnz,) into the dense (in_dim, out_dim) matrix
        on their device."""
        dense = torch.zeros((self.in_dim, self.out_dim), dtype=values.dtype,
                            device=values.device)
        rows = torch.as_tensor(self.rows, device=values.device).long()
        cols = torch.as_tensor(self.cols, device=values.device).long()
        dense[rows, cols] = values
        return dense


def element_spmm(
    x: torch.Tensor, values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    out_dim: int,
) -> torch.Tensor:
    """Truly sparse y = x @ W for COO W by gather and scatter-add.

    Materializes the (batch, nnz) contribution array; the CPU plain path
    takes it for small problems (``SPMM_INFER_*``)."""
    contrib = x[..., rows.long()] * values
    y = torch.zeros(x.shape[:-1] + (out_dim,), dtype=contrib.dtype, device=x.device)
    return y.index_add_(-1, cols.long(), contrib)


# Batch-aware chunk policy of the plain version: target a fixed
# (batch * chunk) temp-element budget so the peak intermediate is the same
# number of bytes whatever the batch. Kernel A needs no chunks.
SPMM_TEMP_BUDGET_ELEMS = 2 * 1024 * 1024
SPMM_CHUNK_MIN = 512

# The reference's dispatch thresholds, calibrated on XLA:CPU, kept as
# configuration of the CPU plain path only: on the card kernel A serves
# every size.
SPMM_AUTO_NNZ = 2048
SPMM_AUTO_ELEMS = 512 * 1024
SPMM_INFER_NNZ = 65536
SPMM_INFER_ELEMS = 4 * 1024 * 1024


def spmm_chunk_for(batch: int, nnz: int, chunk: Optional[int] = None) -> int:
    """Chunk width for the chunked plain passes.

    ``chunk=None`` picks the batch-aware width targeting
    ``SPMM_TEMP_BUDGET_ELEMS`` temp elements; an explicit ``chunk`` is only
    clamped to [1, nnz].
    """
    if chunk is None:
        chunk = max(SPMM_CHUNK_MIN, SPMM_TEMP_BUDGET_ELEMS // max(1, int(batch)))
    return max(1, min(int(chunk), max(1, int(nnz))))


def element_spmm_segment(
    x: torch.Tensor, values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    out_dim: int, *, chunk: Optional[int] = None,
    col_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Col-sorted segment-sum SpMM over :func:`coo_matmul_T`, in the
    reference's layout: one transpose of the operand on the way in, one of
    the result on the way out. Requires the canonical (col, row) order.

    ``col_ptr`` (int64 (out_dim + 1,)) are the column offsets kernel A walks;
    they are computed on the device when not given.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    yT = coo_matmul_T(
        x2.T.contiguous(), values, rows, cols, out_dim, chunk=chunk, seg_ptr=col_ptr
    )
    return yT.T.contiguous().reshape(*lead, out_dim)


def segment_offsets(segment_idx: torch.Tensor, n_segments: int) -> torch.Tensor:
    """int64 (n_segments + 1,) offsets of each segment's slot range in a
    non-decreasing ``segment_idx``, computed where the indices live."""
    bounds = torch.arange(n_segments + 1, dtype=segment_idx.dtype,
                          device=segment_idx.device)
    return torch.searchsorted(segment_idx, bounds)


# Kernel A's routes (csrc/coo_matmul_T.cu): one thread per (segment, batch
# column), or one staged block per (segment, 32 batch columns) for a layer
# with a segment of at least COO_LONG_SEGMENT slots. Both run the same f32
# chain in slot order and give the same bits; the route is chosen from host
# ints only and changes nothing but the time.
COO_THREAD, COO_STAGED = 0, 1
COO_LONG_SEGMENT = 512


def coo_route(longest: int) -> int:
    """Kernel A's route for a layer whose longest segment has ``longest``
    slots: the staged route where one thread's walk would be long (the
    served output layer: 2,800 slots), else one thread per output."""
    return COO_STAGED if longest >= COO_LONG_SEGMENT else COO_THREAD


# The longest segment and the end of offsets made on the host, by tensor
# identity (offsets_to_device): kernel A's route needs the first, its bounds
# check the second, and reading either from the device would cost a sync
# per call.
_LONGEST: Dict[int, Tuple[weakref.ref, int, int]] = {}


def offsets_to_device(seg_ptr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Kernel A's ``seg_ptr`` (int64 (n_segments + 1,)) on ``device`` from
    the host's offsets (``ElementTopology.col_ptr()``/``row_ptr()``),
    checked on the host (from 0, never decreasing) and remembered with its
    longest segment, so that :func:`coo_matmul_T` picks its route from a
    host int and checks it with no device sync. Frozen topology: the tensor
    must not change after."""
    seg_ptr = np.array(seg_ptr, np.int64)  # a copy: the tensor must not follow the caller's array
    if seg_ptr.size == 0 or seg_ptr[0] != 0 or (np.diff(seg_ptr) < 0).any():
        raise ValueError("seg_ptr must start at 0 and never decrease")
    t = torch.from_numpy(seg_ptr).to(device)
    longest = int(np.diff(seg_ptr).max()) if seg_ptr.size > 1 else 0
    _note_offsets(t, longest, int(seg_ptr[-1]))
    return t


def forget_on_death(table: Dict, key) -> Callable[[weakref.ref], None]:
    """The weakref callback that removes ``table[key]`` when the tensor it
    was made for dies, but only if the entry still holds this weakref: an
    entry made since for another tensor under the same id (a dead tensor's
    id is reused) stays. The registries below are filled from several
    threads (the async parameter server's workers make device arrays)."""

    def callback(ref: weakref.ref) -> None:
        hit = table.get(key)
        if hit is ref or (isinstance(hit, tuple) and any(x is ref for x in hit)):
            del table[key]

    return callback


def _note_offsets(seg_ptr: torch.Tensor, longest: int, end: int) -> None:
    """Remember, for as long as ``seg_ptr`` lives, the host ints kernel A
    needs of it: the longest segment (its route) and the end (its check)."""
    key = id(seg_ptr)
    _LONGEST[key] = (weakref.ref(seg_ptr, forget_on_death(_LONGEST, key)), longest, end)


def _longest_segment(seg_ptr: Optional[torch.Tensor], nnz: int, n_segments: int) -> int:
    """The longest segment of ``seg_ptr`` where it came from
    :func:`offsets_to_device` (the route hint where it came from
    :func:`register_device_plans`), else the mean (both host ints)."""
    hit = _LONGEST.get(id(seg_ptr)) if seg_ptr is not None else None
    if hit is not None and hit[0]() is seg_ptr:
        return hit[1]
    return -(-nnz // max(1, n_segments))


# Segment offsets by the identity of the sorted index tensor they describe
# (``ElementTopology.device_arrays``: ``cols`` -> column offsets, ``rows_r``
# -> row offsets), so that every product over a topology's arrays finds
# them with no argument and no device work. An entry lives as long as its
# index tensor.
_SEG_PTRS: Dict[int, Tuple[weakref.ref, torch.Tensor]] = {}


def _remember(table: Dict, t: torch.Tensor, value) -> None:
    """Keep ``value`` in ``table`` under ``t``'s identity for as long as
    ``t`` lives."""
    key = id(t)
    table[key] = (weakref.ref(t, forget_on_death(table, key)), value)


def _recall(table: Dict, t: torch.Tensor):
    """What :func:`_remember` kept in ``table`` for ``t``, or None."""
    hit = table.get(id(t))
    return hit[1] if hit is not None and hit[0]() is t else None


def _register_offsets(segment_idx: torch.Tensor, seg_ptr: torch.Tensor) -> None:
    _remember(_SEG_PTRS, segment_idx, seg_ptr)


def registered_offsets(segment_idx: torch.Tensor) -> Optional[torch.Tensor]:
    """The offsets made for ``segment_idx`` by the ``device_arrays`` that
    made it, or None."""
    return _recall(_SEG_PTRS, segment_idx)


# Index tensors known to lie in [0, bound), by identity: made by
# ``device_arrays`` from a range-checked topology, or checked once (one
# device sync) on first use by kernel F.
_TRUSTED_INDICES: Dict[int, Tuple[weakref.ref, int]] = {}


def _trust_indices(idx: torch.Tensor, bound: int) -> None:
    _remember(_TRUSTED_INDICES, idx, bound)


def _check_indices(idx: torch.Tensor, bound: int, name: str) -> None:
    """Raise unless every index lies in [0, bound). Frozen topology: a
    tensor is checked the first time it is given, then remembered."""
    trusted = _recall(_TRUSTED_INDICES, idx)
    if trusted is not None and trusted <= bound:
        return
    if idx.numel() and not bool((idx.min() >= 0) & (idx.max() < bound)):
        raise ValueError(f"{name} has indices outside [0, {bound})")
    _trust_indices(idx, bound)


def coo_matmul_T(
    srcT: torch.Tensor,
    values: torch.Tensor,
    gather_idx: torch.Tensor,
    segment_idx: torch.Tensor,
    n_segments: int,
    *,
    chunk: Optional[int] = None,
    acc: Optional[torch.Tensor] = None,
    seg_ptr: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    slope: Optional[float] = None,
    with_mask: bool = False,
):
    """``accT[segment_idx[j], :] += srcT[gather_idx[j], :] * values[j]``,
    then the optional epilogue (:func:`coo_epilogue`).

    ``srcT`` is (src_dim, B); returns (n_segments, B). ``segment_idx`` must
    be non-decreasing. ``acc`` (optional, (n_segments, B)) is a carry-in
    accumulator. ``bias`` ((n_segments,), one per output feature) is added
    after the whole sum, and with ``slope`` All-ReLU follows (kernel B's
    arithmetic); ``slope`` needs ``bias``. A CUDA tensor launches kernel A,
    which sums each segment left to right in slot order (``chunk`` does not
    apply) and applies the epilogue in its store. Kernel A walks
    ``seg_ptr``, the segment offsets; when they are not given it takes those
    registered to ``segment_idx`` (:meth:`ElementTopology.device_arrays`),
    else computes them from ``segment_idx`` after checking that it is
    sorted (one device sync). Its route (:func:`coo_route`) follows the
    longest segment where the offsets came from :func:`offsets_to_device`,
    else the mean. A CPU, meta or fake tensor takes the plain version.

    ``with_mask`` (training; needs ``bias`` and ``slope``) also returns the
    uint8 (n_segments, B) mask of ``v > 0``, ``v`` the pre-activation: the
    branch All-ReLU took, which its backward (:func:`repro_torch.kernels.
    all_relu_fused.all_relu_bwd`) needs and the output alone does not give
    (a slope of -alpha turns a negative ``v`` into a positive output).
    """
    if takes_plain(srcT):
        return coo_matmul_T_plain(
            srcT, values, gather_idx, segment_idx, n_segments, chunk=chunk, acc=acc,
            bias=bias, slope=slope, with_mask=with_mask,
        )
    if srcT.device.type != "cuda":
        raise ValueError(f"coo_matmul_T runs on cuda or cpu tensors, not {srcT.device}")
    return _coo_matmul_T_cuda(srcT, values, gather_idx, segment_idx, seg_ptr, n_segments, acc,
                              bias=bias, slope=slope, with_mask=with_mask)


coo_matmul_T.launches = 0  # kernel A launches, so a run can show it went through the kernel
coo_matmul_T.epilogue_launches = 0  # of which with the bias (+ All-ReLU) epilogue
coo_matmul_T.mask_launches = 0  # of which with the training epilogue (+ the mask)
coo_matmul_T.staged_launches = 0  # of which on the staged route (COO_STAGED)

_COO_MATMUL_T_ARGTYPES = [ctypes.c_void_p] * 8 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _check_epilogue_args(bias: Optional[torch.Tensor], slope: Optional[float],
                         n_segments: int, with_mask: bool = False) -> None:
    if slope is not None and bias is None:
        raise ValueError("the All-ReLU epilogue (slope) needs a bias")
    if with_mask and slope is None:
        raise ValueError("the mask is All-ReLU's branch: with_mask needs bias and slope")
    if bias is not None and tuple(bias.shape) != (n_segments,):
        raise ValueError(
            f"bias has shape {tuple(bias.shape)}, expected ({n_segments},): one per segment")


def coo_epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
                 slope: Optional[float]) -> torch.Tensor:
    """Plain version of kernel A's epilogue on an (n_segments, B) product:
    ``v = out + bias[:, None]``, then, with ``slope``, All-ReLU's
    ``where(v > 0, v, slope * v)`` (kernel B's arithmetic, in this layout)."""
    if bias is None:
        return out
    v = out + bias[:, None]
    return v if slope is None else torch.where(v > 0, v, slope * v)


# Offsets already checked, by tensor identity. The engine freezes one
# offsets tensor per layer, so each costs one device sync, on first use.
_CHECKED_SEG_PTRS: Dict[int, weakref.ref] = {}


def _check_seg_ptr(seg_ptr: torch.Tensor, nnz: int) -> None:
    """Raise unless ``seg_ptr`` runs from 0 to ``nnz`` without decreasing,
    so that kernel A reads only slots [0, nnz). A tensor is checked the
    first time it is given; it is frozen topology and must not change."""
    key = id(seg_ptr)
    seen = _CHECKED_SEG_PTRS.get(key)
    if seen is not None and seen() is seg_ptr:
        return
    made = _LONGEST.get(key)
    # checked on the host when it was made, or made on the device from
    # sorted indices, which gives offsets from 0 to their count
    if made is not None and made[0]() is seg_ptr:
        if made[2] != nnz:
            raise ValueError(f"seg_ptr must run from 0 to nnz={nnz} without decreasing")
        return
    ok = (seg_ptr[0] == 0) & (seg_ptr[-1] == nnz) & (seg_ptr.diff() >= 0).all()
    if not bool(ok):
        raise ValueError(f"seg_ptr must run from 0 to nnz={nnz} without decreasing")
    _CHECKED_SEG_PTRS[key] = weakref.ref(seg_ptr, forget_on_death(_CHECKED_SEG_PTRS, key))


def _checked_offsets(segment_idx: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``segment_offsets`` after checking that ``segment_idx`` is sorted
    and lies in [0, n_segments); one device sync."""
    if segment_idx.numel():
        ok = ((segment_idx.diff() >= 0).all() & (segment_idx[0] >= 0)
              & (segment_idx[-1] < n_segments))
        if not bool(ok):
            raise ValueError(
                f"segment_idx must be non-decreasing and in [0, {n_segments})"
            )
    return segment_offsets(segment_idx, n_segments)


def _coo_matmul_T_cuda(
    srcT: torch.Tensor, values: torch.Tensor, gather_idx: torch.Tensor,
    segment_idx: torch.Tensor, seg_ptr: Optional[torch.Tensor], n_segments: int,
    acc: Optional[torch.Tensor], route: Optional[int] = None, *,
    bias: Optional[torch.Tensor] = None, slope: Optional[float] = None,
    with_mask: bool = False,
):
    """Validate, allocate and launch kernel A on the caller's stream, by
    ``route`` (default: :func:`coo_route` of the longest segment), with the
    epilogue that ``bias``, ``slope`` and ``with_mask`` ask for."""
    device = srcT.device
    if srcT.dim() != 2:
        raise ValueError(f"srcT must be (src_dim, B), got shape {tuple(srcT.shape)}")
    batch = srcT.shape[1]
    nnz = values.shape[0]
    f32 = torch.float32
    build.check_tensor(srcT, "srcT", dtype=f32, shape=srcT.shape, device=device)
    build.check_tensor(values, "values", dtype=f32, shape=(nnz,), device=device)
    build.check_tensor(gather_idx, "gather_idx", dtype=torch.int32, shape=(nnz,),
                       device=device)
    build.check_tensor(segment_idx, "segment_idx", dtype=torch.int32, shape=(nnz,),
                       device=device)
    if seg_ptr is None:
        seg_ptr = registered_offsets(segment_idx)
    if seg_ptr is None:
        seg_ptr = _checked_offsets(segment_idx, n_segments)
    else:
        build.check_tensor(seg_ptr, "seg_ptr", dtype=torch.int64,
                           shape=(n_segments + 1,), device=device)
        _check_seg_ptr(seg_ptr, nnz)
    if acc is not None:
        build.check_tensor(acc, "acc", dtype=f32, shape=(n_segments, batch),
                           device=device)
    _check_epilogue_args(bias, slope, n_segments, with_mask)
    if bias is not None:
        build.check_tensor(bias, "bias", dtype=f32, shape=(n_segments,), device=device)
    if route is None:
        route = coo_route(_longest_segment(seg_ptr, nnz, n_segments))
    out = torch.empty((n_segments, batch), dtype=f32, device=device)
    mask = torch.empty((n_segments, batch), dtype=torch.uint8, device=device) if with_mask else None
    launch_coo_matmul_T(srcT, values, gather_idx, seg_ptr, acc, out, route, bias=bias,
                        slope=slope, mask=mask)
    return (out, mask) if with_mask else out


def launch_coo_matmul_T(
    srcT: torch.Tensor, values: torch.Tensor, gather_idx: torch.Tensor,
    seg_ptr: torch.Tensor, acc: Optional[torch.Tensor], out: torch.Tensor, route: int, *,
    bias: Optional[torch.Tensor] = None, slope: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> None:
    """Launch kernel A on the caller's stream into ``out`` ((n_segments, B),
    f32, contiguous; it may be ``acc`` itself: each output is read and
    written by one thread), over the first ``n_segments`` segments of
    ``seg_ptr``, with the epilogue ``bias``, ``slope`` and ``mask`` ask for,
    and count it. Nothing is checked here: the callers check the operands
    (:func:`coo_matmul_T`), or made them so (the out-of-core stream's shard
    windows, ``kernels.ops.xl_shard_acc``)."""
    n_segments, batch = out.shape
    # kernel A's epilogue: 0 none, 1 + bias, 2 + bias then All-ReLU, 3 as 2
    # and the mask of the pre-activation's sign
    mode = 0 if bias is None else 1 if slope is None else 3 if mask is not None else 2
    if out.numel() == 0:
        return
    fn = build.kernel("coo_matmul_T", "coo_matmul_T_f32", _COO_MATMUL_T_ARGTYPES)
    rc = fn(
        srcT.data_ptr(), values.data_ptr(), gather_idx.data_ptr(),
        seg_ptr.data_ptr(), None if acc is None else acc.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if mask is None else mask.data_ptr(), n_segments, batch, route,
        0.0 if slope is None else slope, mode, *build.stream_args(out.device),
    )
    build.check_launch(rc, "coo_matmul_T kernel")
    coo_matmul_T.launches += 1
    if route == COO_STAGED:
        coo_matmul_T.staged_launches += 1
    if mode:
        coo_matmul_T.epilogue_launches += 1
    if mask is not None:
        coo_matmul_T.mask_launches += 1


def coo_matmul_T_plain(
    srcT: torch.Tensor,
    values: torch.Tensor,
    gather_idx: torch.Tensor,
    segment_idx: torch.Tensor,
    n_segments: int,
    *,
    chunk: Optional[int] = None,
    acc: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    slope: Optional[float] = None,
    with_mask: bool = False,
):
    """Plain PyTorch version of kernel A: chunked gather, scale and
    ``index_add_``, peak temp O(B * chunk), then :func:`coo_epilogue` (and,
    ``with_mask``, the mask of ``out + bias > 0``). Runs on any device; on
    the CPU ``index_add_`` adds in slot order, so the sum order is kernel
    A's."""
    _check_epilogue_args(bias, slope, n_segments, with_mask)
    nnz = int(values.shape[0])
    batch = srcT.shape[-1]
    dtype = torch.promote_types(srcT.dtype, values.dtype)
    if acc is None:
        out = torch.zeros((n_segments, batch), dtype=dtype, device=srcT.device)
    else:
        out = acc.to(dtype, copy=True)
    chunk = spmm_chunk_for(batch, nnz, chunk)
    for lo in range(0, nnz, chunk):
        g = gather_idx[lo:lo + chunk].long()
        v = values[lo:lo + chunk].to(dtype)
        out.index_add_(0, segment_idx[lo:lo + chunk].long(), srcT[g].to(dtype) * v[:, None])
    if with_mask:
        return coo_epilogue(out, bias, slope), (out + bias[:, None] > 0).to(torch.uint8)
    return coo_epilogue(out, bias, slope)


# Kernel F's work unit (csrc/coo_dw.cu): a run of at most DW_RUN consecutive
# slots of one column in the canonical order, one warp a run and one lane a
# slot. Every column also has one empty run, its epilogue's: its dz row and
# dbias, written whether or not the column has a slot.
DW_RUN = 32


class DwRuns(NamedTuple):
    """Kernel F's run plan on the device: ``runs`` int32 (n_runs, 3), run r
    covering the ``runs[r, 2]`` slots from ``runs[r, 1]`` of column
    ``runs[r, 0]``; then one empty run per column of ``n_cols``, in column
    order. ``n_slot_runs`` is the slot runs' capacity, the rows before the
    empty runs: a plan made on the host (:func:`dw_runs`) fills it
    exactly; one made on the device (:func:`dw_runs_device`) has a fixed
    capacity, its slot runs first and then padding runs of column -1,
    which kernel F skips."""

    runs: torch.Tensor
    n_slot_runs: int
    n_cols: int


def dw_runs(rows: np.ndarray, col_ptr: np.ndarray, run: int = DW_RUN) -> Tuple[np.ndarray, int]:
    """Kernel F's run plan from a canonical order's host arrays: ``rows``
    and the column offsets ``col_ptr`` (int64 (n_cols + 1,),
    :meth:`ElementTopology.col_ptr`). Each column's slot range is cut from
    its start into runs of at most ``run`` slots; the runs are ordered by
    their first slot's row (then column), so that warps that run together
    walk the same rows of x (each column's rows ascend) and find them in
    L1 or L2; then one empty run per column, in column order. Returns
    ``(runs, n_slot_runs)``, runs int32 (n_runs, 3) of (column, first
    slot, slots)."""
    col_ptr = np.asarray(col_ptr, np.int64)
    counts = np.diff(col_ptr)
    per_col = -(-counts // run)
    col = np.repeat(np.arange(counts.size), per_col)
    within = np.arange(col.size) - np.repeat(np.cumsum(per_col) - per_col, per_col)
    lo = col_ptr[col] + within * run
    n = np.minimum(run, col_ptr[col + 1] - lo)
    order = np.lexsort((col, np.asarray(rows)[lo]))
    empty = np.stack([np.arange(counts.size), col_ptr[:-1], np.zeros_like(counts)], 1)
    runs = np.concatenate([np.stack([col, lo, n], 1)[order], empty])
    return runs.astype(np.int32), int(col.size)


def _runs_to_device(rows: np.ndarray, col_ptr: np.ndarray, device: torch.device) -> DwRuns:
    runs, n_slot_runs = dw_runs(rows, col_ptr)
    return DwRuns(torch.from_numpy(runs).to(device), n_slot_runs, len(col_ptr) - 1)


def dw_runs_capacity(nnz: int, n_cols: int, run: int = DW_RUN) -> int:
    """An upper bound on the slot runs of any topology of ``nnz`` slots over
    ``n_cols`` columns: each run holds a slot, and a column's runs number
    at most its slots over ``run`` plus one, so the sum over columns is at
    most ``nnz // run + n_cols``."""
    return min(nnz, nnz // run + n_cols)


def dw_runs_device(rows: torch.Tensor, col_ptr: torch.Tensor, n_cols: int,
                   run: int = DW_RUN) -> DwRuns:
    """Kernel F's run plan made where the canonical ``rows`` and their
    column offsets ``col_ptr`` (int64 (n_cols + 1,)) live, with no device
    sync: :func:`dw_runs`'s slot runs in its order at a fixed capacity
    (:func:`dw_runs_capacity`), the rows past them padding runs
    ``(-1, 0, 0)``, then the empty runs. Slot run r of column c is found by
    a search of r in the running count of runs per column; the runs are
    ordered by one stable sort on ``first row * n_cols + column``, unique
    per run, with padding keyed past every run."""
    nnz, dev = rows.shape[0], rows.device
    cap = dw_runs_capacity(nnz, n_cols, run)
    counts = col_ptr[1:] - col_ptr[:-1]
    per_col = (counts + run - 1) // run
    ends = torch.cumsum(per_col, 0)
    r = torch.arange(cap, dtype=torch.int64, device=dev)
    col = torch.searchsorted(ends, r, right=True)
    real = col < n_cols
    c = col.clamp(max=n_cols - 1)
    lo = col_ptr.index_select(0, c) + (r - (ends - per_col).index_select(0, c)) * run
    n = torch.minimum(col_ptr.index_select(0, c + 1) - lo, torch.full_like(lo, run))
    first_row = rows.index_select(0, lo.clamp(0, max(nnz - 1, 0))).long()
    key = torch.where(real, first_row * n_cols + c, torch.iinfo(torch.int64).max)
    order = torch.sort(key, stable=True).indices
    slot_runs = torch.stack([torch.where(real, c, -1), torch.where(real, lo, 0),
                             torch.where(real, n, 0)], 1).index_select(0, order)
    cols = torch.arange(n_cols, dtype=torch.int64, device=dev)
    empty = torch.stack([cols, col_ptr[:-1], torch.zeros_like(cols)], 1)
    return DwRuns(torch.cat([slot_runs, empty]).to(torch.int32), cap, n_cols)


# Kernel F's run plans, by the identity of the ``cols`` they cut: made with
# the arrays by ``device_arrays``, else once per tensor by :func:`dw_plan`.
_DW_RUNS: Dict[int, Tuple[weakref.ref, DwRuns]] = {}


def dw_plan(rows: torch.Tensor, cols: torch.Tensor, n_cols: int) -> DwRuns:
    """Kernel F's run plan for the canonical ``cols`` (``rows`` only orders
    the runs): the one registered to ``cols``
    (:meth:`ElementTopology.device_arrays`: no device work), else made
    once from its offsets after checking that it is sorted and in
    [0, n_cols) (one device sync), and registered. Frozen topology: the
    tensor must not change after."""
    runs = _recall(_DW_RUNS, cols)
    if runs is None:
        col_ptr = _checked_offsets(cols, n_cols).cpu().numpy()
        runs = _runs_to_device(rows.cpu().numpy(), col_ptr, cols.device)
        _remember(_DW_RUNS, cols, runs)
    if runs.n_cols != n_cols:
        raise ValueError(f"cols was planned for {runs.n_cols} columns, not {n_cols}")
    return runs


def route_hints(arrays: ElemTopoArrays, in_dim: int, out_dim: int) -> Tuple[int, int]:
    """Host ints for kernel A's routes over ``arrays``: the longest segment
    of the column order (the forward) and of the row order (dX), as their
    registered offsets record them, else the mean."""
    nnz = arrays.rows.shape[0]
    return (_longest_segment(registered_offsets(arrays.cols), nnz, out_dim),
            _longest_segment(registered_offsets(arrays.rows_r), nnz, in_dim))


def register_device_plans(arrays: ElemTopoArrays, in_dim: int, out_dim: int,
                          longest: Tuple[int, int]) -> None:
    """Make on the device, with no sync, what ``ElementTopology.
    device_arrays`` makes on the host for its arrays, and register it the
    same way: both orders' offsets (to ``cols`` and ``rows_r``, their end
    the slot count by construction), kernel F's run plan
    (:func:`dw_runs_device`, to ``cols``) and ``rows`` as trusted for F's
    gather. ``arrays`` must be a canonical, in-range topology's views, as
    device evolution makes them: nothing here checks them. ``longest`` is
    the (column, row) route hint for kernel A (:func:`route_hints` of the
    last host-made arrays): both routes give the same bits, so a stale
    hint changes only the time."""
    nnz = arrays.rows.shape[0]
    col_ptr = segment_offsets(arrays.cols, out_dim)
    row_ptr = segment_offsets(arrays.rows_r, in_dim)
    _note_offsets(col_ptr, longest[0], nnz)
    _note_offsets(row_ptr, longest[1], nnz)
    _register_offsets(arrays.cols, col_ptr)
    _register_offsets(arrays.rows_r, row_ptr)
    _remember(_DW_RUNS, arrays.cols, dw_runs_device(arrays.rows, col_ptr, out_dim))
    _trust_indices(arrays.rows, in_dim)


def coo_dw(
    xT: torch.Tensor,
    dyT: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    chunk: Optional[int] = None,
    with_dbias: bool = False,
    mask: Optional[torch.Tensor] = None,
    slope: Optional[float] = None,
):
    """Per-slot batch contraction ``dv[j] = sum_b xT[rows[j], b] * dz[cols[j], b]``.

    ``xT`` is (in_dim, B), ``dyT`` is (out_dim, B); ``dv`` is (nnz,),
    aligned to the canonical slot order. Without an epilogue ``dz = dyT``
    and it returns ``dv``. ``with_dbias`` (a layer with a bias) returns
    ``(dv, dz, dbias)`` with ``dbias = dz.sum(1)``; with ``mask`` too (the
    uint8 branch mask of kernel A's training epilogue) and ``slope``, ``dz``
    is All-ReLU's backward, ``where(mask, dyT, slope * dyT)``
    (:func:`coo_dw_epilogue`). A CUDA tensor launches kernel F, the
    epilogue in the same launch, over the run plan of ``cols``
    (:func:`dw_plan`: ``cols`` must be in the canonical, column-sorted
    order); each sum is taken in one fixed order (``chunk`` does not apply).
    A CPU, meta or fake tensor takes the plain version.
    """
    if takes_plain(xT):
        return coo_dw_plain(xT, dyT, rows, cols, chunk=chunk, with_dbias=with_dbias,
                            mask=mask, slope=slope)
    if xT.device.type != "cuda":
        raise ValueError(f"coo_dw runs on cuda or cpu tensors, not {xT.device}")
    device = xT.device
    if xT.dim() != 2 or dyT.dim() != 2 or xT.shape[1] != dyT.shape[1]:
        raise ValueError(
            f"xT and dyT must be (features, B) with one B, got {tuple(xT.shape)} and "
            f"{tuple(dyT.shape)}")
    nnz = rows.shape[0]
    build.check_tensor(xT, "xT", dtype=torch.float32, shape=xT.shape, device=device)
    build.check_tensor(rows, "rows", dtype=torch.int32, shape=(nnz,), device=device)
    build.check_tensor(cols, "cols", dtype=torch.int32, shape=(nnz,), device=device)
    _check_indices(rows, xT.shape[0], "rows")
    runs = dw_plan(rows, cols, dyT.shape[0])
    dv, dz, dbias, launched = _coo_dw_cuda(dyT, mask, slope, with_dbias, xT=xT, rows=rows,
                                           runs=runs)
    if launched:
        coo_dw.launches += 1
        if with_dbias:
            coo_dw.epilogue_launches += 1
        if mask is not None:
            coo_dw.mask_launches += 1
    return (dv, dz, dbias) if with_dbias else dv


coo_dw.launches = 0  # kernel F launches, so a run can show it went through the kernel
coo_dw.epilogue_launches = 0  # of which with the epilogue (dbias, and dz with a mask)
coo_dw.mask_launches = 0  # of which with All-ReLU's backward (the mask)

_COO_DW_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 5 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
]


def _check_dw_epilogue_args(with_dbias: bool, mask: Optional[torch.Tensor],
                            slope: Optional[float]) -> None:
    if mask is not None and not with_dbias:
        raise ValueError("the mask is All-ReLU's branch after the bias: a mask needs with_dbias")
    if mask is not None and slope is None:
        raise ValueError("a mask needs the slope of its negative branch")


def _coo_dw_cuda(dyT: torch.Tensor, mask: Optional[torch.Tensor], slope: Optional[float],
                 with_dbias: bool, *, xT: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None, runs: Optional[DwRuns] = None,
                 dv_out: Optional[torch.Tensor] = None, dz_out: Optional[torch.Tensor] = None,
                 dbias_out: Optional[torch.Tensor] = None):
    """Check the epilogue's operands, allocate the outputs (or take
    ``dv_out``, ``dz_out`` and ``dbias_out``, checked here) and launch
    kernel F on the caller's stream over ``runs`` (its slot runs alone
    without an epilogue), or, with no run plan, its epilogue alone over one
    empty run per row of ``dyT`` (kernel G's standalone pass); the caller
    has checked ``xT``, ``rows`` and ``runs``. Returns ``(dv, dz, dbias,
    launched)``: dz is ``dyT`` itself without a mask (not written), dbias
    None without ``with_dbias``."""
    _check_dw_epilogue_args(with_dbias, mask, slope)
    if dyT.dim() != 2:
        raise ValueError(f"dy must be (N, B), got shape {tuple(dyT.shape)}")
    device = dyT.device
    f32 = torch.float32
    build.check_tensor(dyT, "dy", dtype=f32, shape=dyT.shape, device=device)
    if mask is not None:
        build.check_tensor(mask, "mask", dtype=torch.uint8, shape=dyT.shape, device=device)

    def output(given, name, shape, make):
        if given is None:
            return make()
        build.check_tensor(given, name, dtype=f32, shape=shape, device=device)
        return given

    dv = None if rows is None else output(
        dv_out, "dv_out", rows.shape, lambda: torch.empty(rows.shape, dtype=f32, device=device))
    dz = dyT if mask is None else output(dz_out, "dz_out", dyT.shape,
                                         lambda: torch.empty_like(dyT))
    dbias = None if not with_dbias else output(
        dbias_out, "dbias_out", (dyT.shape[0],),
        lambda: torch.empty((dyT.shape[0],), dtype=f32, device=device))
    if runs is None:
        n_runs = dyT.shape[0]
    else:
        n_runs = runs.runs.shape[0] if with_dbias else runs.n_slot_runs
    if n_runs:
        ptr = (lambda t: None if t is None else t.data_ptr())
        fn = build.kernel("coo_dw", "coo_dw_f32", _COO_DW_ARGTYPES)
        rc = fn(ptr(xT), dyT.data_ptr(), ptr(mask), 0.0 if slope is None else slope, ptr(rows),
                None if runs is None else runs.runs.data_ptr(), ptr(dv),
                None if mask is None else dz.data_ptr(), ptr(dbias), n_runs, dyT.shape[1],
                *build.stream_args(device))
        build.check_launch(rc, "coo_dw kernel")
    return dv, dz, dbias, n_runs > 0


def coo_dw_epilogue(dyT: torch.Tensor, mask: Optional[torch.Tensor],
                    slope: Optional[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel F's epilogue (kernel G's work), on any
    device: ``dz = where(mask, dyT, slope * dyT)`` (``dz = dyT`` without a
    mask) and ``dbias = dz.sum(1)`` for (N, B) tensors."""
    dz = dyT if mask is None else torch.where(mask.bool(), dyT, slope * dyT)
    return dz, dz.sum(1)


def coo_dw_plain(
    xT: torch.Tensor,
    dyT: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    *,
    chunk: Optional[int] = None,
    with_dbias: bool = False,
    mask: Optional[torch.Tensor] = None,
    slope: Optional[float] = None,
):
    """Plain PyTorch version of kernel F, the reference's chunked form: the
    two gathered (chunk, B) slabs are the peak intermediate (their product
    is taken in place in the first, where autograd does not record it),
    reduced over the batch at once; with ``with_dbias``,
    :func:`coo_dw_epilogue` first, as :func:`coo_dw`. Runs on any
    device."""
    _check_dw_epilogue_args(with_dbias, mask, slope)
    dz, dbias = coo_dw_epilogue(dyT, mask, slope) if with_dbias else (dyT, None)
    nnz = int(rows.shape[0])
    dtype = torch.promote_types(xT.dtype, dz.dtype)
    out = torch.empty((nnz,), dtype=dtype, device=xT.device)
    chunk = spmm_chunk_for(xT.shape[-1], nnz, chunk)
    for lo in range(0, nnz, chunk):
        r, c = rows[lo:lo + chunk].long(), cols[lo:lo + chunk].long()
        slab, other = xT[r].to(dtype), dz[c].to(dtype)
        prod = slab * other if slab.requires_grad or other.requires_grad else slab.mul_(other)
        out[lo:lo + chunk] = prod.sum(-1)
    return (out, dz, dbias) if with_dbias else out


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _init_numpy(
    rng: np.random.Generator, shape, *, fan_in_dense: int, scheme: str
) -> np.ndarray:
    """Weight init. fan_in follows the paper (dense fan-in based scaling)."""
    if scheme == "normal":
        return rng.standard_normal(shape).astype(np.float32) * 0.05
    if scheme == "he_uniform":
        limit = np.sqrt(6.0 / max(1, fan_in_dense))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)
    if scheme == "xavier":
        limit = np.sqrt(3.0 / max(1, fan_in_dense))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)
    if scheme == "zeros":
        return np.zeros(shape, np.float32)
    raise ValueError(f"unknown init scheme {scheme!r}")
