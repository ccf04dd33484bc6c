"""Block-sparse products for truly sparse linear layers: kernels C, D and E.

The sparse weight is a compact stack of tiles ``values: (nb, bm, bn)`` with
int32 block coordinates (``BlockTopoArrays``), as in the reference:

Forward   y[b, cols[i]] += x[b, rows[i]] @ values[i]           kernel C, ``csrc/bsmm_fwd.cu``
dX        dx[b, rows_r[i]] += dy[b, cols_r[i]] @ values[perm_r[i]]^T   kernel D, ``csrc/bsmm_dx.cu``
dW        dw[i] = sum_b x[b, rows[i]]^T @ dy[b, cols[i]]       kernel E, ``csrc/bsmm_dw.cu``

Twins of ``repro.kernels.block_sparse_matmul.bsmm_fwd`` / ``bsmm_dx`` /
``bsmm_dw``, with these differences: a batch of any size is taken (the
kernels mask a ragged batch tile where the Pallas kernels need it padded),
there is no ``block_b``, and ``first_col``/``first_row`` are accepted but not
read: each kernel block owns an output tile and walks that tile's slot range,
whose offsets (``col_ptr``, ``row_ptr``) the wrappers compute on the device
with ``torch.searchsorted``, once per (frozen) index tensor. An input
block-row that no slot covers gets an exact-zero gradient from both kernel D
and its plain version.

The kernels cut long sums into contiguous runs that separate blocks sum, and
add the runs' partials in index order in a second pass (no atomics: the same
inputs give the same bits on every run): C a block-column's slots, D a
block-row's, E the batch. How many runs is a pure function of host ints
(``fwd_parts``, ``dx_parts``, ``dw_splits``), so choosing it reads nothing
from the device. Kernel C's bf16 instance has two more routes for tiles
whose sides are multiples of 32 (``fwd_plan``): ``decode`` (up to 16 rows,
the operands swapped) and ``rows`` (more rows); both split a column's k
over the warps of one block and add the warps' partials in shared memory,
so they pay no second pass. Its wrapper can also apply All-ReLU in the
store (``all_relu=(alpha, layer_index)``), bit for bit kernel B's bf16
entry after it: the LM's sparse FFN runs W_in so. Kernels D and E have
bf16 instances too, kernel C's backward in the LM's training step, on
Hopper's wgmma fed by a TMA ring, one launch each: D sums each block-row
whole, one CTA per block-row and 128 rows; E cuts the batch into runs of 64-sample
chunks over a cluster per tile (``dw_splits_bf16``) and sums the runs' f32
partials in distributed shared memory in rank order; both round once.

Each wrapper launches its kernel for a CUDA tensor (f32 or bfloat16,
contiguous, block sizes 1..128; in bfloat16 kernels D and E take sides
that are multiples of 16) or raises, and takes its plain version for a CPU
tensor. It counts its launches (one per call, the second pass of a split
included; each also counts its second passes, D and E their bfloat16
calls, and kernel C its calls with All-ReLU and by route). The bfloat16
instances of D and E launch nothing for an empty batch or topology.
Topology arrays are checked once per tensor (one device sync on first
use): every coordinate inside the grid and the slot order sorted, so the
kernels never index out of bounds. Arrays that device SET evolution made
hold these by construction and are registered as checked
(:func:`trust_block_arrays`), so a new topology costs no sync.
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.sparsity import forget_on_death, segment_offsets
from repro_torch.device import takes_plain
from repro_torch.kernels import build
from repro_torch.kernels.all_relu_fused import bias_all_relu_plain
from repro_torch.kernels.ref import scalar_in, slope_for

__all__ = [
    "DECODE_ROWS",
    "FwdPlan",
    "MAX_BLOCK",
    "ROWS_TILES",
    "SMS",
    "bsmm_dw",
    "bsmm_dw_plain",
    "bsmm_dx",
    "bsmm_dx_plain",
    "bsmm_fwd",
    "bsmm_fwd_plain",
    "dw_batch_runs",
    "dw_splits",
    "dw_splits_bf16",
    "dx_parts",
    "fwd_parts",
    "fwd_plan",
    "split_runs",
    "trust_block_arrays",
]

MAX_BLOCK = 128  # the kernels take block sizes 1..128
SMS = 132  # an H100 SXM's streaming multiprocessors: the splits aim at one wave of blocks
FWD_TILE = 64  # kernels C and D: a block's 64 batch rows x 64 output columns
DW_TILE = 64  # kernel E: a block's 64 x 64 part of one slot's tile
DW_CHUNK = 32  # kernel E: samples per pipeline stage; batch runs are whole chunks
DW_CHUNK_BF16 = 64  # kernel E's bf16 instance: samples per stage
CLUSTER_MAX = 8  # the portable cluster size: E's bf16 runs a cluster at most
DW_RUN_CHUNKS_BF16 = 8  # kernel E's bf16 instance: 64-row chunks a batch run at least
DECODE_ROWS = 16  # kernel C bf16: calls of up to this many rows take the decode route
# kernel C bf16's rows route: its block tiles (batch rows, features) from the
# smallest, each with the blocks an SM holds at once (sm_90a: 72 and 107
# registers a thread, rings of 76 and 108 KB)
ROWS_TILES = ((32, 32, 3), (64, 64, 2))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# split plans (host ints only: choosing them reads nothing from the device)
# ---------------------------------------------------------------------------


def fwd_parts(nb: int, grid_n: int, batch: int, bn: int) -> int:
    """P, the runs kernel C cuts each block-column's slot range into: enough
    that the blocks fill about one wave of the SMs, and no more than the
    mean slots per column. 1 for a layer whose columns already fill the card
    (the full-width model's layers 0-2); 32 for its output layer (one column
    of 32 slots) at batch 128."""
    blocks = grid_n * _cdiv(batch, FWD_TILE) * _cdiv(bn, FWD_TILE)
    if blocks == 0:
        return 1
    return max(1, min(_cdiv(nb, grid_n), SMS // blocks))


class FwdPlan(NamedTuple):
    """How kernel C runs one call. ``route``: ``"tiled"`` (the f32
    instance's design, both dtypes), ``"decode"`` or ``"rows"`` (bf16
    only); ``parts``: the runs of the tiled route's split (1 elsewhere: no
    second pass); ``tile_rows``, ``tile_feat``: the batch rows and output
    features of a block on the new routes (0 where unused)."""

    route: str
    parts: int
    tile_rows: int
    tile_feat: int


def fwd_plan(nb: int, grid_n: int, batch: int, bm: int, bn: int, *, bf16: bool,
             aligned: bool = True) -> FwdPlan:
    """Kernel C's route for a call, from host ints alone. bf16 tiles whose
    sides are multiples of 32, with 16-byte aligned x and values, take the
    decode route up to ``DECODE_ROWS`` rows (16 features a block, whatever
    the batch, so a row's bits do not depend on the call's other rows) and
    the rows route above it, on the smallest of ``ROWS_TILES`` whose blocks
    the card holds in one wave (else the largest that divides bn).
    Everything else (f32, the reference sweep's 8- and 16-wide tiles,
    unaligned operands) keeps the tiled route with ``fwd_parts``' split."""
    if bf16 and aligned and bm % 32 == 0 and bn % 32 == 0:
        if batch <= DECODE_ROWS:
            return FwdPlan("decode", 1, 0, 16)
        for tile_rows, tile_feat, per_sm in (t for t in ROWS_TILES if bn % t[1] == 0):
            if grid_n * _cdiv(batch, tile_rows) * (bn // tile_feat) <= per_sm * SMS:
                break
        return FwdPlan("rows", 1, tile_rows, tile_feat)
    return FwdPlan("tiled", fwd_parts(nb, grid_n, batch, bn), 0, 0)


def dx_parts(nb: int, grid_m: int, batch: int, bm: int) -> int:
    """P, the runs kernel D cuts each block-row's slot range into: kernel
    C's rule over block-rows. 4 on the full-width model's layer 2 (8
    block-rows of 4 slots: 32 blocks become 128) at batch 128, 1 on layers
    1 and 3, whose block-rows already fill the card."""
    return fwd_parts(nb, grid_m, batch, bm)


def split_runs(begin: int, end: int, parts: int) -> List[Tuple[int, int]]:
    """The ``parts`` contiguous runs of ``[begin, end)``, in order, as
    kernel C's (and D's) block p takes them: ``[begin + n*p//parts, begin +
    n*(p+1)//parts)`` with n = end - begin (a run may be empty)."""
    n = end - begin
    return [(begin + n * p // parts, begin + n * (p + 1) // parts) for p in range(parts)]


def dw_splits(nb: int, batch: int, bm: int, bn: int) -> int:
    """S, the runs kernel E cuts the batch into: enough that the blocks fill
    about one wave of the SMs, at most one run per 32-sample chunk. 1 for a
    layer of 32 128x128 tiles at batch 128, 4 for a layer of 8."""
    blocks = nb * _cdiv(bm, DW_TILE) * _cdiv(bn, DW_TILE)
    if blocks == 0:
        return 1
    return max(1, min(_cdiv(batch, DW_CHUNK), SMS // blocks))


def dw_splits_bf16(nb: int, batch: int) -> int:
    """S, the runs kernel E's bf16 instance cuts the batch into, one CTA of
    a tile's cluster each (every CTA covers the whole tile): at least
    ``DW_RUN_CHUNKS_BF16`` 64-row chunks a run, so that a run's loads pay
    for its share of the cluster's sum, the nb clusters on at most 3/4 of
    the SMs (one CTA an SM; the rest absorbs how clusters pack onto the
    card's GPCs), at most ``CLUSTER_MAX``. 4 on the LM's W_in (22 tiles)
    and W_out (15 tiles) at 2,048 rows; 1 below 961 rows."""
    if nb == 0:
        return 1
    chunks = _cdiv(batch, DW_CHUNK_BF16)
    return max(1, min(CLUSTER_MAX, chunks // DW_RUN_CHUNKS_BF16, (3 * SMS // 4) // nb))


def dw_batch_runs(batch: int, splits: int, chunk: int = DW_CHUNK) -> List[Tuple[int, int]]:
    """The ``splits`` contiguous sample runs of kernel E, in order: run s
    holds chunks ``[C*s//S, C*(s+1)//S)`` of the C = ceil(batch/chunk)
    (``DW_CHUNK``; ``DW_CHUNK_BF16`` for the bf16 instance)."""
    chunks = _cdiv(batch, chunk)
    edge = [min(batch, chunk * (chunks * s // splits)) for s in range(splits + 1)]
    return list(zip(edge[:-1], edge[1:]))


# ---------------------------------------------------------------------------
# plain versions (any device; the wrappers take them for CPU tensors)
# ---------------------------------------------------------------------------


def bsmm_fwd_plain(
    x: torch.Tensor, values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    first_col: torch.Tensor, *, grid_n: int, all_relu: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """Plain version of kernel C: gather the x tiles, one einsum, and an
    ``index_add_`` into the output block-columns. x: (B, grid_m*bm) ->
    (B, grid_n*bn). bfloat16 operands are taken to f32 and the f32 sums
    rounded once to bfloat16, as the Pallas kernel's f32 accumulator is
    (not the reference's ``bsmm_xla``, which rounds each tile's product).
    With ``all_relu=(alpha, layer_index)``, kernel B's plain version
    (``bias_all_relu_plain``, no bias) follows, in x's dtype."""
    if all_relu is not None:
        y = bsmm_fwd_plain(x, values, rows, cols, first_col, grid_n=grid_n)
        alpha, layer_index = all_relu
        return bias_all_relu_plain(y, None, alpha=alpha, layer_index=layer_index)
    if x.dtype == torch.bfloat16:
        y = bsmm_fwd_plain(x.float(), values.float(), rows, cols, first_col, grid_n=grid_n)
        return y.to(torch.bfloat16)
    B = x.shape[0]
    _, bm, bn = values.shape
    xg = x.reshape(B, -1, bm)[:, rows.long()]                 # (B, nb, bm)
    yb = torch.einsum("bnm,nmo->bno", xg, values)              # (B, nb, bn)
    y = torch.zeros((B, grid_n, bn), dtype=yb.dtype, device=x.device)
    return y.index_add_(1, cols.long(), yb).reshape(B, grid_n * bn)


def bsmm_dx_plain(
    dy: torch.Tensor, values: torch.Tensor, rows_r: torch.Tensor, cols_r: torch.Tensor,
    first_row: torch.Tensor, perm_r: torch.Tensor, *, grid_m: int,
) -> torch.Tensor:
    """Plain version of kernel D over the row-sorted order. dy:
    (B, grid_n*bn) -> (B, grid_m*bm); uncovered block-rows are zero.
    bfloat16 operands are taken to f32 and the f32 sums rounded once, as
    the Pallas kernel's f32 scratch is."""
    if dy.dtype == torch.bfloat16:
        dx = bsmm_dx_plain(dy.float(), values.float(), rows_r, cols_r, first_row, perm_r,
                           grid_m=grid_m)
        return dx.to(torch.bfloat16)
    B = dy.shape[0]
    _, bm, bn = values.shape
    dyg = dy.reshape(B, -1, bn)[:, cols_r.long()]             # (B, nb, bn)
    xb = torch.einsum("bno,nmo->bnm", dyg, values[perm_r.long()])
    dx = torch.zeros((B, grid_m, bm), dtype=xb.dtype, device=dy.device)
    return dx.index_add_(1, rows_r.long(), xb).reshape(B, grid_m * bm)


def bsmm_dw_plain(
    x: torch.Tensor, dy: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    *, block_m: int, block_n: int,
) -> torch.Tensor:
    """Plain version of kernel E: (nb, bm, bn) tile gradients, in x's
    dtype; bfloat16 operands summed in f32 and rounded once, as kernel D's."""
    if x.dtype == torch.bfloat16:
        dw = bsmm_dw_plain(x.float(), dy.float(), rows, cols, block_m=block_m, block_n=block_n)
        return dw.to(torch.bfloat16)
    B = x.shape[0]
    xg = x.reshape(B, -1, block_m)[:, rows.long()]            # (B, nb, bm)
    dyg = dy.reshape(B, -1, block_n)[:, cols.long()]          # (B, nb, bn)
    return torch.einsum("bnm,bno->nmo", xg, dyg)


# ---------------------------------------------------------------------------
# checks shared by the three wrappers
# ---------------------------------------------------------------------------

# Topology tensors already checked, by kernel, grid and the identities of
# the tensors checked. A trainer builds its topology arrays once per epoch,
# so each costs one device sync, on first use; they are frozen and must not
# change after.
_CHECKED: Dict[tuple, Tuple[weakref.ref, ...]] = {}


def _check_once(what: str, grid: Tuple[int, ...], tensors: Tuple[torch.Tensor, ...],
                check) -> None:
    key = (what, grid) + tuple(id(t) for t in tensors)
    seen = _CHECKED.get(key)
    if seen is not None and all(r() is t for r, t in zip(seen, tensors)):
        return
    check()
    _mark_checked(what, grid, tensors)


def _mark_checked(what: str, grid: Tuple[int, ...], tensors: Tuple[torch.Tensor, ...]) -> None:
    key = (what, grid) + tuple(id(t) for t in tensors)
    refs = tuple(weakref.ref(t, forget_on_death(_CHECKED, key)) for t in tensors)
    _CHECKED[key] = refs


def trust_block_arrays(arrays, grid_m: int, grid_n: int) -> None:
    """Register a block topology's device arrays as checked for kernels C,
    D and E on a (grid_m, grid_n) grid, so that none of them syncs to check
    them. Only for arrays whose invariants hold by construction, as device
    SET evolution makes them (``core.topology.evolve_block_layers_device``:
    canonical, in the grid, ``perm_r`` a permutation)."""
    nb = arrays.rows.shape[0]
    for what, grid, tensors in (
        ("fwd", (grid_m, grid_n), (arrays.rows, arrays.cols)),
        ("dx", (grid_m, grid_n, nb), (arrays.rows_r, arrays.cols_r, arrays.perm_r)),
        ("dw", (grid_m, grid_n), (arrays.rows, arrays.cols)),
    ):
        _mark_checked(what, grid, tensors)


# Segment offsets (kernel C's col_ptr, kernel D's row_ptr), by sorted index
# tensor and grid: computed once per (frozen) topology tensor, so that a
# training step does not launch the two offset kernels again for every call.
_OFFSETS: Dict[tuple, Tuple[weakref.ref, torch.Tensor]] = {}


def _offsets_once(idx: torch.Tensor, n: int) -> torch.Tensor:
    key = (id(idx), n)
    hit = _OFFSETS.get(key)
    if hit is not None and hit[0]() is idx:
        return hit[1]
    offsets = segment_offsets(idx, n)
    _OFFSETS[key] = (weakref.ref(idx, forget_on_death(_OFFSETS, key)), offsets)
    return offsets


def _in_range(t: torch.Tensor, hi: int) -> torch.Tensor:
    if not t.numel():
        return torch.tensor(True, device=t.device)
    return (t.min() >= 0) & (t.max() < hi)


def _sorted(t: torch.Tensor) -> torch.Tensor:
    return (t.diff() >= 0).all() if t.numel() > 1 else torch.tensor(True, device=t.device)


def _check_block_sizes(bm: int, bn: int) -> None:
    if not (1 <= bm <= MAX_BLOCK and 1 <= bn <= MAX_BLOCK):
        raise ValueError(
            f"block size {bm}x{bn}: the block kernels take block_m and block_n "
            f"from 1 to {MAX_BLOCK}"
        )


def _check_index(t: torch.Tensor, name: str, nb: int, device: torch.device) -> None:
    build.check_tensor(t, name, dtype=torch.int32, shape=(nb,), device=device)


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {t.device}")


_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(t: torch.Tensor, what: str) -> bool:
    """Raise unless ``t`` is f32 or bfloat16; True for bfloat16."""
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what} has dtype {t.dtype}; the kernel takes {list(_DTYPES)}")
    return t.dtype == torch.bfloat16


def _check_bf16_sides(bm: int, bn: int, what: str) -> None:
    if bm % 16 or bn % 16:
        raise ValueError(f"block size {bm}x{bn}: {what}'s bfloat16 instance takes tile sides "
                         "that are multiples of 16 (the bf16 MMA's k)")


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its storage does not start on a 16-byte
    boundary (a view at an offset): the bf16 instances of D and E stage
    16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_I64 = ctypes.c_int64
_FWD_SYMBOLS = {torch.float32: "bsmm_fwd_f32", torch.bfloat16: "bsmm_fwd_bf16"}
_FWD_ARGTYPES = {
    torch.float32: [ctypes.c_void_p] * 6 + [_I64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    # ... parts, route, tile_rows, tile_feat, epilogue, slope, device, stream
    torch.bfloat16: [ctypes.c_void_p] * 6 + [_I64] * 3 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_FWD_ROUTES = {"tiled": 0, "decode": 1, "rows": 2}
_DX_ARGTYPES = [ctypes.c_void_p] * 7 + [_I64] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# ... batch, grid_m, grid_n, n_blocks, bm, bn, parts, device, stream
_DX_BF16_ARGTYPES = [ctypes.c_void_p] * 6 + [_I64] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_DW_ARGTYPES = [ctypes.c_void_p] * 6 + [_I64] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# no part buffer: the runs meet in the cluster's shared memory
_DW_BF16_ARGTYPES = [ctypes.c_void_p] * 5 + [_I64] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


# ---------------------------------------------------------------------------
# kernel C
# ---------------------------------------------------------------------------


def bsmm_fwd(
    x: torch.Tensor, values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    first_col: torch.Tensor, *, grid_n: int, all_relu: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """x: (B, grid_m*bm) @ block-sparse W -> (B, grid_n*bn), in x's dtype
    (f32 or bfloat16; values of the same dtype). ``cols`` must be
    non-decreasing (canonical order). ``all_relu=(alpha, layer_index)``
    applies All-ReLU with that layer's slope in the bf16 instance's store
    (the f32 instance has no epilogue and raises). A CUDA tensor launches
    kernel C's instance for its dtype, on the route ``fwd_plan`` gives, and
    raises for another dtype; a CPU, meta or fake tensor takes the plain version."""
    if takes_plain(x):
        return bsmm_fwd_plain(x, values, rows, cols, first_col, grid_n=grid_n, all_relu=all_relu)
    _require_cuda(x, "bsmm_fwd")
    nb, bm, bn = values.shape
    _check_block_sizes(bm, bn)
    if x.dim() != 2 or x.shape[1] % bm or x.shape[1] == 0:
        raise ValueError(f"x must be (B, grid_m*{bm}), got shape {tuple(x.shape)}")
    if x.dtype not in _FWD_SYMBOLS:
        raise ValueError(f"x has dtype {x.dtype}; kernel C takes {list(_FWD_SYMBOLS)}")
    bf16 = x.dtype == torch.bfloat16
    if all_relu is not None and not bf16:
        raise ValueError("kernel C's All-ReLU store is in its bfloat16 instance, not for "
                         f"{x.dtype}")
    batch, grid_m = x.shape[0], x.shape[1] // bm
    dev = x.device
    build.check_tensor(x, "x", dtype=x.dtype, shape=x.shape, device=dev)
    build.check_tensor(values, "values", dtype=x.dtype, shape=(nb, bm, bn), device=dev)
    _check_index(rows, "rows", nb, dev)
    _check_index(cols, "cols", nb, dev)

    def check():
        if not bool(_in_range(rows, grid_m) & _in_range(cols, grid_n) & _sorted(cols)):
            raise ValueError(
                f"rows must lie in [0, {grid_m}) and cols be non-decreasing in [0, {grid_n})"
            )

    _check_once("fwd", (grid_m, grid_n), (rows, cols), check)
    col_ptr = _offsets_once(cols, grid_n)
    y = torch.empty((batch, grid_n * bn), dtype=x.dtype, device=dev)
    plan = fwd_plan(nb, grid_n, batch, bm, bn, bf16=bf16,
                    aligned=x.data_ptr() % 16 == 0 and values.data_ptr() % 16 == 0)
    # a split's partials stay f32 in both instances
    part = (torch.empty((plan.parts, batch, grid_n * bn), dtype=torch.float32, device=dev)
            if plan.parts > 1 else None)
    args = (x.data_ptr(), values.data_ptr(), rows.data_ptr(), col_ptr.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(), batch, grid_m, grid_n,
            bm, bn, plan.parts)
    if bf16:
        slope = 0.0 if all_relu is None else scalar_in(slope_for(*all_relu), torch.bfloat16)
        args += (_FWD_ROUTES[plan.route], plan.tile_rows, plan.tile_feat,
                 int(all_relu is not None), slope)
    fn = build.kernel("bsmm_fwd", _FWD_SYMBOLS[x.dtype], _FWD_ARGTYPES[x.dtype])
    build.check_launch(fn(*args, *build.stream_args(dev)), "bsmm_fwd kernel")
    bsmm_fwd.launches += 1
    bsmm_fwd.second_pass_launches += plan.parts > 1
    bsmm_fwd.epilogue_launches += all_relu is not None
    bsmm_fwd.decode_launches += plan.route == "decode"
    bsmm_fwd.rows_launches += plan.route == "rows"
    return y


bsmm_fwd.launches = 0  # kernel C launches, so a run can show it went through the kernel
bsmm_fwd.second_pass_launches = 0  # of which split, with a second pass over the partials
bsmm_fwd.epilogue_launches = 0  # of which with All-ReLU in the store
bsmm_fwd.decode_launches = 0  # of which on the bf16 decode route
bsmm_fwd.rows_launches = 0  # ... and on the bf16 rows route


# ---------------------------------------------------------------------------
# kernel D
# ---------------------------------------------------------------------------


def bsmm_dx(
    dy: torch.Tensor, values: torch.Tensor, rows_r: torch.Tensor, cols_r: torch.Tensor,
    first_row: torch.Tensor, perm_r: torch.Tensor, *, grid_m: int,
) -> torch.Tensor:
    """dy: (B, grid_n*bn) -> dx = dy @ W^T, (B, grid_m*bm), in dy's dtype
    (f32 or bfloat16, values of the same dtype), over the row-sorted order
    (``rows_r`` non-decreasing). Input block-rows that no slot covers come
    out as exact zeros. A CUDA tensor launches kernel D's instance for its
    dtype (bfloat16: tile sides multiples of 16) and raises for another
    dtype; a CPU, meta or fake tensor takes the plain version."""
    if takes_plain(dy):
        return bsmm_dx_plain(dy, values, rows_r, cols_r, first_row, perm_r, grid_m=grid_m)
    _require_cuda(dy, "bsmm_dx")
    nb, bm, bn = values.shape
    _check_block_sizes(bm, bn)
    if dy.dim() != 2 or dy.shape[1] % bn or dy.shape[1] == 0:
        raise ValueError(f"dy must be (B, grid_n*{bn}), got shape {tuple(dy.shape)}")
    if grid_m < 1:
        raise ValueError(f"grid_m must be positive, got {grid_m}")
    bf16 = _check_dtype(dy, "dy")
    if bf16:
        _check_bf16_sides(bm, bn, "kernel D")
    batch, grid_n = dy.shape[0], dy.shape[1] // bn
    dev = dy.device
    build.check_tensor(dy, "dy", dtype=dy.dtype, shape=dy.shape, device=dev)
    build.check_tensor(values, "values", dtype=dy.dtype, shape=(nb, bm, bn), device=dev)
    _check_index(rows_r, "rows_r", nb, dev)
    _check_index(cols_r, "cols_r", nb, dev)
    _check_index(perm_r, "perm_r", nb, dev)

    def check():
        ok = (_in_range(rows_r, grid_m) & _sorted(rows_r) & _in_range(cols_r, grid_n)
              & _in_range(perm_r, nb))
        if not bool(ok):
            raise ValueError(
                f"rows_r must be non-decreasing in [0, {grid_m}), cols_r lie in "
                f"[0, {grid_n}) and perm_r in [0, {nb})"
            )

    _check_once("dx", (grid_m, grid_n, nb), (rows_r, cols_r, perm_r), check)
    row_ptr = _offsets_once(rows_r, grid_m)
    if bf16:
        if batch == 0 or nb == 0:  # nothing to launch: every block-row is uncovered
            return torch.zeros((batch, grid_m * bm), dtype=dy.dtype, device=dev)
        dx = torch.empty((batch, grid_m * bm), dtype=dy.dtype, device=dev)
        dy, values = _aligned16(dy), _aligned16(values)
        fn = build.kernel("bsmm_dx", "bsmm_dx_bf16", _DX_BF16_ARGTYPES)
        rc = fn(dy.data_ptr(), values.data_ptr(), cols_r.data_ptr(),
                perm_r.data_ptr(), row_ptr.data_ptr(), dx.data_ptr(), batch, grid_m, grid_n,
                nb, bm, bn, *build.stream_args(dev))
        build.check_launch(rc, "bsmm_dx bf16 kernel")
        bsmm_dx.launches += 1
        bsmm_dx.bf16_launches += 1
        return dx
    f32 = torch.float32
    dx = torch.empty((batch, grid_m * bm), dtype=f32, device=dev)
    parts = dx_parts(nb, grid_m, batch, bm)
    part = torch.empty((parts, batch, grid_m * bm), dtype=f32, device=dev) if parts > 1 else None
    fn = build.kernel("bsmm_dx", "bsmm_dx_f32", _DX_ARGTYPES)
    rc = fn(
        dy.data_ptr(), values.data_ptr(), cols_r.data_ptr(), perm_r.data_ptr(),
        row_ptr.data_ptr(), dx.data_ptr(), None if part is None else part.data_ptr(),
        batch, grid_m, grid_n, bm, bn, parts, *build.stream_args(dev),
    )
    build.check_launch(rc, "bsmm_dx kernel")
    bsmm_dx.launches += 1
    bsmm_dx.second_pass_launches += parts > 1
    return dx


bsmm_dx.launches = 0  # kernel D launches
bsmm_dx.second_pass_launches = 0  # of which split, with a second pass (f32 only)
bsmm_dx.bf16_launches = 0  # of which the bfloat16 instance


# ---------------------------------------------------------------------------
# kernel E
# ---------------------------------------------------------------------------


def bsmm_dw(
    x: torch.Tensor, dy: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
    *, block_m: int, block_n: int,
) -> torch.Tensor:
    """Tile gradients ``dw[i] = x_tile(rows[i])^T @ dy_tile(cols[i])``,
    (nb, bm, bn) in x's dtype (f32 or bfloat16, dy of the same dtype),
    summed over the whole batch. A CUDA tensor launches kernel E's instance
    for its dtype (bfloat16: tile sides multiples of 16) and raises for
    another dtype; a CPU, meta or fake tensor takes the plain version."""
    if takes_plain(x):
        return bsmm_dw_plain(x, dy, rows, cols, block_m=block_m, block_n=block_n)
    _require_cuda(x, "bsmm_dw")
    bm, bn = block_m, block_n
    _check_block_sizes(bm, bn)
    if x.dim() != 2 or x.shape[1] % bm or x.shape[1] == 0:
        raise ValueError(f"x must be (B, grid_m*{bm}), got shape {tuple(x.shape)}")
    if dy.dim() != 2 or dy.shape[0] != x.shape[0] or dy.shape[1] % bn or dy.shape[1] == 0:
        raise ValueError(
            f"dy must be ({x.shape[0]}, grid_n*{bn}), got shape {tuple(dy.shape)}"
        )
    bf16 = _check_dtype(x, "x")
    if bf16:
        _check_bf16_sides(bm, bn, "kernel E")
    batch, grid_m, grid_n = x.shape[0], x.shape[1] // bm, dy.shape[1] // bn
    nb = rows.numel()
    dev = x.device
    f32 = torch.float32
    build.check_tensor(x, "x", dtype=x.dtype, shape=x.shape, device=dev)
    build.check_tensor(dy, "dy", dtype=x.dtype, shape=dy.shape, device=dev)
    _check_index(rows, "rows", nb, dev)
    _check_index(cols, "cols", nb, dev)

    def check():
        if not bool(_in_range(rows, grid_m) & _in_range(cols, grid_n)):
            raise ValueError(f"rows must lie in [0, {grid_m}) and cols in [0, {grid_n})")

    _check_once("dw", (grid_m, grid_n), (rows, cols), check)
    if bf16:
        if batch == 0 or nb == 0:  # nothing to launch: a sum over no samples
            return torch.zeros((nb, bm, bn), dtype=x.dtype, device=dev)
        dw = torch.empty((nb, bm, bn), dtype=x.dtype, device=dev)
        x, dy = _aligned16(x), _aligned16(dy)
        fn = build.kernel("bsmm_dw", "bsmm_dw_bf16", _DW_BF16_ARGTYPES)
        rc = fn(x.data_ptr(), dy.data_ptr(), rows.data_ptr(), cols.data_ptr(), dw.data_ptr(),
                nb, batch, grid_m, grid_n, bm, bn, dw_splits_bf16(nb, batch),
                *build.stream_args(dev))
        build.check_launch(rc, "bsmm_dw bf16 kernel")
        bsmm_dw.launches += 1
        bsmm_dw.bf16_launches += 1
        return dw
    dw = torch.empty((nb, bm, bn), dtype=f32, device=dev)
    # the runs' partials, summed in a second pass
    splits = dw_splits(nb, batch, bm, bn)
    part = torch.empty((splits, nb, bm, bn), dtype=f32, device=dev) if splits > 1 else None
    fn = build.kernel("bsmm_dw", "bsmm_dw_f32", _DW_ARGTYPES)
    rc = fn(
        x.data_ptr(), dy.data_ptr(), rows.data_ptr(), cols.data_ptr(), dw.data_ptr(),
        None if part is None else part.data_ptr(), nb, batch, grid_m, grid_n, bm, bn, splits,
        *build.stream_args(dev),
    )
    build.check_launch(rc, "bsmm_dw kernel")
    bsmm_dw.launches += 1
    bsmm_dw.second_pass_launches += splits > 1
    return dw


bsmm_dw.launches = 0  # kernel E launches
bsmm_dw.second_pass_launches = 0  # of which split, with a second pass over the runs (f32 only)
bsmm_dw.bf16_launches = 0  # of which the bfloat16 instance
