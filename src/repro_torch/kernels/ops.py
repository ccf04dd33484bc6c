"""Public ops for sparse linear layers.

Block granularity — two implementations of the same math on the same
topology arrays:

* ``bsmm_kernel`` — kernels C, D and E (``kernels/block_sparse_matmul.py``)
                    joined by a ``torch.autograd.Function``: the forward is
                    kernel C, the backward kernel D (only where dx is
                    needed) and kernel E, each in the operands' dtype (f32
                    for the block SET-MLP, bfloat16 for the LM's sparse FFN
                    in training). On CPU tensors each runs its plain
                    version. Twin of the reference's ``bsmm_pallas``.
* ``bsmm_xla``    — plain PyTorch gather / einsum / ``index_add``,
                    natively differentiable: the oracle of the whole op.
                    The name is the reference's.

Element granularity (the paper-faithful COO path), in kernel A's
(features, batch) layout, on kernels A (forward and dX) and F (dW, with the
epilogue's backward, kernel G's work, in its pass):

* ``espmm_train_T`` — one training layer: kernel A with the bias and
                      All-ReLU in its store, recording the branch mask;
                      backward F (dz, dbias and dW in one pass), then A
                      over the row-sorted dual order for dX on F's dz (only
                      where the input needs a gradient).
* ``espmm_infer_T`` — one served layer: kernel A with its epilogue.
* ``espmm`` / ``espmm_custom`` — the reference's (batch, features) entries
                      with its ``impl`` values: ``custom`` is the
                      hand-derived backward (an autograd Function on A and
                      F), ``segment`` the chunked segment sum under
                      autograd, ``scatter`` gather/scatter-add, ``auto`` the
                      reference's ``SPMM_AUTO_*`` thresholds. Those choose
                      among plain versions on the CPU only: on the card
                      every impl runs the kernels.
* ``espmm_infer`` — the reference's forward-only (batch, features) entry.

Out-of-core shards (K8, ``repro_torch.xl``): ``xl_shard_acc`` is kernel A
over one connection shard's window of segments, accumulating in place into
the carried (d_max, B) buffer (forward and dX); ``xl_shard_dw`` is kernel F
over one shard, without its epilogue (dW).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sparsity import (
    SPMM_AUTO_ELEMS,
    SPMM_AUTO_NNZ,
    SPMM_INFER_ELEMS,
    SPMM_INFER_NNZ,
    BlockMeta,
    BlockTopoArrays,
    DwRuns,
    ElemTopoArrays,
    _coo_dw_cuda,
    coo_dw,
    coo_matmul_T,
    coo_route,
    dw_runs,
    element_spmm,
    element_spmm_segment,
    launch_coo_matmul_T,
    spmm_chunk_for,
)
from repro_torch.kernels import build
from repro_torch.kernels import block_sparse_matmul as _k
from repro_torch.kernels.all_relu_fused import all_relu_bwd, bias_all_relu, bias_all_relu_T

__all__ = [
    "XLWindow", "all_relu_T", "bsmm", "bsmm_infer", "bsmm_kernel", "bsmm_xla", "espmm",
    "espmm_custom",
    "espmm_infer", "espmm_infer_T", "espmm_train_T", "make_xl_shard_acc", "make_xl_shard_dw",
    "shard_runs", "shard_window", "window_offsets", "xl_shard_acc", "xl_shard_dw",
]


# ---------------------------------------------------------------------------
# Block path: kernels C, D, E behind one autograd Function
# ---------------------------------------------------------------------------


class _BsmmCore(torch.autograd.Function):
    """``y = x @ W`` on padded operands: x (B, padded_in) -> (B, padded_out).
    The topology and meta are not differentiable."""

    @staticmethod
    def forward(ctx, x, values, topo: BlockTopoArrays, meta: BlockMeta):
        ctx.save_for_backward(x, values)
        ctx.topo, ctx.meta = topo, meta
        return _k.bsmm_fwd(x, values, topo.rows, topo.cols, topo.first_col,
                           grid_n=meta.grid_n)

    @staticmethod
    def backward(ctx, dy):
        x, values = ctx.saved_tensors
        topo, meta = ctx.topo, ctx.meta
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:  # layer 0's input needs none: no kernel D
            dx = _k.bsmm_dx(dy, values, topo.rows_r, topo.cols_r, topo.first_row,
                            topo.perm_r, grid_m=meta.grid_m)
        if ctx.needs_input_grad[1]:
            dw = _k.bsmm_dw(x, dy, topo.rows, topo.cols,
                            block_m=meta.block_m, block_n=meta.block_n)
        return dx, dw, None, None


def _on_block_grid(x: torch.Tensor, meta: BlockMeta, launch) -> torch.Tensor:
    """``launch`` on x (..., in_dim) as a contiguous (B, padded_in) matrix,
    its features padded to the block grid, and its (B, padded_out) result
    sliced back to (..., out_dim). The batch needs no padding, since the
    kernels mask a ragged batch tile."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    pad_m = meta.padded_in - meta.in_dim
    if pad_m:
        x2 = F.pad(x2, (0, pad_m))
    y = launch(x2.contiguous())
    if meta.padded_out != meta.out_dim:  # a slice costs host time: only where padded
        y = y[:, : meta.out_dim]
    return y.reshape(*lead, meta.out_dim)


def bsmm_kernel(
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta
) -> torch.Tensor:
    """Block-sparse ``y = x @ W`` for x of shape (..., in_dim), on kernels
    C, D and E, f32 or bfloat16 (the training entry; ``bsmm_infer`` is the
    no-grad one). Twin of the reference's ``bsmm_pallas``: it pads the
    features to the block grid and slices the output."""
    return _on_block_grid(x, meta, lambda x2: _BsmmCore.apply(x2, values, topo, meta))


def bsmm_xla(
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta
) -> torch.Tensor:
    """Block-sparse ``y = x @ W`` as plain PyTorch: gather the x tiles,
    einsum with the live tiles, ``index_add`` into the output block-columns.
    Autograd differentiates it; FLOPs scale with the live tiles."""
    lead = x.shape[:-1]
    pad_m = meta.padded_in - meta.in_dim
    if pad_m:
        x = F.pad(x, (0, pad_m))
    xr = x.reshape(*lead, meta.grid_m, meta.block_m)
    xg = xr.index_select(-2, topo.rows.long())                  # (..., nb, bm)
    yb = torch.einsum("...nm,nmo->...no", xg, values)
    y = torch.zeros((*lead, meta.grid_n, meta.block_n), dtype=yb.dtype, device=x.device)
    y = y.index_add(-2, topo.cols.long(), yb)
    return y.reshape(*lead, meta.padded_out)[..., : meta.out_dim]


def bsmm(
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta,
    *, impl: str = "kernel",
) -> torch.Tensor:
    """``impl="kernel"``: kernels C, D, E (``bsmm_kernel``); ``impl="xla"``:
    the plain autograd path (``bsmm_xla``)."""
    if impl == "kernel":
        return bsmm_kernel(x, values, topo, meta)
    if impl == "xla":
        return bsmm_xla(x, values, topo, meta)
    raise ValueError(f"unknown impl {impl!r}")


def bsmm_infer(
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta, *,
    all_relu: Optional[Tuple[float, int]] = None,
) -> torch.Tensor:
    """Block-sparse ``y = x @ W`` for serving (``mlp_forward(infer=True)``,
    the LM's sparse FFN): kernel C called directly, with no autograd Function
    (pad the features, launch, slice), in x's dtype (f32, or bfloat16 for
    the LM). With
    ``all_relu=(alpha, layer_index)`` All-ReLU with that layer's slope
    follows: in kernel C's store in bfloat16, as kernel B after the f32
    instance, which has no epilogue."""
    in_store = all_relu if x.dtype == torch.bfloat16 else None
    with torch.no_grad():
        y = _on_block_grid(x, meta, lambda x2: _k.bsmm_fwd(
            x2, values, topo.rows, topo.cols, topo.first_col, grid_n=meta.grid_n,
            all_relu=in_store))
        if all_relu is not None and in_store is None:
            y = bias_all_relu(y, None, alpha=all_relu[0], layer_index=all_relu[1])
    return y


# ---------------------------------------------------------------------------
# Element path: kernels A and F behind one autograd Function
# ---------------------------------------------------------------------------
#
# The reference's hand-derived VJP (src/repro/kernels/ops.py::_espmm_core),
# in the (features, batch) layout it computes in. For yT = act(W^T hT + b):
#
#   fwd  zT[cols[j], :]  += hT[rows[j], :] * v[j], then + b and All-ReLU  A
#   act  dz = dy * (z > 0 ? 1 : slope), db = sum_b dz      F's epilogue (G)
#   dW   dv[j] = sum_b hT[rows[j], b] * dz[cols[j], b]                    F
#   dX   dhT[rows_r[j], :] += dz[cols_r[j], :] * v[perm_r[j]]             A
#
# Each pass sums in one fixed order and reads its segment offsets or run
# plan from the topology's registration (ElementTopology.device_arrays), so
# none syncs.


class _EspmmT(torch.autograd.Function):
    """``yT = epilogue(W^T hT)``: hT (in_dim, B) -> (out_dim, B). With no
    ``bias`` the product alone; with ``bias`` it is added; with ``slope``
    too, All-ReLU follows and the forward keeps its branch mask. The
    topology is not differentiable."""

    @staticmethod
    def forward(ctx, hT, values, bias, topo: ElemTopoArrays, out_dim: int,
                slope: Optional[float], chunk: Optional[int]):
        mask = None
        if slope is None:
            yT = coo_matmul_T(hT, values, topo.rows, topo.cols, out_dim, chunk=chunk, bias=bias)
        else:
            yT, mask = coo_matmul_T(hT, values, topo.rows, topo.cols, out_dim, chunk=chunk,
                                    bias=bias, slope=slope, with_mask=True)
        ctx.save_for_backward(hT, values, mask)
        ctx.topo, ctx.slope, ctx.chunk, ctx.has_bias = topo, slope, chunk, bias is not None
        return yT

    @staticmethod
    def backward(ctx, dyT):
        hT, values, mask = ctx.saved_tensors
        topo, chunk = ctx.topo, ctx.chunk
        dyT = dyT.contiguous()
        dz, dv, dbias = dyT, None, None
        if ctx.needs_input_grad[1]:  # F, with the epilogue's dz and dbias in its pass
            if ctx.has_bias:
                dv, dz, dbias = coo_dw(hT, dyT, topo.rows, topo.cols, chunk=chunk,
                                       with_dbias=True, mask=mask, slope=ctx.slope)
            else:
                dv = coo_dw(hT, dyT, topo.rows, topo.cols, chunk=chunk)
        elif ctx.has_bias:  # the epilogue alone
            dz, dbias = all_relu_bwd(dyT, mask, ctx.slope)
        dhT = None
        if ctx.needs_input_grad[0]:  # layer 0's input needs none: no dX pass
            dhT = coo_matmul_T(dz, values.index_select(0, topo.perm_r), topo.cols_r,
                               topo.rows_r, hT.shape[0], chunk=chunk)
        return dhT, dv, dbias, None, None, None, None


def espmm_train_T(
    hT: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    bias: torch.Tensor,
    slope: Optional[float] = None,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """One element training layer in the transposed layout: ``hT``
    (in_dim, B) -> (out_dim, B), ``h @ W + bias`` and, with ``slope``,
    All-ReLU, differentiable in ``hT``, ``values`` and ``bias``. The
    forward is kernel A with its epilogue in the store (and the branch
    mask); the backward is kernel F with its epilogue (dz and the bias's
    gradient beside dW), then kernel A over the row-sorted dual order for
    dX. CPU tensors take the plain versions."""
    return _EspmmT.apply(hT.contiguous(), values, bias, topo, out_dim, slope, chunk)


class _AllReluT(torch.autograd.Function):
    """All-ReLU alone on a (features, batch) pre-activation that already
    carries its bias: forward, kernel B's standalone pass with a zero bias,
    which keeps the branch mask; backward, kernel G's standalone pass (F's
    epilogue alone), whose dz is the gradient."""

    @staticmethod
    def forward(ctx, zT, slope: float):
        zero = torch.zeros(zT.shape[0], dtype=zT.dtype, device=zT.device)
        mask = torch.empty(zT.shape, dtype=torch.uint8, device=zT.device)
        yT, mask = bias_all_relu_T(zT, zero, slope, mask=mask)
        ctx.save_for_backward(mask)
        ctx.slope = slope
        return yT

    @staticmethod
    def backward(ctx, dyT):
        (mask,) = ctx.saved_tensors
        dz, _ = all_relu_bwd(dyT.contiguous(), mask, ctx.slope)
        return dz, None


def all_relu_T(zT: torch.Tensor, slope: float) -> torch.Tensor:
    """All-ReLU of ``zT`` (N, B) f32, a pre-activation with its bias in it:
    the element forward's activation where its pre-activations are kept
    (``mlp_forward(..., return_preacts=True)``), so kernel A stores z + bias
    and this pass the activation. Differentiable where autograd records
    (kernel B forward, kernel G backward); else kernel B alone. CPU tensors
    take the plain versions. ``where(v > 0, v, slope * v)`` of ``v = z +
    0``: kernel A's fused store computes the same bits."""
    zT = zT.contiguous()
    if torch.is_grad_enabled() and zT.requires_grad:
        return _AllReluT.apply(zT, slope)
    zero = torch.zeros(zT.shape[0], dtype=zT.dtype, device=zT.device)
    return bias_all_relu_T(zT, zero, slope)


def espmm_custom(
    x: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Element-sparse ``y = x @ W`` with the hand-derived backward: the
    product on kernel A, dX on kernel A over the dual order, dW on kernel F
    (their plain versions on the CPU). One transpose of the operand in and
    one of the result out, as the reference's ``_espmm_core``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    yT = _EspmmT.apply(x2.T.contiguous(), values, None, topo, out_dim, None, chunk)
    return yT.T.reshape(*lead, out_dim)


def espmm(
    x: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    impl: str = "auto",
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Element-sparse ``y = x @ W`` for COO topology arrays, differentiable.

    On the card every ``impl`` runs :func:`espmm_custom` (kernels A and F).
    On the CPU the impls are the reference's plain formulations: ``custom``
    the hand-derived backward, ``segment`` the chunked segment sum under
    autograd, ``scatter`` gather and scatter-add, and ``auto`` (default)
    ``scatter`` below the reference's ``SPMM_AUTO_*`` thresholds and
    ``custom`` above.
    """
    if impl not in ("auto", "custom", "segment", "scatter"):
        raise ValueError(f"unknown element impl {impl!r}")
    if x.device.type != "cpu":
        return espmm_custom(x, values, topo, out_dim, chunk=chunk)
    if impl == "auto":
        nnz = int(values.shape[0])
        batch = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        big = nnz >= SPMM_AUTO_NNZ or batch * nnz >= SPMM_AUTO_ELEMS
        impl = "custom" if big else "scatter"
    if impl == "custom":
        return espmm_custom(x, values, topo, out_dim, chunk=chunk)
    if impl == "segment":
        return element_spmm_segment(x, values, topo.rows, topo.cols, out_dim, chunk=chunk)
    return element_spmm(x, values, topo.rows, topo.cols, out_dim)


# ---------------------------------------------------------------------------
# Element path, forward only (serving)
# ---------------------------------------------------------------------------


def espmm_infer(
    x: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    chunk: Optional[int] = None,
    col_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Element-sparse ``y = x @ W``, inference dispatch.

    On the card every size goes through kernel A in the reference's
    (features, batch) layout. On the CPU the plain path keeps the reference's
    forward-only thresholds (``SPMM_INFER_*``): scatter-add for small
    problems, the chunked segment sum beyond.
    """
    if x.device.type == "cpu":
        nnz = int(values.shape[0])
        batch = int(np.prod(x.shape[:-1])) if x.dim() > 1 else 1
        if nnz < SPMM_INFER_NNZ and batch * nnz < SPMM_INFER_ELEMS:
            return element_spmm(x, values, topo.rows, topo.cols, out_dim)
    return element_spmm_segment(
        x, values, topo.rows, topo.cols, out_dim, chunk=chunk, col_ptr=col_ptr
    )


def espmm_infer_T(
    hT: torch.Tensor,
    values: torch.Tensor,
    topo: ElemTopoArrays,
    out_dim: int,
    *,
    bias: torch.Tensor,
    slope: Optional[float] = None,
    chunk: Optional[int] = None,
    col_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One served element layer in the transposed layout: ``hT`` (in_dim,
    B) -> (out_dim, B), ``(h @ W + bias)`` and, with ``slope``, All-ReLU,
    so that the result feeds the next layer as it is.

    A CUDA tensor runs kernel A with its epilogue (one launch, no
    transpose); a CPU tensor runs the plain version, the chunked segment
    sum (``chunk``) and the same epilogue. Unlike :func:`espmm_infer`, the
    reference's ``SPMM_INFER_*`` scatter-vs-segment thresholds do not
    apply: the serving loop takes this one path on both devices.
    """
    return coo_matmul_T(
        hT, values, topo.rows, topo.cols, out_dim, chunk=chunk, seg_ptr=col_ptr,
        bias=bias, slope=slope,
    )


# ---------------------------------------------------------------------------
# Out-of-core per-shard entries (repro_torch.xl, DESIGN.md §7): K8
# ---------------------------------------------------------------------------
#
# The XL substrate streams a layer's COO topology through the device as
# fixed-capacity connection shards (slices of a sorted order); these are the
# only two products its forward and backward run. The reference's are XLA
# programs (src/repro/kernels/ops.py:347 _xl_shard_acc_impl, :393
# _xl_shard_dw_impl); here they are kernels A and F:
#
# * a shard is a slice of a sorted order, so its segment ids cover one
#   contiguous window [lo, lo + n) of segments. Kernel A runs over that
#   window alone, on the rows acc[lo:lo + n] of the carried buffer, in
#   place: each chain starts at acc and keeps slot order, so shards streamed
#   in order give the same bits as one in-core call, a segment spanning two
#   shards included, and no launch touches the d_max - n rows outside the
#   window (64 MB a shard at d_max = 500,000 and B = 32);
# * the window's offsets (n + 1 int64, made on the host with the shard)
#   stand for its segment ids: kernel A walks them, and its route comes from
#   their longest segment, a host int, so no shard pays a device sync. A
#   padded tail past the shard's real slots is never read;
# * kernel F takes a run plan per shard, made on the host with it (the
#   window-local columns), and writes the shard's real extent of dv.


class XLWindow(NamedTuple):
    """One connection shard's window on the compute device: its real slots
    ``n_real`` fall in the segments ``[lo, lo + n)`` (host ints, with the
    longest segment, kernel A's route); ``seg_ptr`` (int64, at least
    ``n + 1`` entries, the first ``n + 1`` used) holds the slot offsets of
    those segments, from 0 to ``n_real``. A canonical shard's window also
    carries kernel F's slot runs (``runs``, int32 rows of (window column,
    first slot, slots), the first ``n_runs`` used)."""

    lo: int
    n: int
    n_real: int
    longest: int
    seg_ptr: torch.Tensor
    runs: Optional[torch.Tensor] = None
    n_runs: int = 0


def window_offsets(segment_idx: np.ndarray, out: np.ndarray) -> Tuple[int, int, int]:
    """The window of a shard's real, non-decreasing segment ids (trusted:
    a decrease is caught only where it leaves the window's span): writes
    its offsets into ``out[:n + 1]`` and returns ``(lo, n, longest)``."""
    if segment_idx.size == 0:
        raise ValueError("a shard has at least one slot")
    lo = int(segment_idx[0])
    n = int(segment_idx[-1]) - lo + 1
    if n > out.shape[0] - 1 or n <= 0:
        raise ValueError(f"segment ids [{lo}, {lo + n}) do not fit {out.shape[0]} offsets "
                         "(are they sorted?)")
    counts = np.bincount(segment_idx - lo, minlength=n)
    if counts.size != n:
        raise ValueError("segment ids must be non-decreasing")
    out[0] = 0
    np.cumsum(counts, out=out[1:n + 1])
    return lo, n, int(counts.max())


def shard_runs(rows: np.ndarray, seg_ptr: np.ndarray, out: np.ndarray) -> int:
    """Kernel F's slot runs of one canonical shard (``core.sparsity.
    dw_runs``, window-local columns) into ``out``; returns their count."""
    runs, n_runs = dw_runs(rows, seg_ptr)
    out[:n_runs] = runs[:n_runs]
    return n_runs


def shard_window(segment_idx: torch.Tensor, n_segments: int, *,
                 rows: Optional[torch.Tensor] = None) -> XLWindow:
    """The window of a padded shard given by its segment ids (the
    reference's operands: tail slots carry ``n_segments``), made on the host
    from them (one device sync for a CUDA tensor), with kernel F's runs
    where ``rows`` is given."""
    seg = segment_idx.cpu().numpy()
    real = seg[seg < n_segments]
    if real.size and (np.diff(real) < 0).any():
        raise ValueError("segment ids must be non-decreasing")
    offsets = np.empty(real.size + 1, np.int64)
    lo, n, longest = window_offsets(real, offsets)
    dev = segment_idx.device
    runs, n_runs = None, 0
    if rows is not None:
        plan = np.empty((max(real.size, 1), 3), np.int32)
        n_runs = shard_runs(rows.cpu().numpy()[:real.size], offsets[:n + 1], plan)
        runs = torch.from_numpy(plan[:n_runs]).to(dev)
    return XLWindow(lo, n, int(real.size), longest, torch.from_numpy(offsets[:n + 1]).to(dev),
                    runs, n_runs)


def _window_segments(window: XLWindow) -> torch.Tensor:
    """The shard's real slots' segment ids, from its window's offsets."""
    counts = window.seg_ptr[: window.n + 1].diff()
    ids = torch.arange(window.lo, window.lo + window.n, device=counts.device)
    return torch.repeat_interleave(ids, counts)


def _check_window(window: XLWindow, n_segments: int, capacity: int, device) -> None:
    if window.n_real > capacity or window.lo < 0 or window.lo + window.n > n_segments:
        raise ValueError(
            f"window [{window.lo}, {window.lo + window.n}) of {window.n_real} slots does not "
            f"fit {n_segments} segments and a capacity of {capacity}")
    build.check_tensor(window.seg_ptr[: window.n + 1], "seg_ptr", dtype=torch.int64,
                       shape=(window.n + 1,), device=device)


def xl_shard_acc(
    acc: torch.Tensor,
    srcT: torch.Tensor,
    values: torch.Tensor,
    gather_idx: torch.Tensor,
    segment_idx: Optional[torch.Tensor] = None,
    *,
    n_segments: int,
    chunk: Optional[int] = None,
    window: Optional[XLWindow] = None,
) -> torch.Tensor:
    """One connection shard's product, accumulated in place into the
    running ``(n_segments, B)`` buffer ``acc``, which it returns:

        acc[segment_idx[j], :] += srcT[gather_idx[j], :] * values[j]

    The one streamed product for both directions: forward shards pass the
    canonical order (gather ``rows``, segment ``cols``); dX shards the
    row-sorted dual order (gather ``cols_r``, segment ``rows_r``) with
    values gathered through ``perm_r`` on the host. ``values`` and
    ``gather_idx`` are the shard's buffers at capacity; the real slots come
    first. ``window`` (:class:`XLWindow`, made on the host with the shard)
    gives its segments; without it they come from ``segment_idx``, the
    reference's operand (non-decreasing, padded tail slots ``n_segments``),
    at the cost of a device sync for a CUDA tensor. A CUDA tensor launches
    kernel A over the window, in place; a CPU tensor takes the plain
    version (``index_add_`` in slot order, chunks of ``chunk``)."""
    if window is None:
        window = shard_window(segment_idx, n_segments)
        real = gather_idx[: window.n_real]
        if real.numel() and not bool((real.min() >= 0) & (real.max() < srcT.shape[0])):
            raise ValueError(f"gather_idx has indices outside [0, {srcT.shape[0]})")
    if acc.device.type == "cpu":
        return _xl_shard_acc_plain(acc, srcT, values, gather_idx, window, chunk)
    if acc.device.type != "cuda":
        raise ValueError(f"xl_shard_acc runs on cuda or cpu tensors, not {acc.device}")
    device, cap = acc.device, values.shape[0]
    batch = acc.shape[1]
    build.check_tensor(acc, "acc", dtype=torch.float32, shape=(n_segments, batch), device=device)
    build.check_tensor(srcT, "srcT", dtype=torch.float32, shape=(srcT.shape[0], batch),
                       device=device)
    build.check_tensor(values, "values", dtype=torch.float32, shape=(cap,), device=device)
    build.check_tensor(gather_idx, "gather_idx", dtype=torch.int32, shape=(cap,), device=device)
    _check_window(window, n_segments, cap, device)
    rows = acc[window.lo: window.lo + window.n]
    launch_coo_matmul_T(srcT, values, gather_idx, window.seg_ptr, rows, rows,
                        coo_route(window.longest))
    xl_shard_acc.launches += 1
    return acc


xl_shard_acc.launches = 0  # kernel A launches over a shard window


def _xl_shard_acc_plain(acc, srcT, values, gather_idx, window: XLWindow,
                        chunk: Optional[int]) -> torch.Tensor:
    """Plain version of :func:`xl_shard_acc`, on any device: the window's
    segment ids from its offsets, then ``index_add_`` into ``acc`` in chunks
    (in slot order on the CPU, as the in-core plain product adds)."""
    n_real = window.n_real
    seg = _window_segments(window)
    chunk = spmm_chunk_for(acc.shape[1], n_real, chunk)
    for lo in range(0, n_real, chunk):
        hi = min(lo + chunk, n_real)
        g = gather_idx[lo:hi].long()
        acc.index_add_(0, seg[lo:hi], srcT[g] * values[lo:hi, None])
    return acc


def make_xl_shard_acc(donate: Optional[bool] = None):
    """The reference's factory of its jitted shard product, whose ``donate``
    hands the accumulator's buffer to the result. In torch that is the
    in-place update: by default, or with ``donate=True``, the result is
    :func:`xl_shard_acc`, which accumulates into ``acc``; ``donate=False``
    gives one that leaves ``acc`` as it was and returns a new buffer."""
    if donate is None or donate:
        return xl_shard_acc

    def shard_acc(acc, *args, **kwargs):
        return xl_shard_acc(acc.clone(), *args, **kwargs)

    return shard_acc


def xl_shard_dw(
    xT: torch.Tensor,
    dyT: torch.Tensor,
    rows: torch.Tensor,
    cols: Optional[torch.Tensor] = None,
    *,
    chunk: Optional[int] = None,
    window: Optional[XLWindow] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One canonical shard's dW, ``dv[j] = sum_b xT[rows[j], b] *
    dyT[cols[j], b]``: each slot's batch contraction is independent, so
    sharding cannot change its sum (the bits of the in-core ``coo_dw``).
    ``rows`` is the shard's buffer at capacity; ``window`` (with its runs)
    gives its columns, else ``cols`` does, the reference's operand (padded
    tail slots ``dyT.shape[0]``; a device sync for a CUDA tensor). Writes
    the shard's real extent of ``out`` ((capacity,) f32; a new zeroed
    buffer without one) and returns it. A CUDA tensor launches kernel F's
    slot runs (no epilogue) on the window's rows of ``dyT``; a CPU tensor
    takes the plain version."""
    cap = rows.shape[0]
    if window is None:
        window = shard_window(cols, dyT.shape[0], rows=rows)
        real = rows[: window.n_real]
        if real.numel() and not bool((real.min() >= 0) & (real.max() < xT.shape[0])):
            raise ValueError(f"rows has indices outside [0, {xT.shape[0]})")
    if out is None:
        out = torch.zeros((cap,), dtype=torch.float32, device=xT.device)
    if xT.device.type == "cpu":
        return _xl_shard_dw_plain(xT, dyT, rows, window, chunk, out)
    if xT.device.type != "cuda":
        raise ValueError(f"xl_shard_dw runs on cuda or cpu tensors, not {xT.device}")
    device, batch = xT.device, xT.shape[1]
    build.check_tensor(xT, "xT", dtype=torch.float32, shape=(xT.shape[0], batch), device=device)
    build.check_tensor(dyT, "dyT", dtype=torch.float32, shape=(dyT.shape[0], batch),
                       device=device)
    build.check_tensor(rows, "rows", dtype=torch.int32, shape=(cap,), device=device)
    _check_window(window, dyT.shape[0], cap, device)
    if window.runs is None:
        raise ValueError("kernel F needs the window's run plan (XLWindow.runs)")
    runs = DwRuns(window.runs, window.n_runs, window.n)
    _, _, _, launched = _coo_dw_cuda(dyT[window.lo: window.lo + window.n], None, None, False,
                                     xT=xT, rows=rows, runs=runs, dv_out=out)
    if launched:
        coo_dw.launches += 1
        xl_shard_dw.launches += 1
    return out


xl_shard_dw.launches = 0  # kernel F launches over a shard


def _xl_shard_dw_plain(xT, dyT, rows, window: XLWindow, chunk: Optional[int],
                       out: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`xl_shard_dw`, on any device (the reference's
    chunked slabs, reduced over the batch)."""
    n_real = window.n_real
    cols = _window_segments(window)
    chunk = spmm_chunk_for(xT.shape[-1], n_real, chunk)
    for lo in range(0, n_real, chunk):
        hi = min(lo + chunk, n_real)
        out[lo:hi] = (xT[rows[lo:hi].long()] * dyT[cols[lo:hi]]).sum(-1)
    return out


def make_xl_shard_dw(donate: Optional[bool] = None):
    """The reference's factory of its jitted shard dW, which donates
    nothing (``donate`` exists for symmetry with :func:`make_xl_shard_acc`):
    :func:`xl_shard_dw`."""
    del donate
    return xl_shard_dw
