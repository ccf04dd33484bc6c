"""Public ops for sparse linear layers.

Block granularity — two implementations of the same math on the same
topology arrays:

* ``bsmm_kernel`` — kernels C, D and E (``kernels/block_sparse_matmul.py``)
                    joined by a ``torch.autograd.Function``: the forward is
                    kernel C, the backward kernel D (only where dx is
                    needed) and kernel E. On CPU tensors each runs its plain
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
"""
from __future__ import annotations

from typing import Optional

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
    ElemTopoArrays,
    coo_dw,
    coo_matmul_T,
    element_spmm,
    element_spmm_segment,
)
from repro_torch.kernels import block_sparse_matmul as _k
from repro_torch.kernels.all_relu_fused import all_relu_bwd

__all__ = [
    "bsmm", "bsmm_infer", "bsmm_kernel", "bsmm_xla", "espmm", "espmm_custom", "espmm_infer",
    "espmm_infer_T", "espmm_train_T",
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


def bsmm_kernel(
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta
) -> torch.Tensor:
    """Block-sparse ``y = x @ W`` for x of shape (..., in_dim), on kernels
    C, D and E. Twin of the reference's ``bsmm_pallas``: it pads the
    features to the block grid and slices the output; the batch needs no
    padding, since the kernels mask a ragged batch tile."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    pad_m = meta.padded_in - meta.in_dim
    if pad_m:
        x2 = F.pad(x2, (0, pad_m))
    y = _BsmmCore.apply(x2.contiguous(), values, topo, meta)
    return y[:, : meta.out_dim].reshape(*lead, meta.out_dim)


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
    x: torch.Tensor, values: torch.Tensor, topo: BlockTopoArrays, meta: BlockMeta
) -> torch.Tensor:
    """Block-sparse ``y = x @ W`` for serving (``mlp_forward(infer=True)``):
    kernel C alone, with autograd off."""
    with torch.no_grad():
        return bsmm_kernel(x, values, topo, meta)


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
