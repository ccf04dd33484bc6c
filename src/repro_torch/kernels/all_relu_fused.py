"""Fused bias + All-ReLU epilogue: kernel B (``csrc/bias_all_relu.cu``).

``y = where(x + b > 0, x + b, s * (x + b))`` over (rows, N) with the bias
along N, ``s = -alpha`` for even ``layer_index`` and ``+alpha`` for odd
(paper Eq. 3). Twin of the Pallas kernel
``repro.kernels.all_relu_fused.bias_all_relu``; the Pallas version's
``block_rows`` padding is a TPU tiling concern and has no counterpart here.

As in the reference, it is the block product's epilogue: the block model's
no-grad forward runs it on kernel C's output, whose first ``out_dim``
columns of a block-padded row it reads in place (a row pitch, no copy). The
element paths apply the same arithmetic in kernel A's store
(``core.sparsity.coo_matmul_T``'s epilogue) instead. The bf16 entry (no
bias in the LM) keeps the reference's bf16 rounding at every step, so it is
bit-equal to the plain version; the bfloat16 LM's sparse FFN
(``models.layers.sparse_ffn_fwd``) runs the same arithmetic in kernel C's
store on W_in, bit for bit this entry after kernel C.

:func:`bias_all_relu_T` is its (features, batch) entry, with the bias along
the rows: the out-of-core stream (``xl/stream.py``) runs kernel A with no
epilogue over each connection shard of a layer and this pass after the
layer's last shard, in kernel A's store modes (the bias alone; then
All-ReLU; then also the branch mask), bit for bit A's fused store.

Its backward on the element training path is kernel G's work: the
gradient through All-ReLU from the branch mask kernel A's training epilogue
records, and the bias's gradient, the batch summed in one fixed order. The
training step runs it as kernel F's epilogue (``core.sparsity.coo_dw``,
``csrc/coo_dw.cu``), in the pass that reads the same dz row for dW;
:func:`all_relu_bwd` is its standalone call, kernel F's epilogue alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import sparsity
from repro_torch.device import takes_plain
from repro_torch.kernels import build
from repro_torch.kernels.ref import all_relu_ref, scalar_in, slope_for

__all__ = [
    "all_relu_bwd", "all_relu_bwd_plain", "bias_all_relu", "bias_all_relu_T",
    "bias_all_relu_T_plain", "bias_all_relu_plain",
]


def bias_all_relu_plain(
    x: torch.Tensor, bias: Optional[torch.Tensor], *, alpha: float, layer_index: int
) -> torch.Tensor:
    """Plain PyTorch version of kernel B, on any device. In bfloat16 each
    step rounds, as the reference's bf16 arithmetic does: ``x + bias``, the
    slope (``ref.scalar_in``) and the product."""
    return all_relu_ref(x if bias is None else x + bias, alpha, layer_index)


_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p,
]
_SYMBOLS = {torch.float32: "bias_all_relu_f32", torch.bfloat16: "bias_all_relu_bf16"}


def bias_all_relu(
    x: torch.Tensor, bias: Optional[torch.Tensor], *, alpha: float, layer_index: int
) -> torch.Tensor:
    """x: (..., N), bias: (N,) of x's dtype, or None for All-ReLU alone;
    returns a contiguous (..., N). A CUDA tensor launches kernel B (f32 or
    bfloat16; x's rows contiguous, at one row pitch, as a column slice of a
    wider contiguous tensor is) and raises for another dtype; a CPU tensor
    takes the plain version."""
    if takes_plain(x):
        return bias_all_relu_plain(x, bias, alpha=alpha, layer_index=layer_index)
    if x.device.type != "cuda":
        raise ValueError(f"bias_all_relu runs on cuda or cpu tensors, not {x.device}")
    if x.dim() == 0:
        raise ValueError("x must have a feature axis")
    n = x.shape[-1]
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"x has dtype {x.dtype}; kernel B takes {list(_SYMBOLS)}")
    if bias is not None:
        build.check_tensor(bias, "bias", dtype=x.dtype, shape=(n,), device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    pitch = _row_pitch(x)
    fn = build.kernel("bias_all_relu", _SYMBOLS[x.dtype], _ARGTYPES)
    rc = fn(
        x.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(), x.numel() // n,
        n, pitch, scalar_in(slope_for(alpha, layer_index), x.dtype),
        *build.stream_args(x.device),
    )
    build.check_launch(rc, "bias_all_relu kernel")
    bias_all_relu.launches += 1
    return y


bias_all_relu.launches = 0  # kernel B launches, so a run can show it went through the kernel
bias_all_relu.T_launches = 0  # of which by the (features, batch) entry, bias_all_relu_T


_T_ARGTYPES = [ctypes.c_void_p] * 4 + [
    ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def bias_all_relu_T_plain(
    xT: torch.Tensor, bias: torch.Tensor, slope: Optional[float], with_mask: bool = False
):
    """Plain PyTorch version of :func:`bias_all_relu_T`, on any device:
    ``v = xT + bias[:, None]``, then with ``slope`` ``where(v > 0, v, slope *
    v)`` (``core.sparsity.coo_epilogue``), and with ``with_mask`` also the
    uint8 mask of ``v > 0``."""
    y = sparsity.coo_epilogue(xT, bias, slope)
    if with_mask:
        return y, (xT + bias[:, None] > 0).to(torch.uint8)
    return y


def bias_all_relu_T(
    xT: torch.Tensor, bias: torch.Tensor, slope: Optional[float], *,
    out: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
):
    """Kernel B in the (features, batch) layout: ``xT`` (N, B) f32, ``bias``
    (N,) along the rows. ``v = xT + bias[:, None]``; with ``slope`` None the
    result is ``v`` (an output layer), else All-ReLU's ``where(v > 0, v,
    slope * v)``; with ``mask`` (uint8 (N, B), needs ``slope``) the branch
    ``v > 0`` is written into it as well. ``out`` ((N, B) f32; it may be
    ``xT`` itself, in place) receives the result, else a new tensor does.
    Returns ``out``, or ``(out, mask)`` with a mask. A CUDA tensor launches
    kernel B (``bias_act_T_f32``), the same arithmetic as kernel A's
    epilogue; a CPU, meta or fake tensor takes the plain version (written into ``out``
    and ``mask`` where they are given)."""
    if mask is not None and slope is None:
        raise ValueError("the mask is All-ReLU's branch: a mask needs the slope")
    if takes_plain(xT):
        res = bias_all_relu_T_plain(xT, bias, slope, with_mask=mask is not None)
        y, m = res if mask is not None else (res, None)
        if out is not None:
            out.copy_(y)
            y = out
        if mask is not None:
            mask.copy_(m)
            return y, mask
        return y
    if xT.device.type != "cuda":
        raise ValueError(f"bias_all_relu_T runs on cuda or cpu tensors, not {xT.device}")
    if xT.dim() != 2:
        raise ValueError(f"xT must be (N, B), got shape {tuple(xT.shape)}")
    device = xT.device
    build.check_tensor(xT, "xT", dtype=torch.float32, shape=xT.shape, device=device)
    build.check_tensor(bias, "bias", dtype=torch.float32, shape=(xT.shape[0],), device=device)
    if out is None:
        out = torch.empty_like(xT)
    build.check_tensor(out, "out", dtype=torch.float32, shape=xT.shape, device=device)
    if mask is not None:
        build.check_tensor(mask, "mask", dtype=torch.uint8, shape=xT.shape, device=device)
    mode = 1 if slope is None else 3 if mask is not None else 2
    if xT.numel():
        fn = build.kernel("bias_all_relu", "bias_act_T_f32", _T_ARGTYPES)
        rc = fn(xT.data_ptr(), bias.data_ptr(), out.data_ptr(),
                None if mask is None else mask.data_ptr(), xT.shape[0], xT.shape[1],
                0.0 if slope is None else slope, mode, *build.stream_args(device))
        build.check_launch(rc, "bias_act_T kernel")
        bias_all_relu.launches += 1
        bias_all_relu.T_launches += 1
    return (out, mask) if mask is not None else out


def _row_pitch(x: torch.Tensor) -> int:
    """Elements between the starts of x's rows of N, where they are
    contiguous and evenly spaced (a contiguous tensor, or a column slice of
    one); raise otherwise."""
    n = x.shape[-1]
    try:
        rows = x.view(-1, n)
    except RuntimeError:
        rows = None
    if rows is None or (n > 1 and rows.stride(1) != 1) or (
            rows.shape[0] > 1 and rows.stride(0) < n):
        raise ValueError(
            f"x must be contiguous, or rows of contiguous features at one pitch; "
            f"got shape {tuple(x.shape)} with strides {x.stride()}")
    return rows.stride(0) if rows.shape[0] > 1 else n


def all_relu_bwd_plain(
    dy: torch.Tensor, mask: Optional[torch.Tensor], slope: Optional[float]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel G, on any device: ``dz = where(mask,
    dy, slope * dy)`` (``dz = dy`` without a mask) and ``dbias = dz.sum(1)``
    for (N, B) tensors (:func:`repro_torch.core.sparsity.coo_dw_epilogue`)."""
    return sparsity.coo_dw_epilogue(dy, mask, slope)


def all_relu_bwd(
    dy: torch.Tensor, mask: Optional[torch.Tensor], slope: Optional[float], *,
    dz_out: Optional[torch.Tensor] = None, dbias_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of bias + All-ReLU in the (features, batch) layout:
    ``dy`` (N, B) f32, ``mask`` (N, B) uint8, 1 where the pre-activation was
    > 0 (``coo_matmul_T(..., with_mask=True)``), or None for a layer with
    the bias alone; returns ``(dz, dbias)``, dz (N, B) (``dy`` itself
    without a mask) and dbias (N,), written into ``dz_out`` (used only with
    a mask; not ``dy``) and ``dbias_out`` where they are given (the
    out-of-core stream's buffers). A CUDA tensor launches kernel F's
    epilogue alone (kernel G's work; the training step runs it inside
    :func:`repro_torch.core.sparsity.coo_dw`); a CPU, meta or fake tensor takes the plain
    version."""
    if takes_plain(dy):
        dz, dbias = all_relu_bwd_plain(dy, mask, slope)
        if dz_out is not None and mask is not None:
            dz = dz_out.copy_(dz)
        if dbias_out is not None:
            dbias = dbias_out.copy_(dbias)
        return dz, dbias
    if dy.device.type != "cuda":
        raise ValueError(f"all_relu_bwd runs on cuda or cpu tensors, not {dy.device}")
    _, dz, dbias, launched = sparsity._coo_dw_cuda(dy, mask, slope, True, dz_out=dz_out,
                                                   dbias_out=dbias_out)
    if launched:
        all_relu_bwd.launches += 1
    return dz, dbias


all_relu_bwd.launches = 0  # kernel G's standalone launches (kernel F's epilogue alone)
