"""Rounding to a lower precision, for the controls: the reference computed
in the precision just below the one a configuration states.

``round_tf32`` rounds f32 to TF32's 10-bit mantissa (to nearest, ties to
even), as a tensor core reads an f32 operand under TF32. :func:`rounded`
rounds a product's
operand in the forward and the gradient that reaches it in the backward,
so both passes' products see the lower precision.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return r.view(torch.float32)


ROUNDERS = {"tf32": round_tf32}


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return ROUNDERS[kind](x)

    @staticmethod
    def backward(ctx, g):
        return ROUNDERS[ctx.kind](g), None


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's operand in ``precision`` (``"f32"``: as is)."""
    if precision == "f32":
        return x
    return _Rounded.apply(x, precision)
