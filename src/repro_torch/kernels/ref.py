"""Plain PyTorch oracles for the kernels: densify-then-matmul for the block
products (kernels C, D, E), and All-ReLU (kernel B). Twins of
``repro.kernels.ref``."""
from __future__ import annotations

import functools

import torch


def blocks_to_dense(
    values: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, grid_m: int, grid_n: int
) -> torch.Tensor:
    """Scatter (nb, bm, bn) blocks into the dense padded matrix."""
    _, bm, bn = values.shape
    dense = torch.zeros((grid_m, bm, grid_n, bn), dtype=values.dtype, device=values.device)
    dense[rows.long(), :, cols.long(), :] = values
    return dense.reshape(grid_m * bm, grid_n * bn)


def bsmm_ref(x, values, rows, cols, *, grid_m: int, grid_n: int) -> torch.Tensor:
    """y = x @ dense(W).   x: (B, grid_m*bm) -> (B, grid_n*bn)."""
    return x @ blocks_to_dense(values, rows, cols, grid_m, grid_n).to(x.dtype)


def bsmm_dx_ref(dy, values, rows, cols, *, grid_m: int, grid_n: int) -> torch.Tensor:
    """dX = dY @ W^T."""
    return dy @ blocks_to_dense(values, rows, cols, grid_m, grid_n).T.to(dy.dtype)


def bsmm_dw_ref(x, dy, rows, cols, *, block_m: int, block_n: int) -> torch.Tensor:
    """dW_blocks[i] = x_tile(rows[i])^T @ dy_tile(cols[i])."""
    B = x.shape[0]
    xg = x.reshape(B, -1, block_m)[:, rows.long()]     # (B, nb, bm)
    dyg = dy.reshape(B, -1, block_n)[:, cols.long()]   # (B, nb, bn)
    return torch.einsum("bnm,bno->nmo", xg, dyg)


def slope_for(alpha: float, layer_index: int) -> float:
    """Negative-side slope of All-ReLU for the paper's 1-based layer parity:
    -alpha for even layers, +alpha for odd."""
    return -alpha if layer_index % 2 == 0 else alpha


@functools.lru_cache(maxsize=256)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float. JAX rounds a Python
    scalar to a bfloat16 operand's type before it multiplies; PyTorch
    multiplies a bfloat16 tensor by a Python float in f32 and rounds only the
    product. Multiplying by the rounded scalar gives JAX's bits, since the
    product of two bfloat16 values is exact in f32. An f32 scalar is unchanged
    by this."""
    return torch.tensor(value, dtype=dtype).item()


def all_relu_ref(x: torch.Tensor, alpha: float, layer_index: int) -> torch.Tensor:
    """Eq. (3): ``where(x > 0, x, slope * x)``, the slope rounded to
    ``x.dtype`` first (:func:`scalar_in`), as the reference's bfloat16 LM
    rounds it."""
    return torch.where(x > 0, x, scalar_in(slope_for(alpha, layer_index), x.dtype) * x)
