"""Plain PyTorch oracles for the kernels. The block oracles come with the
block slice."""
from __future__ import annotations

import torch


def slope_for(alpha: float, layer_index: int) -> float:
    """Negative-side slope of All-ReLU for the paper's 1-based layer parity:
    -alpha for even layers, +alpha for odd."""
    return -alpha if layer_index % 2 == 0 else alpha


def all_relu_ref(x: torch.Tensor, alpha: float, layer_index: int) -> torch.Tensor:
    """Eq. (3): ``where(x > 0, x, slope * x)``."""
    return torch.where(x > 0, x, slope_for(alpha, layer_index) * x)
