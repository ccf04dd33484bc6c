"""All-ReLU (Alternated Left ReLU), paper Eq. (3), plus baselines.

For hidden layer l (1-indexed over hidden layers; input/output layers are
excluded per the paper):

    f_l(x) = -alpha * x   if x <= 0 and l % 2 == 0
           = +alpha * x   if x <= 0 and l % 2 == 1
           =  x           if x >  0

The serving forward fuses it with the bias in kernel B
(``kernels.all_relu_fused.bias_all_relu``); these are the plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import all_relu_ref

__all__ = ["all_relu", "srelu", "activation_fn"]


def all_relu(x: torch.Tensor, alpha: float, layer_index: int) -> torch.Tensor:
    """layer_index follows the paper's 1-based hidden-layer numbering."""
    return all_relu_ref(x, alpha, layer_index)


def srelu(x: torch.Tensor, t_r, a_r, t_l, a_l) -> torch.Tensor:
    """SReLU (Jin et al., 2016) baseline with per-neuron learned params."""
    above = x >= t_r
    below = x <= t_l
    mid = torch.logical_and(~above, ~below)
    return (
        above * (t_r + a_r * (x - t_r))
        + mid * x
        + below * (t_l + a_l * (x - t_l))
    )


def activation_fn(name: str, *, alpha: float = 0.6):
    """Activation factory; the returned fn takes (x, layer_index).

    ``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default is."""
    name = name.lower()
    if name == "all_relu":
        return lambda x, layer_index: all_relu(x, alpha, layer_index)
    if name == "relu":
        return lambda x, layer_index: F.relu(x)
    if name == "leaky_relu":
        return lambda x, layer_index: F.leaky_relu(x, negative_slope=alpha)
    if name == "silu":
        return lambda x, layer_index: F.silu(x)
    if name in ("gelu", "gelu_tanh"):
        return lambda x, layer_index: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")
