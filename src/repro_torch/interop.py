"""Hand a JAX-package ``SparseMLP`` (and its optimizer state) over to the port.

The port never imports the JAX package, so the state crosses as numpy
arrays and a plain dict of config fields (``dataclasses.asdict`` of the
reference config). Both packages then compute the same function, which is
what the parity tests hold them to.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparsity import BlockMeta, BlockTopology, ElementTopology
from repro_torch.device import resolve_device
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
from repro_torch.optim.sgd import SGDState

__all__ = ["mlp_from_numpy", "sgd_state_from_numpy"]


def mlp_from_numpy(
    config_fields: Mapping,
    topos_np: Sequence[Tuple[np.ndarray, np.ndarray]],
    values_np: Sequence[np.ndarray],
    biases_np: Sequence[np.ndarray],
    device: Optional[Union[str, torch.device]] = None,
) -> SparseMLP:
    """Build the port's ``SparseMLP`` from a reference model's state:
    ``topos_np`` holds each layer's ``(rows, cols)`` — connections for an
    element model, block coordinates for a block model, whose values are
    then ``(n_blocks, block_m, block_n)``; ``device=None`` means the card."""
    fields = dict(config_fields)
    fields["layer_dims"] = tuple(fields["layer_dims"])
    config = SparseMLPConfig(**fields)
    dims = config.layer_dims
    if config.impl == "block":
        topos = [
            BlockTopology(BlockMeta(dims[l], dims[l + 1], config.block_m, config.block_n),
                          rows, cols)
            for l, (rows, cols) in enumerate(topos_np)
        ]
    else:
        topos = [
            ElementTopology(dims[l], dims[l + 1], rows, cols)
            for l, (rows, cols) in enumerate(topos_np)
        ]
    return SparseMLP.from_state(
        config, topos, [np.asarray(v) for v in values_np],
        [np.asarray(b) for b in biases_np], device=device,
    )


def sgd_state_from_numpy(
    velocity_np: Mapping[str, Sequence[np.ndarray]],
    step: int,
    device: Optional[Union[str, torch.device]] = None,
) -> SGDState:
    """The port's ``SGDState`` from a reference ``SGDState``'s velocity
    (``{"values": [...], "biases": [...]}`` as numpy) and step count."""
    device = resolve_device(device)
    velocity = {
        k: tuple(torch.from_numpy(np.array(v, np.float32)).to(device) for v in vs)
        for k, vs in velocity_np.items()
    }
    return SGDState(velocity=velocity,
                    step=torch.tensor(int(step), dtype=torch.int32, device=device))
