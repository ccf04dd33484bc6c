"""Hand a JAX-package ``SparseMLP`` over to the port.

The port never imports the JAX package, so the state crosses as numpy
arrays and a plain dict of config fields (``dataclasses.asdict`` of the
reference config). Both packages then compute the same function, which is
what the parity tests hold them to.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparsity import ElementTopology
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig

__all__ = ["mlp_from_numpy"]


def mlp_from_numpy(
    config_fields: Mapping,
    topos_np: Sequence[Tuple[np.ndarray, np.ndarray]],
    values_np: Sequence[np.ndarray],
    biases_np: Sequence[np.ndarray],
    device: Optional[Union[str, torch.device]] = None,
) -> SparseMLP:
    """Build the port's ``SparseMLP`` from a reference model's state:
    ``topos_np`` holds each layer's ``(rows, cols)``; ``device=None`` means
    the card."""
    fields = dict(config_fields)
    fields["layer_dims"] = tuple(fields["layer_dims"])
    config = SparseMLPConfig(**fields)
    dims = config.layer_dims
    topos = [
        ElementTopology(dims[l], dims[l + 1], rows, cols)
        for l, (rows, cols) in enumerate(topos_np)
    ]
    return SparseMLP.from_state(
        config, topos, [np.asarray(v) for v in values_np],
        [np.asarray(b) for b in biases_np], device=device,
    )
