"""Hand a JAX-package ``SparseMLP`` (and its optimizer state), ``PatternLM``
or ``WhisperModel`` over to the port.

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
from repro_torch.models.transformer import ModelConfig, PatternLM
from repro_torch.models.whisper import WhisperConfig, WhisperModel
from repro_torch.optim.sgd import SGDState
from repro_torch.tree import tree_map

__all__ = ["lm_from_numpy", "mlp_from_numpy", "sgd_state_from_numpy", "tensor_from_numpy",
           "whisper_from_numpy"]


def mlp_from_numpy(
    config_fields: Mapping,
    topos_np: Sequence[Tuple[np.ndarray, np.ndarray]],
    values_np: Sequence[np.ndarray],
    biases_np: Sequence[np.ndarray],
    device: Optional[Union[str, torch.device]] = None,
) -> SparseMLP:
    """Build the port's ``SparseMLP`` from a reference model's state:
    ``topos_np`` holds each layer's ``(rows, cols)`` — connections for an
    element or a masked model (the mask's), block coordinates for a block
    model, whose values are then ``(n_blocks, block_m, block_n)``, ``None``
    for a dense model; a masked or dense model's values are the dense
    ``(in_dim, out_dim)`` matrices. ``device=None`` means the card."""
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
    elif config.impl == "dense":
        topos = [None] * len(topos_np)
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


def tensor_from_numpy(a: np.ndarray, device: Optional[Union[str, torch.device]] = None
                      ) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, a bfloat16 array (ml_dtypes'
    ``bfloat16``, which is what ``np.asarray`` of a JAX bf16 array gives) as
    ``torch.bfloat16`` with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve_device(device))


def lm_from_numpy(
    config_fields: Mapping,
    params_np,
    topologies_np: Mapping[str, Sequence[Tuple[Tuple[np.ndarray, np.ndarray],
                                               Tuple[np.ndarray, np.ndarray]]]],
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> PatternLM:
    """Build the port's ``PatternLM`` from a reference model's state:
    ``config_fields`` is ``dataclasses.asdict`` of its ``ModelConfig``,
    ``params_np`` its parameter tree as numpy (``params["rest"]`` a list),
    and ``topologies_np`` maps each sparse slot (``s{i}_{kind}``,
    ``rest{i}``) to one ``((rows_in, cols_in), (rows_out, cols_out))`` per
    repeat. Both packages then compute the same function."""
    fields = dict(config_fields)
    fields["pattern"] = tuple(fields["pattern"])
    model = PatternLM(ModelConfig(**fields), seed=seed, device=device)
    model.params = tree_map(lambda a: tensor_from_numpy(a, model.device), params_np)
    for slot, reps in topologies_np.items():
        t_in, t_out = model.topologies[slot][0]
        model.topologies[slot] = [
            (BlockTopology(t_in.meta, *rc_in), BlockTopology(t_out.meta, *rc_out))
            for rc_in, rc_out in reps
        ]
    return model


def whisper_from_numpy(
    config_fields: Mapping,
    params_np,
    device: Optional[Union[str, torch.device]] = None,
) -> WhisperModel:
    """Build the port's ``WhisperModel`` from a reference model's state:
    ``config_fields`` is ``dataclasses.asdict`` of its ``WhisperConfig`` and
    ``params_np`` its parameter tree as numpy (the stacked ``enc``/``dec``
    trees, the final layernorms and both embeddings). Both packages then
    compute the same function."""
    cfg = WhisperConfig(**dict(config_fields))
    device = resolve_device(device)
    model = WhisperModel.__new__(WhisperModel)
    model.cfg, model._seed, model.device = cfg, 0, device
    model.params = tree_map(lambda a: tensor_from_numpy(a, device), params_np)
    return model
