"""The paper's SET-MLP: truly sparse multilayer perceptron (element path).

Layer l computes  h = act_l(h @ W_l + b_l)  where W_l is stored ONLY as its
live connections (``ElementTopology`` COO). The activation is All-ReLU with
the paper's 1-based hidden-layer parity; the output layer is linear.

PyTorch twin of ``repro.models.mlp`` for serving: the same config, the same
seeded topology and init (bit-equal), and the inference forward. On the card
a hidden layer is kernel A (``espmm_infer``) then kernel B (bias + All-ReLU);
on the CPU both are their plain versions. Training (``espmm`` with its
backward, dropout), the block/masked/dense impls and ``return_preacts`` come
with later slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.all_relu import activation_fn
from repro_torch.core.sparsity import ElementTopology
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.all_relu_fused import bias_all_relu

__all__ = ["SparseMLPConfig", "SparseMLP", "mlp_forward"]

DeviceLike = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class SparseMLPConfig:
    layer_dims: Tuple[int, ...]  # (in, h1, ..., hk, out)
    epsilon: float = 20.0
    activation: str = "all_relu"
    alpha: float = 0.6
    dropout: float = 0.3
    init: str = "he_uniform"
    impl: str = "element"  # element | block | masked | dense
    element_impl: str = "auto"
    spmm_chunk: Optional[int] = None
    block_m: int = 128
    block_n: int = 128
    dtype: str = "float32"

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1


def _require_element(config: SparseMLPConfig) -> None:
    if config.impl != "element":
        raise NotImplementedError(
            f"impl={config.impl!r}: the port serves the element (COO) path; "
            "the block, masked and dense impls come with later slices"
        )


def _on(a, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``; numpy input is copied (it may be read-only)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.array(a)).to(device)


class SparseMLP:
    """Model container: topologies (host numpy) + parameters (on ``device``).

    ``device=None`` means the card; without one it raises (pass
    ``device="cpu"`` for the plain versions)."""

    def __init__(self, config: SparseMLPConfig, seed: int = 0, device: DeviceLike = None):
        _require_element(config)
        self.config = config
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        dtype = getattr(torch, config.dtype)
        self.topos: List[ElementTopology] = []
        self.values: List[torch.Tensor] = []
        self.biases: List[torch.Tensor] = []
        for l in range(config.n_layers):
            n_in, n_out = config.layer_dims[l], config.layer_dims[l + 1]
            topo = ElementTopology.erdos_renyi(n_in, n_out, config.epsilon, rng)
            self.topos.append(topo)
            self.values.append(topo.init_values(
                rng, dtype=dtype, scheme=config.init, device=self.device
            ))
            self.biases.append(torch.zeros((n_out,), dtype=dtype, device=self.device))

    @classmethod
    def from_state(
        cls,
        config: SparseMLPConfig,
        topos: Sequence[ElementTopology],
        values: Sequence,
        biases: Sequence,
        device: DeviceLike = None,
    ) -> "SparseMLP":
        """Rebuild a model from explicit state (numpy arrays or tensors) —
        deployment-time compaction and interop construct models whose
        topologies are not the seeded Erdős–Rényi draw."""
        _require_element(config)
        if not len(topos) == len(values) == len(biases) == config.n_layers:
            raise ValueError(
                f"expected {config.n_layers} layers of topology, values and "
                f"biases, got {len(topos)}, {len(values)}, {len(biases)}"
            )
        model = cls.__new__(cls)
        model.config = config
        model.device = resolve_device(device)
        model.topos = list(topos)
        model.values = [_on(v, model.device) for v in values]
        model.biases = [_on(b, model.device) for b in biases]
        return model

    # -- views for the forward ---------------------------------------------

    def params(self):
        return {"values": tuple(self.values), "biases": tuple(self.biases)}

    def topo_arrays(self):
        return tuple(t.device_arrays(self.device) for t in self.topos)

    @property
    def n_params(self) -> int:
        return sum(int(b.numel()) for b in self.biases) + sum(t.nnz for t in self.topos)


def mlp_forward(
    params,
    topo_arrays,
    x: torch.Tensor,
    config: SparseMLPConfig,
    *,
    train: bool = False,
    rng=None,
    infer: bool = False,
    return_preacts: bool = False,
    col_ptrs: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Forward; returns logits. ``infer=True`` is the serving entry, the
    only one this slice has.

    ``col_ptrs`` (per layer, int64 (out_dim + 1,)) are the column offsets
    kernel A walks; the serving engine computes them once when it freezes
    the topology, and they are computed per call when not given.
    """
    _require_element(config)
    if not infer:
        raise NotImplementedError(
            "the training forward (espmm with its backward) comes with the "
            "training slice; pass infer=True"
        )
    if train and config.dropout > 0:
        raise NotImplementedError("dropout comes with the training slice")
    if return_preacts:
        raise NotImplementedError("return_preacts comes with the probes slice")
    if x.shape[-1] != config.layer_dims[0]:
        raise ValueError(f"x has {x.shape[-1]} features, the model takes {config.layer_dims[0]}")
    act = activation_fn(config.activation, alpha=config.alpha)
    h = x
    n_layers = config.n_layers
    for l in range(n_layers):
        bias = params["biases"][l]
        h = kops.espmm_infer(
            h, params["values"][l], topo_arrays[l], config.layer_dims[l + 1],
            chunk=config.spmm_chunk,
            col_ptr=None if col_ptrs is None else col_ptrs[l],
        )
        if l == n_layers - 1:  # output layer: linear
            h = h + bias
        elif config.activation == "all_relu":  # paper's 1-based layer parity
            h = bias_all_relu(h, bias, alpha=config.alpha, layer_index=l + 1)
        else:
            h = act(h + bias, l + 1)
    return h
