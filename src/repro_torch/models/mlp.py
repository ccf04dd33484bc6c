"""The paper's SET-MLP: truly sparse multilayer perceptron.

Layer l computes  h = act_l(h @ W_l + b_l)  where W_l is stored ONLY as its
live connections (``ElementTopology`` COO, the paper-faithful path) or as
live tiles (``BlockTopology``). The activation is All-ReLU with the paper's
1-based hidden-layer parity; the output layer is linear.

PyTorch twin of ``repro.models.mlp``: the same config, the same seeded
topology and init (bit-equal). What each impl runs:

* ``element`` — training and inference: the activations stay in kernel
  A's (features, batch) layout from the input's one transpose to the
  logits' one, and each layer is one launch of kernel A whose store adds
  the bias and, on a hidden All-ReLU layer, applies All-ReLU (kernel B's
  arithmetic): ``espmm_infer_T`` where no gradient is recorded,
  ``espmm_train_T`` under autograd, which also records All-ReLU's branch
  and runs its backward on kernels G, A (dX) and F; dropout draws from an
  explicit ``torch.Generator``.
* ``block`` — training and inference: the block product on kernels C (and,
  under autograd, D and E), then ``+ bias`` and the activation; where no
  gradient is recorded, a hidden All-ReLU layer's bias and All-ReLU run in
  kernel B, as the reference's fused epilogue; dropout draws from an
  explicit ``torch.Generator``.
* ``masked`` and ``dense`` — the paper's baselines, which simulate sparsity
  with a binary mask (``h @ (W * mask)``) or have none (``h @ W``): W is the
  dense (in_dim, out_dim) matrix, the product ``torch.matmul`` in IEEE f32
  (the reference computes it outside any Pallas kernel too), and bias,
  activation and dropout follow the block path, kernel B included. Under
  autograd the masked gradient is ``(h^T dy) * mask``: zero off the mask.

``return_preacts`` comes with a later slice and raises
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.all_relu import activation_fn
from repro_torch.core.sparsity import BlockMeta, BlockTopology, ElementTopology, _init_numpy
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.all_relu_fused import bias_all_relu
from repro_torch.kernels.ref import slope_for

__all__ = ["SparseMLPConfig", "SparseMLP", "mlp_forward", "cross_entropy_loss"]

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


IMPLS = ("element", "block", "masked", "dense")
SPARSE_IMPLS = ("element", "block")  # the impls whose topology SET and pruning change


def _check_impl(config: SparseMLPConfig) -> None:
    if config.impl not in IMPLS:
        raise ValueError(f"impl={config.impl!r}; the impls are {IMPLS}")


def block_meta(config: SparseMLPConfig, layer: int) -> BlockMeta:
    """The block grid of a block model's ``layer``."""
    return BlockMeta(config.layer_dims[layer], config.layer_dims[layer + 1],
                     config.block_m, config.block_n)


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
        _check_impl(config)
        self.config = config
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        dtype = getattr(torch, config.dtype)
        self.topos: List[Optional[Union[ElementTopology, BlockTopology]]] = []
        self.values: List[torch.Tensor] = []
        self.biases: List[torch.Tensor] = []
        for l in range(config.n_layers):
            n_in, n_out = config.layer_dims[l], config.layer_dims[l + 1]
            if config.impl in ("masked", "dense"):
                # the reference's draws in its order: the masked model's ER
                # topology, then the dense matrix at the dense fan-in
                topo = (ElementTopology.erdos_renyi(n_in, n_out, config.epsilon, rng)
                        if config.impl == "masked" else None)
                w = _init_numpy(rng, (n_in, n_out), fan_in_dense=n_in, scheme=config.init)
                vals = torch.as_tensor(w, device=self.device).to(dtype)
            else:
                if config.impl == "element":
                    topo = ElementTopology.erdos_renyi(n_in, n_out, config.epsilon, rng)
                else:
                    topo = BlockTopology.from_epsilon(block_meta(config, l), config.epsilon, rng)
                vals = topo.init_values(rng, dtype=dtype, scheme=config.init, device=self.device)
            self.topos.append(topo)
            self.values.append(vals)
            self.biases.append(torch.zeros((n_out,), dtype=dtype, device=self.device))

    @classmethod
    def from_state(
        cls,
        config: SparseMLPConfig,
        topos: Sequence[Union[ElementTopology, BlockTopology]],
        values: Sequence,
        biases: Sequence,
        device: DeviceLike = None,
    ) -> "SparseMLP":
        """Rebuild a model from explicit state (numpy arrays or tensors) —
        deployment-time compaction and interop construct models whose
        topologies are not the seeded Erdős–Rényi draw. A masked model's
        topologies are its masks' connections, a dense model's are ``None``."""
        _check_impl(config)
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
        """Per layer what the forward reads besides the parameters: the
        device arrays of an element or block topology; a masked layer's 0/1
        mask, dense (in_dim, out_dim) in the config's dtype, made on the
        device; ``None`` for a dense layer."""
        impl = self.config.impl
        if impl == "dense":
            return tuple(None for _ in self.topos)
        if impl == "masked":
            dtype = getattr(torch, self.config.dtype)
            return tuple(t.to_dense(torch.ones(t.nnz, dtype=dtype, device=self.device))
                         for t in self.topos)
        return tuple(t.device_arrays(self.device) for t in self.topos)

    def set_params(self, params) -> None:
        self.values = list(params["values"])
        self.biases = list(params["biases"])

    @property
    def n_params(self) -> int:
        """Biases plus live connections, as the reference counts them: an
        element or masked layer its connections; a block layer its nonzero
        values, the padded margin of its tiles included; a dense layer every
        weight."""
        total = sum(int(b.numel()) for b in self.biases)
        impl = self.config.impl
        if impl in ("element", "masked"):
            return total + sum(t.nnz for t in self.topos)
        if impl == "dense":
            return total + sum(int(v.numel()) for v in self.values)
        return total + sum(int(torch.count_nonzero(v)) for v in self.values)


def mlp_forward(
    params,
    topo_arrays,
    x: torch.Tensor,
    config: SparseMLPConfig,
    *,
    train: bool = False,
    rng: Optional[torch.Generator] = None,
    infer: bool = False,
    return_preacts: bool = False,
) -> torch.Tensor:
    """Forward; returns logits.

    ``infer=True`` is the serving entry. ``infer=False`` (training and
    evaluation) is differentiable: an element model through kernels A, F
    and G, a block model through C, D and E, a masked or dense model through
    ``torch.matmul``. ``train=True`` applies dropout
    after each hidden layer, drawn from ``rng``, a ``torch.Generator`` on
    the input's device.

    On the element path kernel A walks the segment offsets that
    ``ElementTopology.device_arrays`` registered to ``topo_arrays`` (made
    once per topology: the engine freezes them, the trainer makes them after
    each topology phase).

    The element forward runs in the (features, batch) layout, as the
    reference's ``_espmm_core`` computes: the input is transposed once,
    each layer's output feeds the next, and the logits are transposed once.
    A hidden All-ReLU layer takes its bias and All-ReLU (the paper's 1-based
    parity) in kernel A's store, the output layer its bias; another
    activation (elementwise) follows a bias-only epilogue in the same
    layout. Where no gradient is recorded (``infer=True``, or autograd off,
    as in evaluation) it is the served forward, ``espmm_infer_T``; else
    ``espmm_train_T``.
    """
    _check_impl(config)
    if x.shape[-1] != config.layer_dims[0]:
        raise ValueError(f"x has {x.shape[-1]} features, the model takes {config.layer_dims[0]}")
    if config.impl != "element":
        return _batch_major_forward(params, topo_arrays, x, config, train=train, rng=rng,
                                    infer=infer, return_preacts=return_preacts)
    act = activation_fn(config.activation, alpha=config.alpha)
    dropout = _dropout_fn(config, train, rng)
    served = infer or not torch.is_grad_enabled()
    lead = x.shape[:-1]
    hT = x.reshape(-1, x.shape[-1]).T.contiguous()  # (features, batch)
    n_layers = config.n_layers
    preacts = []
    for l in range(n_layers):
        hidden = l < n_layers - 1  # the output layer is linear
        fused = hidden and config.activation == "all_relu"
        slope = slope_for(config.alpha, l + 1) if fused else None  # 1-based parity
        vals, topo, bias = params["values"][l], topo_arrays[l], params["biases"][l]
        # keeping z + bias: kernel A stores it, the All-ReLU runs after
        store_slope = None if return_preacts else slope
        if served:
            hT = kops.espmm_infer_T(
                hT, vals, topo, config.layer_dims[l + 1], bias=bias, slope=store_slope,
                chunk=config.spmm_chunk,
            )
        else:
            hT = kops.espmm_train_T(hT, vals, topo, config.layer_dims[l + 1], bias=bias,
                                    slope=store_slope, chunk=config.spmm_chunk)
        if return_preacts:
            preacts.append(hT.T.reshape(*lead, config.layer_dims[l + 1]))
            if fused:
                hT = kops.all_relu_T(hT, slope)
        if hidden and not fused:
            hT = act(hT, l + 1)
        if hidden and dropout is not None:
            hT = dropout(hT)
    logits = hT.T.contiguous().reshape(*lead, config.layer_dims[-1])
    return (logits, preacts) if return_preacts else logits


def _dropout_fn(config: SparseMLPConfig, train: bool, rng: Optional[torch.Generator]):
    """Inverted dropout at ``config.dropout``, its keep mask drawn from
    ``rng``, where training asks for it; else None."""
    if not (train and config.dropout > 0):
        return None
    if rng is None:
        raise ValueError("dropout needs rng, a torch.Generator on the input's device")
    keep = 1.0 - config.dropout

    def dropout(h: torch.Tensor) -> torch.Tensor:
        mask = torch.rand(h.shape, generator=rng, device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))

    return dropout


def _layer_product(config: SparseMLPConfig, infer: bool):
    """``product(h, values, topo, layer) -> h @ W`` of a batch-major impl:
    the block product (kernel C, and under autograd D and E), or
    ``torch.matmul`` with the masked or the dense W."""
    if config.impl == "block":
        block = kops.bsmm_infer if infer else kops.bsmm_kernel
        return lambda h, v, topo, l: block(h, v, topo, block_meta(config, l))
    if config.impl == "masked":
        return lambda h, v, mask, l: torch.matmul(h, v * mask)
    return lambda h, v, _, l: torch.matmul(h, v)


def _batch_major_forward(params, topo_arrays, x, config, *, train, rng, infer,
                         return_preacts=False):
    """Block, masked and dense layers as the reference runs them: the
    layer's product, ``+ bias``, then the activation under autograd, and
    dropout in training. Where no gradient is recorded (``infer=True``, or
    autograd off, as in evaluation), a hidden All-ReLU layer's bias and
    All-ReLU are kernel B, reading the product's columns in place; it
    computes what ``act(h + bias)`` does, bit for bit. With
    ``return_preacts`` each layer's ``h + bias`` is kept (and the
    activation is ``act``)."""
    act = activation_fn(config.activation, alpha=config.alpha)
    product = _layer_product(config, infer)
    fused = (config.activation == "all_relu" and (infer or not torch.is_grad_enabled())
             and not return_preacts)
    dropout = _dropout_fn(config, train, rng)
    h = x
    preacts = []
    n_layers = config.n_layers
    for l in range(n_layers):
        h = product(h, params["values"][l], topo_arrays[l], l)
        bias = params["biases"][l]
        if l == n_layers - 1:  # output layer: linear (paper: exclude output)
            h = h + bias
            preacts.append(h)
        else:  # paper's 1-based layer parity
            if fused:
                h = bias_all_relu(h, bias, alpha=config.alpha, layer_index=l + 1)
            else:
                z = h + bias
                preacts.append(z)
                h = act(z, l + 1)
            if dropout is not None:
                h = dropout(h)
    return (h, preacts) if return_preacts else h


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(logits), in f32."""
    return F.cross_entropy(logits.float(), labels.long())
