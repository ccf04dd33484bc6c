"""Logical-axis sharding rules (MaxText-style) -> DTensor layouts. Twin of
``repro.launch.sharding``.

Every parameter, cache and input leaf carries a tuple of logical axis names
(``PatternLM.specs``, ``PatternLM.cache_specs()``, ``launch.specs``). Rules
map logical names to mesh axes. The same rules drive single-pod (data,
model) and multi-pod (pod, data, model) meshes: ``batch`` spans
('pod', 'data'), so adding pods scales pure data parallelism, while FSDP
('embed' -> 'data') stays inside a pod.

:meth:`ShardingRules.pspec` returns the reference's PartitionSpec entries
as a tuple: per tensor dim, one mesh-axis name, a tuple of names, or None.
:meth:`ShardingRules.sharding` returns the :class:`Layout` a DTensor takes
on the mesh: one placement per mesh dim, ``Shard(d)`` for the tensor dim d
it splits or ``Replicate()``. A tensor dim over ('pod', 'data') is
``Shard(d)`` on both mesh dims, pod first: each rank holds the bytes that
the reference's shard of the same index holds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.tree import tree_map

Axis = Union[str, Tuple[str, ...], None]

__all__ = ["Layout", "ShardingRules", "default_rules", "spec_to_pspec", "tree_shardings",
           "shape_aware_shardings", "is_spec_leaf"]


def is_spec_leaf(x) -> bool:
    """A logical spec: None, or a tuple of axis names and Nones."""
    return x is None or (isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                                      for e in x))


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(mesh, ax: Axis) -> int:
    if ax is None:
        return 1
    sizes = _axis_sizes(mesh)
    n = 1
    for a in (ax,) if isinstance(ax, str) else ax:
        n *= sizes[a]
    return n


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives on ``mesh``: ``spec`` (the reference's
    PartitionSpec entries) and the DTensor ``placements`` it maps to."""

    mesh: Any
    spec: Tuple[Axis, ...]

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out = [Replicate() for _ in names]
        for d, ax in enumerate(self.spec):
            for a in (() if ax is None else (ax,) if isinstance(ax, str) else ax):
                out[names.index(a)] = Shard(d)
        return tuple(out)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """One rank's shard of a tensor of ``shape`` (every split divides)."""
        spec = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(int(n) // _axis_size(self.mesh, ax) for n, ax in zip(shape, spec))

    def shard(self, full):
        """This rank's shard of the full tensor ``full``: a copy that owns
        its bytes where a dim is split, else ``full`` itself (a replicated
        layout, and every layout on a 1 x 1 mesh, moves nothing). A dim
        over several mesh axes splits major to minor, as the reference's
        and DTensor's nested shards do."""
        sizes = _axis_sizes(self.mesh)
        coord = dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))
        out = full
        for d, ax in enumerate(self.spec):
            idx, n = 0, 1
            for a in () if ax is None else (ax,) if isinstance(ax, str) else ax:
                idx, n = idx * sizes[a] + coord[a], n * sizes[a]
            if n > 1:
                step = out.shape[d] // n
                out = out.narrow(d, idx * step, step)
        return full if out is full else out.clone()

    def from_local(self, local, shape: Sequence[int]):
        """The DTensor of global ``shape`` whose shard here is ``local``."""
        from torch.distributed.tensor import DTensor

        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * int(shape[i + 1])
        return DTensor.from_local(local, self.mesh, self.placements, run_check=False,
                                  shape=torch.Size(int(n) for n in shape),
                                  stride=tuple(stride))

    def distribute(self, full):
        """``full`` (the same on every rank) as a DTensor of this layout."""
        return self.from_local(self.shard(full), full.shape)


class ShardingRules:
    def __init__(self, rules: Dict[str, Axis], mesh):
        self.rules = dict(rules)
        self.mesh = mesh

    def pspec(self, logical: Optional[Sequence[Optional[str]]]) -> Tuple[Axis, ...]:
        if logical is None:
            return ()
        axes = []
        used = set()
        for name in logical:
            ax = self.rules.get(name) if name is not None else None
            # never map two tensor dims to the same mesh axis
            if ax is not None:
                flat = (ax,) if isinstance(ax, str) else tuple(ax)
                if any(a in used for a in flat):
                    ax = None
                else:
                    used.update(flat)
            axes.append(ax)
        return tuple(axes)

    def sharding(self, logical) -> Layout:
        return Layout(self.mesh, self.pspec(logical))


def default_rules(mesh, *, n_experts: int = 0, batch_size: Optional[int] = None,
                  fsdp: bool = True) -> ShardingRules:
    """The baseline ruleset.

    batch    -> ('pod','data') when present (pure DP across pods)
    embed    -> 'data' (FSDP / ZeRO-3 parameter sharding) when fsdp
    heads/kv/mlp/vocab/blocks/inner -> 'model' (TP)
    experts  -> 'model' when E % |model| == 0 (EP; else TP inside experts)
    stack    -> None (the layer axis stays unsharded; FSDP already covers
                params via 'embed')
    """
    axis_sizes = _axis_sizes(mesh)
    model_n = axis_sizes.get("model", 1)
    data_axes: Axis = ("pod", "data") if "pod" in axis_sizes else "data"
    dp = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
    batch_axis: Axis = data_axes
    if batch_size is not None and batch_size % dp != 0:
        # e.g. long_500k's global_batch=1: replicate batch, shard sequence
        batch_axis = None
    ep = n_experts > 0 and n_experts % model_n == 0
    rules: Dict[str, Axis] = {
        "batch": batch_axis,
        "seq": None,
        "stack": None,
        "embed": "data" if fsdp else None,
        "heads": "model",
        "heads_q": "model",
        "kv": "model",
        "kv_heads": "model",
        "mlp": "model",
        "vocab": "model",
        "blocks": "model",
        "inner": "model",
        "inner2": "model",
        "inner_b": None,
        "experts": "model" if ep else None,
        "expert_mlp": None if ep else "model",
        "cache_seq": data_axes if batch_axis is None else None,
        # fallback when kv_heads doesn't divide the model axis: shard the
        # cache sequence dim over 'model' (plus 'data'+'pod' when the batch
        # is too small to shard) instead of replicating the cache 16x
        "cache_seq_model": (
            "model"
            if batch_axis is not None
            else (data_axes + ("model",))
            if isinstance(data_axes, tuple)
            else (data_axes, "model")
        ),
        # residual-stream storage sharding (saved activation stacks)
        "act": "model",
        # MoE dispatch groups are aligned with data parallelism
        "data_groups": data_axes,
    }
    return ShardingRules(rules, mesh)


def spec_to_pspec(rules: ShardingRules, spec_tree):
    """Map a tree of logical-axis tuples to PartitionSpec entries."""
    return tree_map(rules.pspec, spec_tree, is_leaf=is_spec_leaf)


def tree_shardings(rules: ShardingRules, spec_tree):
    return tree_map(rules.sharding, spec_tree, is_leaf=is_spec_leaf)


def shape_aware_shardings(rules: ShardingRules, spec_tree, shape_tree):
    """Like tree_shardings, but drops any axis assignment whose mesh-axis
    size does not divide the tensor dim (e.g. whisper's 51865 vocab or
    gemma2's 4 KV heads on a 16-way axis). ``shape_tree`` holds tensors (a
    ``meta`` tensor will do) or anything with a ``shape``."""

    def one(logical, arr):
        shape = tuple(arr.shape)
        pspec = rules.pspec(logical)
        entries = pspec + (None,) * (len(shape) - len(pspec))
        dims = tuple(ax if ax is not None and shape[i] % _axis_size(rules.mesh, ax) == 0
                     else None for i, ax in enumerate(entries))
        return Layout(rules.mesh, dims)

    return tree_map(one, spec_tree, shape_tree, is_leaf=is_spec_leaf)
