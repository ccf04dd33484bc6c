"""Memory-budget planner for the out-of-core XL substrate (DESIGN.md §7).

Twin of ``repro.xl.planner``: host arithmetic only, so the same inputs give
the same plan, and the same JSON, as the reference's. The byte model is the
reference's (a TPU program's buffers); the port's executor holds other
buffers beside it (the shard windows' offsets, kernel F's run plans and
All-ReLU's branch masks), which it reports apart as
``StreamExecutor.port_extra_bytes``.

``plan_memory_budget`` takes a device-bytes budget and a model spec and
solves for the three knobs the streamed executor needs:

* **shard capacity** — the static per-shard slot count. One capacity serves
  every layer (ragged tails are padded with segment sentinels), so the two
  per-shard device passes (``kernels.ops.xl_shard_acc`` / ``xl_shard_dw``)
  run on buffers of one static shape for the whole model. Capacity is forced to a multiple
  of the chunk width: shard boundaries then land on chunk boundaries and the
  streamed accumulation reproduces the in-core chunk partition (and with it
  the f32 addition order) exactly.
* **chunk width** — the ``spmm_chunk_for``-compatible width of the chunked
  segment-sum passes. Starts at the batch-aware default and halves under
  tight budgets (the chunk slab is device memory too).
* **leaf placement** — biases and the d_max-padded activation/gradient
  buffers are always device-resident; weight values and optimizer state are
  always host-pinned (memmap-backed above ``memmap_threshold_bytes``) and
  streamed; topology index shards are device-cached ("resident") per layer
  when the leftover budget allows — indices are immutable between evolution
  events, so caching them halves the steady-state transfer volume without
  any coherence risk (the executor invalidates the cache on evolution).

The result is a plan *artifact* (JSON round-trip) consumed by the XL
trainer, the streamed checkpoint writer and the benchmarks — all three see
the same arithmetic, and the CI smoke asserts ``peak_device_bytes`` never
exceeds the budget it was solved for.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

from repro_torch.core.sparsity import spmm_chunk_for
from repro_torch.core.topology import element_shard_bounds

__all__ = [
    "PlannerError",
    "XLLayerPlan",
    "XLPlan",
    "plan_memory_budget",
    "estimate_in_core_bytes",
]

# Device bytes per shard *slot* while streaming: the value (f32) plus the two
# int32 index arrays of whichever order is in flight, double-buffered (shard
# k computes while shard k+1 transfers), plus the per-shard dW output slot.
_SLOT_BYTES_STREAMED = 2 * (4 + 8) + 4
# Device bytes per *connection* for a layer whose topology indices are cached
# device-resident: both orders' index arrays (rows/cols + rows_r/cols_r).
_TOPO_RESIDENT_BYTES = 16
# The chunked passes' peak temp: the (chunk, B) contribution slab plus the
# staged segment-sum output of the same size.
_CHUNK_SLABS = 2
# Activation-shaped (d_max, B) device buffers alive at the backward peak:
# x input, one pre-activation z per layer, the accumulator, the upstream
# gradient, the dX accumulator and the recomputed h_prev (+1 slack for the
# transfer of the next batch).
_N_BUFFERS_BASE = 5


class PlannerError(ValueError):
    """The budget cannot hold even the minimal streamed configuration; the
    message itemizes the fixed components so the caller can see what to cut
    (batch, width, chunk floor)."""


@dataclasses.dataclass(frozen=True)
class XLLayerPlan:
    index: int
    in_dim: int
    out_dim: int
    nnz: int
    n_shards: int
    topo_resident: bool  # index shards cached on device between evolutions


@dataclasses.dataclass(frozen=True)
class XLPlan:
    budget_bytes: int
    batch: int
    d_max: int
    shard_capacity: int
    chunk: int
    layers: Tuple[XLLayerPlan, ...]
    peak_device_bytes: int
    memmap_threshold_bytes: int
    dtype_bytes: int = 4

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def n_shards_total(self) -> int:
        return sum(l.n_shards for l in self.layers)

    @property
    def buffer_bytes(self) -> int:
        return self.d_max * self.batch * self.dtype_bytes

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["layers"] = [dataclasses.asdict(l) for l in self.layers]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "XLPlan":
        d = json.loads(text)
        d["layers"] = tuple(XLLayerPlan(**l) for l in d["layers"])
        return cls(**d)

    def save(self, path) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "XLPlan":
        return cls.from_json(Path(path).read_text())


def _fixed_bytes(
    layer_dims: Sequence[int], batch: int, dtype_bytes: int
) -> int:
    """Device bytes that do not scale with shard capacity: the activation/
    gradient buffers and the (padded) biases + bias gradients."""
    d_max = max(layer_dims)
    n_layers = len(layer_dims) - 1
    buffers = (_N_BUFFERS_BASE + n_layers) * d_max * batch * dtype_bytes
    biases = 3 * sum(layer_dims[1:]) * dtype_bytes
    return buffers + biases


def plan_memory_budget(
    layer_dims: Sequence[int],
    nnz_per_layer: Sequence[int],
    batch: int,
    budget_bytes: int,
    *,
    dtype_bytes: int = 4,
    chunk: Optional[int] = None,
    min_chunk: int = 64,
    memmap_threshold_bytes: int = 1 << 27,
) -> XLPlan:
    """Solve (shard capacity, chunk, leaf placement) for a device budget.

    Raises :class:`PlannerError` when infeasible — the fixed buffers alone
    exceed the budget, or no (capacity, chunk) pair fits with capacity >=
    chunk >= ``min_chunk``.
    """
    if len(nnz_per_layer) != len(layer_dims) - 1:
        raise ValueError("nnz_per_layer must have len(layer_dims) - 1 entries")
    if any(n <= 0 for n in nnz_per_layer):
        raise ValueError(f"every layer needs nnz >= 1, got {nnz_per_layer}")
    d_max = max(layer_dims)
    max_nnz = max(nnz_per_layer)
    fixed = _fixed_bytes(layer_dims, batch, dtype_bytes)
    if fixed >= budget_bytes:
        raise PlannerError(
            f"infeasible budget {budget_bytes}: the device-resident floor "
            f"alone needs {fixed} bytes "
            f"({_N_BUFFERS_BASE + len(layer_dims) - 1} activation buffers of "
            f"{d_max}x{batch}x{dtype_bytes}B + biases); shrink the batch or "
            f"the widest layer"
        )

    # chunk descent: the slab is device memory, so a tight budget trades
    # chunk width (scan steps) for headroom before giving up
    c0 = chunk if chunk is not None else spmm_chunk_for(batch, max_nnz)
    c0 = max(min_chunk, min(int(c0), max_nnz))
    chosen = None
    w = c0
    while w >= min_chunk:
        slab = _CHUNK_SLABS * w * batch * dtype_bytes
        avail = budget_bytes - fixed - slab
        cap = (avail // _SLOT_BYTES_STREAMED // w) * w  # multiple of chunk
        # capacity beyond the largest layer (rounded up to a whole number of
        # chunks) buys nothing but padding
        cap_ceil = -(-max_nnz // w) * w
        cap = min(cap, cap_ceil)
        if cap >= w:
            chosen = (cap, w)
            break
        w //= 2
    if chosen is None:
        raise PlannerError(
            f"infeasible budget {budget_bytes}: fixed floor {fixed}B leaves "
            f"no room for one {min_chunk}-slot shard "
            f"(+{_CHUNK_SLABS * min_chunk * batch * dtype_bytes}B chunk slab, "
            f"{_SLOT_BYTES_STREAMED}B/slot double-buffered)"
        )
    capacity, chunk_w = chosen
    peak = (
        fixed
        + _CHUNK_SLABS * chunk_w * batch * dtype_bytes
        + capacity * _SLOT_BYTES_STREAMED
    )

    # leftover budget -> device-cache topology indices, smallest layers
    # first (most shards avoided per byte; indices are immutable between
    # evolution events so this is pure transfer savings)
    leftover = budget_bytes - peak
    order = sorted(range(len(nnz_per_layer)), key=lambda l: nnz_per_layer[l])
    resident = set()
    for l in order:
        n_shards = len(element_shard_bounds(nnz_per_layer[l], capacity))
        topo_bytes = n_shards * capacity * _TOPO_RESIDENT_BYTES
        if topo_bytes <= leftover:
            resident.add(l)
            leftover -= topo_bytes
            peak += topo_bytes

    layers = tuple(
        XLLayerPlan(
            index=l,
            in_dim=int(layer_dims[l]),
            out_dim=int(layer_dims[l + 1]),
            nnz=int(nnz_per_layer[l]),
            n_shards=len(element_shard_bounds(nnz_per_layer[l], capacity)),
            topo_resident=l in resident,
        )
        for l in range(len(nnz_per_layer))
    )
    assert peak <= budget_bytes, (peak, budget_bytes)
    return XLPlan(
        budget_bytes=int(budget_bytes),
        batch=int(batch),
        d_max=int(d_max),
        shard_capacity=int(capacity),
        chunk=int(chunk_w),
        layers=layers,
        peak_device_bytes=int(peak),
        memmap_threshold_bytes=int(memmap_threshold_bytes),
        dtype_bytes=int(dtype_bytes),
    )


def estimate_in_core_bytes(
    layer_dims: Sequence[int],
    nnz_per_layer: Sequence[int],
    batch: int,
    *,
    dtype_bytes: int = 4,
) -> int:
    """Device footprint of the in-core fused trainer for the same model:
    values + velocity (f32) and the dual-order ``ElemTopoArrays`` (7 int32
    arrays) per layer, biases + velocity, and the live activation set of one
    value_and_grad step (~2 tensors per layer boundary). The benchmark's
    "equal budget" comparisons (table4/xl_*) hand the planner a budget below
    this number to force genuine streaming."""
    total = 0
    for l, nnz in enumerate(nnz_per_layer):
        total += nnz * (2 * dtype_bytes + 7 * 4)
    total += 2 * sum(layer_dims[1:]) * dtype_bytes
    total += 2 * sum(d * batch * dtype_bytes for d in layer_dims)
    return total
