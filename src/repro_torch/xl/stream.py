"""Shard-streamed out-of-core forward/backward (DESIGN.md §7). Twin of
``repro.xl.stream``.

The substrate trains element-sparse MLPs whose live parameters (values +
dual-order topology + momentum) never fit on the device at once:

* **Host leaves** — per layer, the canonical COO arrays (rows, cols), the
  row-order permutation ``perm_r``, values and velocity live in host numpy,
  memmap-backed above the plan's size threshold. The device only ever holds
  one fixed-capacity *connection shard* of them (plus its successor, in
  flight). A leaf is never pinned whole (a memmapped one cannot be, cheaply).
* **Streamed products** — forward and dX are both runs of
  ``kernels.ops.xl_shard_acc`` (kernel A over the shard's window of
  segments, in place into the carried (d_max, B) buffer) over a d_max-padded
  transposed activation buffer: forward streams the canonical order (gather
  rows, segment cols), dX the row-sorted dual order (gather cols_r, segment
  rows_r, values gathered through ``perm_r`` on the host). dW streams
  index-only canonical shards through ``xl_shard_dw`` (kernel F without its
  epilogue). Kernel A sums each output in one chain in slot order from its
  carry-in, so the shards give the bits of the in-core product.
* **Epilogues** — after a layer's last shard, kernel B's own pass in the
  (features, batch) layout (``kernels.all_relu_fused.bias_all_relu_T``) adds
  the bias and applies All-ReLU, keeping the branch mask for the backward
  (the reference's ``_bias_add`` + ``_act``); in the backward, kernel G
  (``all_relu_bwd``) turns the upstream gradient into dz and the bias's
  gradient once per layer (the reference's ``_act_bwd`` + ``_bias_grad``).
  Each is the arithmetic of the in-core step's fused store (kernel A's
  epilogue) and of kernel F's epilogue, so a streamed step gives the in-core
  step's bits.
* **The host pipeline** (on the card) — each shard is gathered straight into
  one slot of a ring of two pinned host buffers allocated once at the shard
  capacity C (values, gather ids, the window's offsets, kernel F's run
  plan; the segment ids reach the device only as those offsets), copied on
  a copy stream, and the compute stream waits on the copy's event. A slot's
  host memory is written again only after its last copy's event has
  completed, and its device memory only after the kernels that read it
  (an event on the compute stream). So shard k + 1 is gathered and copied
  while shard k computes. dW's ``dv`` returns through two pinned buffers
  the same way; the host reads one only after its copy's event.
* **Host optimizer** — dW is applied shard by shard as a momentum-SGD update
  of the shard's value/velocity slice in f32 numpy, in the reference's order
  of operations; no whole-layer gradient is ever materialized on either side
  of the PCIe bus.

Static buffers (the port's form of the reference's "zero recompiles"): the
executor allocates every device buffer once, when it is made, each with one
static shape derived from the plan (d_max, batch, capacity), and then refuses
to allocate more; no shard, layer or epoch adds one. The reference's
``compile_counts()`` counts the jit caches those static shapes keep at one
executable each; the port has no jit cache, so :func:`compile_counts` counts
the distinct (shape, dtype) each named device buffer has been allocated with
by any executor since import: one each for a plan, however many shards,
layers, epochs or executors ran. ``StreamExecutor.allocations`` counts the
allocations themselves. The loss's few (B, n_classes) temporaries come from
PyTorch's caching allocator, outside this contract.

Observability, as the reference's: one ``xl.forward`` span per streamed
forward and one ``xl.train_step`` span per step (not per shard: the shard
loop is the hot path), and ``StreamExecutor.probe_stats``, the
training-dynamics probe of the streamed model (``xl.probe``).

The contract auditor (``repro_torch.analysis``) audits the two shard
programs (:func:`analysis_programs`).
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time
import weakref
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import (
    check_element_shards,
    element_row_order,
    element_shard_bounds,
)
from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.kernels.all_relu_fused import all_relu_bwd, bias_all_relu_T
from repro_torch.kernels.ops import (
    XLWindow,
    shard_runs,
    window_offsets,
    xl_shard_acc,
    xl_shard_dw,
)
from repro_torch.models.mlp import cross_entropy_loss
from repro_torch.obs import probes
from repro_torch.xl.planner import XLPlan

__all__ = [
    "XLLayerState",
    "XLModelState",
    "StreamExecutor",
    "host_leaf",
    "compile_counts",
]


# ---------------------------------------------------------------------------
# host leaves
# ---------------------------------------------------------------------------


def host_leaf(
    arr: np.ndarray,
    *,
    threshold_bytes: int,
    spool_dir: Optional[Path],
    name: str,
) -> np.ndarray:
    """Keep an array host-side: a plain ndarray below the threshold, a
    file-backed memmap above it (so leaves larger than comfortable RSS spill
    to the page cache; the OS pages shards in as they stream)."""
    arr = np.ascontiguousarray(arr)
    if spool_dir is None or arr.nbytes < threshold_bytes:
        # the optimizer updates leaves in place, so own a writable copy
        return arr.copy() if not arr.flags.writeable else arr
    spool_dir.mkdir(parents=True, exist_ok=True)
    path = spool_dir / f"{name}.mm"
    mm = np.memmap(path, dtype=arr.dtype, mode="w+", shape=arr.shape)
    mm[...] = arr
    return mm


@dataclasses.dataclass
class XLLayerState:
    """One layer's host state. Canonical (col, row) order throughout;
    ``perm_r`` maps row-order slot -> canonical slot (int64)."""

    in_dim: int
    out_dim: int
    rows: np.ndarray      # int32 (nnz,)
    cols: np.ndarray      # int32 (nnz,)
    perm_r: np.ndarray    # int64 (nnz,)
    values: np.ndarray    # f32 (nnz,)
    velocity: np.ndarray  # f32 (nnz,)
    bias: np.ndarray      # f32 (out_dim,)
    bias_vel: np.ndarray  # f32 (out_dim,)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])


def _own_spool(state: "XLModelState", spool: Path) -> None:
    """Remove a spool directory this package made when its state dies, so
    that no memmap outlives the run that made it."""
    weakref.finalize(state, shutil.rmtree, str(spool), True)


@dataclasses.dataclass
class XLModelState:
    """Whole-model host state + the plan that shaped it. ``topo_version``
    bumps on every topology mutation (SET evolution) so the executor can
    invalidate any device-cached index shards."""

    layer_dims: Tuple[int, ...]
    activation: str
    alpha: float
    init: str
    layers: List[XLLayerState]
    plan: XLPlan
    spool_dir: Optional[Path] = None
    topo_version: int = 0

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @classmethod
    def from_model(
        cls, model, plan: XLPlan, spool_dir: Optional[str] = None
    ) -> "XLModelState":
        """Build host state from an in-core ``SparseMLP`` (element impl),
        so that the XL run starts from the exact draw of its in-core oracle.
        Every leaf is a copy: the model's tensors and topology stay as they
        were. Velocity starts at zero, as ``MomentumSGD.init`` does. Where
        no ``spool_dir`` is given and a leaf needs a memmap, a temporary one
        is made, and removed with the state."""
        cfg = model.config
        if cfg.impl != "element":
            raise ValueError("XL substrate streams the element (COO) path only")
        spool = Path(spool_dir) if spool_dir is not None else None
        owned = None
        if spool is None and any(
            t.nnz * 4 >= plan.memmap_threshold_bytes for t in model.topos
        ):
            spool = owned = Path(tempfile.mkdtemp(prefix="xl_spool_"))
        layers = []
        for l, topo in enumerate(model.topos):
            thr = plan.memmap_threshold_bytes

            def leaf(a, nm, dtype):
                a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
                return host_leaf(
                    np.array(a, dtype), threshold_bytes=thr,
                    spool_dir=spool, name=f"l{l}_{nm}",
                )

            layers.append(
                XLLayerState(
                    in_dim=topo.in_dim,
                    out_dim=topo.out_dim,
                    rows=leaf(topo.rows, "rows", np.int32),
                    cols=leaf(topo.cols, "cols", np.int32),
                    perm_r=leaf(
                        element_row_order(topo.rows, topo.cols), "perm_r",
                        np.int64,
                    ),
                    values=leaf(model.values[l], "values", np.float32),
                    velocity=leaf(
                        np.zeros(topo.nnz, np.float32), "velocity", np.float32
                    ),
                    bias=np.array(model.biases[l].detach().cpu().numpy(), np.float32),
                    bias_vel=np.zeros(topo.out_dim, np.float32),
                )
            )
        state = cls(
            layer_dims=tuple(cfg.layer_dims),
            activation=cfg.activation,
            alpha=cfg.alpha,
            init=cfg.init,
            layers=layers,
            plan=plan,
            spool_dir=spool,
        )
        if owned is not None:
            _own_spool(state, owned)
        return state

    def check_invariants(self) -> None:
        for st in self.layers:
            check_element_shards(
                np.asarray(st.rows), np.asarray(st.cols),
                np.asarray(st.perm_r), st.in_dim, st.out_dim,
                self.plan.shard_capacity,
            )

    # -- streamed checkpointing (CheckpointManager.save_streamed) ----------

    def stream_groups(self):
        """``{group: {leaf: (shape, dtype, chunk-iterator)}}`` for
        ``CheckpointManager.save_streamed``: every iterator yields
        shard-capacity slices, so the writer's working set is one shard no
        matter how large the layer."""
        cap = self.plan.shard_capacity

        def chunks(a):
            def it():
                for lo in range(0, a.shape[0], cap):
                    yield np.asarray(a[lo : lo + cap])
            return (a.shape, a.dtype, it())

        groups = {}
        for l, st in enumerate(self.layers):
            groups[f"xl_layer{l}"] = {
                "rows": chunks(st.rows),
                "cols": chunks(st.cols),
                "perm_r": chunks(st.perm_r),
                "values": chunks(st.values),
                "velocity": chunks(st.velocity),
                "bias": chunks(st.bias),
                "bias_vel": chunks(st.bias_vel),
            }
        return groups

    def save(self, manager, step: int, extra_meta: Optional[dict] = None):
        meta = {
            "kind": "xl_model",
            "layer_dims": list(self.layer_dims),
            "activation": self.activation,
            "alpha": self.alpha,
            "init": self.init,
            "nnz_per_layer": [st.nnz for st in self.layers],
            **(extra_meta or {}),
        }
        manager.save_streamed(step, self.stream_groups(), meta=meta)

    @classmethod
    def restore(
        cls,
        manager,
        plan: XLPlan,
        step: Optional[int] = None,
        spool_dir: Optional[str] = None,
    ) -> "XLModelState":
        """Streamed restore: each leaf is copied shard-by-shard from the
        checkpoint's on-disk memmap into a fresh host leaf. The indices are
        range-checked shard by shard on the way, since kernels A and F
        gather through them unchecked."""
        manifest = manager.read_manifest(step)
        meta = manifest["meta"]
        if meta.get("kind") != "xl_model":
            raise ValueError(f"checkpoint is not an xl_model: {meta}")
        spool = Path(spool_dir) if spool_dir is not None else None
        cap = plan.shard_capacity
        layer_dims = tuple(meta["layer_dims"])
        layers = []
        for l in range(len(layer_dims) - 1):
            group = f"xl_layer{l}"

            def leaf(nm, bound=None):
                src = manager.restore_stream(step, group, nm)
                out = host_leaf(
                    np.empty(src.shape, src.dtype),
                    threshold_bytes=plan.memmap_threshold_bytes,
                    spool_dir=spool, name=f"l{l}_{nm}",
                )
                for lo in range(0, src.shape[0], cap):
                    out[lo : lo + cap] = src[lo : lo + cap]
                    part = out[lo : lo + cap]
                    if bound is not None and part.size and (
                            part.min() < 0 or part.max() >= bound):
                        raise ValueError(
                            f"{group}/{nm} has indices outside [0, {bound})")
                return out

            layers.append(
                XLLayerState(
                    in_dim=layer_dims[l],
                    out_dim=layer_dims[l + 1],
                    rows=leaf("rows", layer_dims[l]),
                    cols=leaf("cols", layer_dims[l + 1]),
                    perm_r=leaf("perm_r", meta["nnz_per_layer"][l]),
                    values=leaf("values"),
                    velocity=leaf("velocity"), bias=leaf("bias"),
                    bias_vel=leaf("bias_vel"),
                )
            )
        return cls(
            layer_dims=layer_dims,
            activation=meta["activation"],
            alpha=meta["alpha"],
            init=meta["init"],
            layers=layers,
            plan=plan,
            spool_dir=spool,
        )


# ---------------------------------------------------------------------------
# static device buffers (the port's compile_counts)
# ---------------------------------------------------------------------------

# every (shape, dtype) each named device buffer has been allocated with
_SHAPES: Dict[str, set] = {}


def compile_counts() -> dict:
    """For each named device buffer of the substrate, the number of
    distinct (shape, dtype) it has been allocated with by any executor since
    import: the port's form of the reference's jit-cache counts (module
    docstring). Streaming more shards, layers or epochs must not grow any of
    them."""
    return {name: len(shapes) for name, shapes in sorted(_SHAPES.items())}


def _note_shape(name: str, t: torch.Tensor) -> None:
    _SHAPES.setdefault(name, set()).add((tuple(t.shape), str(t.dtype)))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class _Slot:
    """One slot of the shard ring: host buffers at capacity (pinned on the
    card's host; ``np`` their numpy views) and their device twins, the event
    of the last copy out of them (``copied``) and of the last kernels that
    read the device twins (``consumed``). On the CPU the host buffers are
    the device buffers and there are no events."""

    FIELDS = ("values", "gather", "seg_ptr", "runs")

    def __init__(self, ex: "StreamExecutor", capacity: int):
        shapes = {"values": ((capacity,), torch.float32), "gather": ((capacity,), torch.int32),
                  "seg_ptr": ((capacity + 1,), torch.int64),
                  "runs": ((capacity, 3), torch.int32)}
        self.dev = {k: ex._alloc(k, *shapes[k]) for k in self.FIELDS}
        if ex.cuda:
            self.host = {k: torch.empty(shapes[k][0], dtype=shapes[k][1], pin_memory=True)
                         for k in self.FIELDS}
            self.copied = torch.cuda.Event()
            self.consumed = torch.cuda.Event()
        else:
            self.host = self.dev
        self.np = {k: t.numpy() for k, t in self.host.items()}


class StreamExecutor:
    """Runs the streamed forward/backward for one :class:`XLModelState` on
    ``device`` (the card unless the caller asks for the CPU).

    The executor owns no model state, only the plan-derived static buffers,
    the per-hidden-layer activation slopes and (when the plan marks a layer
    ``topo_resident``) a device cache of its immutable index shards.
    ``stats`` accumulates where the host's time and the bus's bytes go
    (``reset_stats``): ``gather_s`` (filling the pinned slots: values,
    indices, offsets, run plans), ``copy_s`` (issuing the copies),
    ``wait_s`` (waiting for copies' and kernels' events), ``update_s`` (the
    host momentum-SGD update), ``h2d_bytes`` and ``d2h_bytes``.

    ``sync_copies`` (default off) synchronises the device after every
    shard's copy, the reference run a race check compares the pipeline with;
    ``copy_delay_cycles`` spins the copy stream that many cycles before
    each shard's copy, so that a copy is still in flight when the host comes
    back to its slot: the stress under which a ring that reused a slot too
    early would give other numbers.
    """

    def __init__(self, state: XLModelState, device=None):
        self.state = state
        plan = state.plan
        self.plan = plan
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.d_max = plan.d_max
        self.B = plan.batch
        self.C = plan.shard_capacity
        self.chunk = plan.chunk
        if state.activation not in ("all_relu", "relu", "leaky_relu"):
            raise ValueError(
                f"XL substrate supports piecewise-linear activations with "
                f"f(0)=0, got {state.activation!r}"
            )
        # per hidden layer, the negative-side slope (paper 1-based parity)
        slopes = []
        for l in range(state.n_layers - 1):
            li = l + 1
            if state.activation == "all_relu":
                s = -state.alpha if li % 2 == 0 else state.alpha
            elif state.activation == "relu":
                s = 0.0
            else:
                s = state.alpha
            slopes.append(float(np.float32(s)))
        self._slopes = slopes
        self._topo_cache: dict = {}
        self._topo_cache_version = -1
        self._measured_peak = 0
        self.sync_copies = False
        self.copy_delay_cycles = 0
        self.allocations: Counter = Counter()
        self._sealed = False
        self.reset_stats()

        d, B, C, f32 = self.d_max, self.B, self.C, torch.float32
        n = state.n_layers
        # (d_max, B) activation buffers: the input, each hidden layer's
        # output and branch mask (kept for the backward), the accumulator
        # (forward products, the logits, dX) and the gradient dz
        self.xT = self._alloc("x", (d, B), f32)
        self.h = [self._alloc("h", (d, B), f32) for _ in range(n - 1)]
        self.mask = [self._alloc("mask", (d, B), torch.uint8) for _ in range(n - 1)]
        self.acc = self._alloc("acc", (d, B), f32)
        self.dz = self._alloc("dz", (d, B), f32)
        self.bias_dev = self._alloc("bias", (d,), f32)
        self.dbias = self._alloc("dbias", (d,), f32)
        self.y = self._alloc("labels", (B,), torch.int64)
        self._ring = [_Slot(self, C) for _ in range(2)]
        self._next = 0
        self._dv = [self._alloc("dv", (C,), f32) for _ in range(2)]
        in_dim = state.layer_dims[0]
        # host sides of the small transfers (pinned on the card's host)
        self._x_host = self._host((in_dim, B), f32, self.xT[:in_dim])
        self._y_host = self._host((B,), torch.int64, self.y)
        self._bias_host = [self._host((st.out_dim,), f32, self.bias_dev[: st.out_dim])
                           for st in state.layers]
        self._dbias_host = self._host((d,), f32, self.dbias)
        self._dv_host = [self._host((C,), f32, t) for t in self._dv]
        self._logits_host = self._host((state.layer_dims[-1], B), f32,
                                       self.acc[: state.layer_dims[-1]])
        self._seg_scratch = np.empty(C, np.int32)  # a dX shard's segment ids
        if self.cuda:
            self._copy_stream = torch.cuda.Stream(self.device)
            self._events = {k: torch.cuda.Event() for k in ("x", "y", "logits", "dbias")}
            self._bias_events = [torch.cuda.Event() for _ in state.layers]
            self._dv_events = [torch.cuda.Event() for _ in self._dv]
        self._sealed = True

    # -- buffers ------------------------------------------------------------

    def _alloc(self, name: str, shape, dtype) -> torch.Tensor:
        """A device buffer, allocated once, when the executor is made."""
        if self._sealed:
            raise RuntimeError(
                f"StreamExecutor allocates its device buffers once, when it is made; "
                f"{name!r} was asked for after"
            )
        t = torch.zeros(shape, dtype=dtype, device=self.device)
        _note_shape(name, t)
        self.allocations[name] += 1
        return t

    def _host(self, shape, dtype, dev: torch.Tensor) -> torch.Tensor:
        """``dev``'s host side: pinned memory of ``shape`` on the card's
        host, ``dev`` itself on the CPU."""
        if self.cuda:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return dev

    def _h2d(self, dev: torch.Tensor, host: torch.Tensor, event) -> None:
        """Copy the pinned ``host`` to ``dev`` on the compute stream and
        record ``event``, which the host waits on before writing ``host``
        again."""
        if self.cuda:
            dev.copy_(host, non_blocking=True)
            event.record()
            self.stats["h2d_bytes"] += host.nbytes

    def _d2h(self, host: torch.Tensor, dev: torch.Tensor, event) -> None:
        """Copy ``dev`` to the pinned ``host`` on the compute stream and
        record ``event``; :meth:`_wait` it before reading ``host``."""
        if self.cuda:
            host.copy_(dev, non_blocking=True)
            event.record()
            self.stats["d2h_bytes"] += host.nbytes

    def _wait(self, event) -> None:
        if self.cuda:
            t0 = time.perf_counter()
            event.synchronize()
            self.stats["wait_s"] += time.perf_counter() - t0

    def reset_stats(self) -> None:
        self.stats = dict(gather_s=0.0, copy_s=0.0, wait_s=0.0, update_s=0.0,
                          h2d_bytes=0, d2h_bytes=0)

    # -- device-bytes accounting --------------------------------------------

    def _note_bytes(self, n_buffers: int, extra: int = 0) -> None:
        plan = self.plan
        live = (
            n_buffers * plan.buffer_bytes
            + 2 * self.C * (4 + 8)            # double-buffered shard slots
            + self.C * 4                       # dW output slot
            + 2 * self.chunk * self.B * 4      # chunk slabs
            + 3 * sum(self.state.layer_dims[1:]) * 4
            + self._topo_cache_bytes()
            + extra
        )
        self._measured_peak = max(self._measured_peak, live)

    def _topo_cache_bytes(self) -> int:
        """The cached index shards as the plan counts them: two int32
        arrays at capacity per shard (the rest is :attr:`port_extra_bytes`)."""
        return len(self._topo_cache) * 2 * self.C * 4

    @property
    def measured_peak_bytes(self) -> int:
        """High-water of executor-held device bytes by the reference's audit
        (its static shapes at each phase of the step), plus
        :attr:`port_extra_bytes`: an allocation audit, not an allocator
        probe; on the card ``torch.cuda.max_memory_allocated`` is the
        measurement it is held against."""
        return self._measured_peak + self.port_extra_bytes

    @property
    def port_extra_bytes(self) -> int:
        """Device bytes the port holds beyond the reference's audit: each
        ring slot's window offsets and kernel F's run plan at their capacity
        bound, All-ReLU's branch masks, and the cached index shards' bytes
        beyond the two int32 arrays the plan counts."""
        ring = sum(s.dev["seg_ptr"].nbytes + s.dev["runs"].nbytes for s in self._ring)
        masks = sum(m.nbytes for m in self.mask)
        cache = sum(sum(t.nbytes for t in e[1] if t is not None) for e in self._topo_cache.values())
        return ring + masks + max(0, cache - self._topo_cache_bytes())

    # -- shard streams --------------------------------------------------------

    def _take_slot(self) -> _Slot:
        """The next ring slot, once its last copy out of host memory is
        done (so the host may write it)."""
        slot = self._ring[self._next % len(self._ring)]
        self._next += 1
        if self.cuda:
            self._wait(slot.copied)
        return slot

    def _ship(self, slot: _Slot, sizes: Dict[str, int]) -> None:
        """Copy the first ``sizes[field]`` rows of each field of ``slot`` to
        the device on the copy stream, once the kernels that read the last
        shard in it are done, and make the compute stream wait for the
        copy."""
        if not self.cuda:
            return
        t0 = time.perf_counter()
        cs = self._copy_stream
        with torch.cuda.stream(cs):
            cs.wait_event(slot.consumed)
            if self.copy_delay_cycles:
                torch.cuda._sleep(self.copy_delay_cycles)
            for k, m in sizes.items():
                if m:
                    slot.dev[k][:m].copy_(slot.host[k][:m], non_blocking=True)
                    self.stats["h2d_bytes"] += slot.np[k][:m].nbytes
            slot.copied.record(cs)
        torch.cuda.current_stream(self.device).wait_event(slot.copied)
        self.stats["copy_s"] += time.perf_counter() - t0
        if self.sync_copies:
            torch.cuda.synchronize(self.device)

    def _stream(self, l: int, order: str, *, values: bool, runs: bool):
        """Stage layer ``l``'s shards of ``order`` ("fwd": the canonical
        order, whose windows also carry kernel F's run plan with ``runs``;
        "dx": the row-sorted dual order) one ahead of the consumer, and
        yield ``((lo, hi), window, values_dev, gather_dev)`` per shard. A
        ``topo_resident`` layer keeps its index shards on the device between
        evolutions (``topo_version``), so that only values move."""
        if self._topo_cache_version != self.state.topo_version:
            self._topo_cache.clear()
            self._topo_cache_version = self.state.topo_version
        st = self.state.layers[l]
        resident = self.plan.layers[l].topo_resident
        runs = runs or (resident and order == "fwd")
        for lo, hi in element_shard_bounds(st.nnz, self.C):
            key = (order, l, lo)
            hit = self._topo_cache.get(key) if resident else None
            slot = self._take_slot()
            t0 = time.perf_counter()
            k = hi - lo
            host = slot.np
            if order == "fwd":
                if values:
                    np.copyto(host["values"][:k], st.values[lo:hi])
                if hit is None:
                    np.copyto(host["gather"][:k], st.rows[lo:hi])
                    seg = np.asarray(st.cols[lo:hi])
            else:
                p = np.asarray(st.perm_r[lo:hi])
                if values:
                    np.take(st.values, p, out=host["values"][:k], mode="clip")
                if hit is None:
                    np.take(st.cols, p, out=host["gather"][:k], mode="clip")
                    seg = np.take(st.rows, p, out=self._seg_scratch[:k], mode="clip")
            if hit is None:
                w_lo, n, longest = window_offsets(seg, host["seg_ptr"])
                n_runs = (shard_runs(host["gather"][:k], host["seg_ptr"][: n + 1], host["runs"])
                          if runs else 0)
            self.stats["gather_s"] += time.perf_counter() - t0
            sizes = {"values": k if values else 0}
            if hit is None:
                sizes.update(gather=k, seg_ptr=n + 1, runs=n_runs)
            self._ship(slot, sizes)
            if hit is None:
                window = XLWindow(w_lo, n, k, longest, slot.dev["seg_ptr"],
                                  slot.dev["runs"] if runs else None, n_runs)
                gather = slot.dev["gather"]
                if resident:
                    hit = self._cache(key, window, gather)
            if hit is not None:
                window, gather = hit[0], hit[1][0]
            yield (lo, hi), window, slot.dev["values"], gather
            if self.cuda:
                slot.consumed.record(torch.cuda.current_stream(self.device))

    def _cache(self, key, window: XLWindow, gather: torch.Tensor):
        """Keep a shard's device index arrays (copies, made on the compute
        stream after its copy) under ``key`` until the topology changes."""
        g, sp = gather.clone(), window.seg_ptr.clone()
        runs = None if window.runs is None else window.runs.clone()
        self.allocations["topo_cache"] += 1
        entry = (window._replace(seg_ptr=sp, runs=runs), (g, sp, runs))
        self._topo_cache[key] = entry
        return entry

    # -- forward ------------------------------------------------------------

    def _put_input(self, xb: np.ndarray) -> None:
        """(B', n_feat) host batch -> the first n_feat rows of the
        transposed device buffer; ragged eval tails zero-pad the batch."""
        if xb.shape[0] > self.B:
            raise ValueError(
                f"batch of {xb.shape[0]} exceeds the plan's batch {self.B}"
            )
        if self.cuda:
            self._wait(self._events["x"])
        nb = xb.shape[0]
        x = self._x_host.numpy()
        x[:, :nb] = np.asarray(xb, np.float32).T
        x[:, nb:] = 0.0
        self._h2d(self.xT[: x.shape[0]], self._x_host, self._events["x"] if self.cuda else None)

    def _put_bias(self, l: int) -> None:
        host = self._bias_host[l]
        if self.cuda:
            self._wait(self._bias_events[l])
        host.numpy()[...] = self.state.layers[l].bias
        self._h2d(self.bias_dev[: host.shape[0]], host,
                  self._bias_events[l] if self.cuda else None)

    def forward(self, xb: np.ndarray, *, train: bool = False,
                preact_stats: Optional[list] = None) -> torch.Tensor:
        """Streamed forward of up to ``plan.batch`` rows. Leaves each hidden
        layer's output (and, with ``train``, its branch mask) in its buffer
        and returns the logits' rows of the accumulator, (n_classes, B), on
        the device. With ``preact_stats`` (a list), each layer's
        ``(saturation, l2)`` of its pre-activation z + bias is appended to it
        (``probes.padded_buffer_probe`` of a (d_max, B) temporary)."""
        st = self.state
        n = st.n_layers
        # one span per streamed forward, not per shard; nothing is
        # registered on it, so it measures enqueue, not device time
        with obs.span("xl.forward", layers=n):
            self._put_input(xb)
            src = self.xT
            for l in range(n):
                out_dim = st.layers[l].out_dim
                acc = self.acc[:out_dim]
                acc.zero_()
                self._put_bias(l)
                for _, window, vals, gather in self._stream(l, "fwd", values=True, runs=False):
                    xl_shard_acc(self.acc, src, vals, gather, n_segments=self.d_max,
                                 window=window)
                bias = self.bias_dev[:out_dim]
                if preact_stats is not None and l < n - 1:
                    z = self.acc + self.bias_dev[:, None]
                    preact_stats.append(probes.padded_buffer_probe(z, out_dim)[:2])
                if l < n - 1:
                    bias_all_relu_T(acc, bias, self._slopes[l], out=self.h[l][:out_dim],
                                    mask=self.mask[l][:out_dim] if train else None)
                    src = self.h[l]
                else:
                    bias_all_relu_T(acc, bias, None, out=acc)
                    if preact_stats is not None:
                        preact_stats.append(probes.padded_buffer_probe(self.acc, out_dim)[:2])
            self._note_bytes(n + 3 if train else 4)
            return self.acc[: st.layer_dims[-1]]

    def logits(self, xb: np.ndarray) -> np.ndarray:
        """Streamed inference logits for up to ``plan.batch`` rows."""
        z = self.forward(xb, train=False)
        if self.cuda:
            self._d2h(self._logits_host, z, self._events["logits"])
            self._wait(self._events["logits"])
        return self._logits_host.numpy()[:, : xb.shape[0]].T.copy()

    # -- train step ---------------------------------------------------------

    def train_step(self, xb: np.ndarray, yb: np.ndarray, lr: float,
                   *, momentum: float, weight_decay: float) -> float:
        """One streamed minibatch step: forward, CE loss, streamed backward
        with immediate per-shard host momentum-SGD updates. Semantically the
        in-core ``launch.steps.make_mlp_step_core`` (same loss, same update
        order: all gradients are taken against pre-update parameters)."""
        if xb.shape[0] != self.B:
            raise ValueError(
                f"train_step needs a full batch of {self.B} rows, got "
                f"{xb.shape[0]}: the loss and gradient buffers are shaped for "
                f"the plan's batch (ragged batches are eval-only)"
            )
        # the step ends with float(loss), a full sync: the span needs no
        # block_on
        with obs.span("xl.train_step"):
            return self._train_step_inner(xb, yb, np.float32(lr), np.float32(momentum),
                                          np.float32(weight_decay))

    def _loss_and_dz(self, xb: np.ndarray, yb: np.ndarray, *, train: bool,
                     preact_stats: Optional[list] = None) -> torch.Tensor:
        """The forward, then the loss as the in-core step takes it (the
        (B, n_classes) logits, F.cross_entropy, its gradient by autograd: the
        same bits), the logits' gradient left in ``dz``. Returns the loss on
        the device."""
        n_out = self.state.layer_dims[-1]
        self.forward(xb, train=train, preact_stats=preact_stats)
        if self.cuda:
            self._wait(self._events["y"])
        self._y_host.numpy()[...] = np.asarray(yb, np.int64)
        self._h2d(self.y, self._y_host, self._events["y"] if self.cuda else None)
        with torch.enable_grad():
            logits = self.acc[:n_out].T.contiguous().requires_grad_(True)
            loss = cross_entropy_loss(logits, self.y)
            (dlogits,) = torch.autograd.grad(loss, logits)
        self.dz[:n_out].copy_(dlogits.T)
        return loss

    def _train_step_inner(self, xb: np.ndarray, yb: np.ndarray, lr, mu, wd) -> float:
        st = self.state
        n = st.n_layers
        n_out = st.layer_dims[-1]
        loss = self._loss_and_dz(xb, yb, train=True)
        # the output layer's dz is the logits' gradient; G gives its bias's
        all_relu_bwd(self.dz[:n_out], None, None, dbias_out=self.dbias[:n_out])
        for l in range(n - 1, -1, -1):
            layer = st.layers[l]
            dbias_host = self._dbias_host[: layer.out_dim]
            self._d2h(dbias_host, self.dbias[: layer.out_dim],
                      self._events["dbias"] if self.cuda else None)
            dbias_host = dbias_host.numpy()
            # dX first: it reads the layer's *pre-update* values
            if l > 0:
                self.acc[: layer.in_dim].zero_()
                for _, window, vals, gather in self._stream(l, "dx", values=True, runs=False):
                    xl_shard_acc(self.acc, self.dz, vals, gather, n_segments=self.d_max,
                                 window=window)
            h_prev = self.xT if l == 0 else self.h[l - 1]
            # dW + host update, shard by shard (index-only stream: dW never
            # reads the values, the host update does that in place); shard
            # k's update runs while shard k + 1 computes
            pending = None
            shards = self._stream(l, "fwd", values=False, runs=True)
            for k, ((lo, hi), window, _, gather) in enumerate(shards):
                j = k % 2
                xl_shard_dw(h_prev, self.dz, gather, window=window, out=self._dv[j])
                self._d2h(self._dv_host[j][: hi - lo], self._dv[j][: hi - lo],
                          self._dv_events[j] if self.cuda else None)
                if pending is not None:
                    self._update(layer, *pending, lr, mu, wd)
                pending = (lo, hi, j)
            self._update(layer, *pending, lr, mu, wd)
            # bias update (gradient against pre-update bias, like in-core)
            if self.cuda:
                self._wait(self._events["dbias"])
            t0 = time.perf_counter()
            g = dbias_host + wd * layer.bias
            layer.bias_vel[:] = mu * layer.bias_vel - lr * g
            layer.bias += layer.bias_vel
            self.stats["update_s"] += time.perf_counter() - t0
            if l > 0:
                # the layer below's dz and bias gradient: G on dX's result
                in_dim = layer.in_dim
                all_relu_bwd(self.acc[:in_dim], self.mask[l - 1][:in_dim],
                             self._slopes[l - 1], dz_out=self.dz[:in_dim],
                             dbias_out=self.dbias[:in_dim])
        self._note_bytes(n + 5)
        return float(loss.detach())

    def _update(self, layer: XLLayerState, lo: int, hi: int, j: int,
                lr, mu, wd) -> None:
        """The host momentum-SGD update of one shard's slice, from its dW in
        ``dv`` slot ``j`` (waited for first), in the reference's order."""
        if self.cuda:
            self._wait(self._dv_events[j])
        t0 = time.perf_counter()
        dv_np = self._dv_host[j][: hi - lo].numpy()
        v = layer.values[lo:hi]
        gsl = dv_np + wd * v
        layer.velocity[lo:hi] = mu * layer.velocity[lo:hi] - lr * gsl
        layer.values[lo:hi] = v + layer.velocity[lo:hi]
        self.stats["update_s"] += time.perf_counter() - t0

    # -- training-dynamics probe (obs.probes, DESIGN.md §12) -----------------

    def probe_stats(self, xb: np.ndarray, yb: np.ndarray) -> List[dict]:
        """Per-layer training-dynamics stats for one (full) batch, as the
        reference's.

        The device side reuses the step's passes only: the streamed forward
        (keeping the branch masks), the loss's dz and the dX walk with kernel
        G's backward of the activation (kernels A, B and G; no dW, so kernel
        F does not run), plus ``probes.padded_buffer_probe`` over each
        layer's (d_max, B) pre-activation and dz. No whole-layer dW is ever
        materialized, so ``grad_l2`` here is the *pre-activation* gradient
        norm (the dz buffer), a parameter-gradient proxy. Value magnitude and
        neuron-importance stats come from streamed host passes over the host
        leaves (``probes.streamed_*``, one shard-sized working set). Reads
        the weights, writes none.

        Returns a list of per-layer stat dicts ready for
        ``probes.record_snapshot(..., layers=...)``.
        """
        st = self.state
        n = st.n_layers
        if xb.shape[0] != self.B:
            raise ValueError(
                f"probe_stats needs a full batch of {self.B} rows, got "
                f"{xb.shape[0]}: padded batch columns would pollute the "
                f"saturation/gradient reductions"
            )
        with obs.span("xl.probe", layers=n):
            zstats: list = []
            self._loss_and_dz(xb, yb, train=True, preact_stats=zstats)
            gstats: List = [None] * n
            gstats[n - 1] = probes.padded_buffer_probe(self.dz, st.layers[n - 1].out_dim)[1:]
            for l in range(n - 1, 0, -1):
                in_dim = st.layers[l].in_dim
                self.acc[:in_dim].zero_()
                for _, window, vals, gather in self._stream(l, "dx", values=True, runs=False):
                    xl_shard_acc(self.acc, self.dz, vals, gather, n_segments=self.d_max,
                                 window=window)
                all_relu_bwd(self.acc[:in_dim], self.mask[l - 1][:in_dim],
                             self._slopes[l - 1], dz_out=self.dz[:in_dim],
                             dbias_out=self.dbias[:in_dim])
                gstats[l - 1] = probes.padded_buffer_probe(self.dz, in_dim)[1:]
            dev = [torch.stack([*zstats[l], *gstats[l]]) for l in range(n)]
            host = torch.stack(dev).cpu().numpy()  # the probe's one sync
            self._note_bytes(2 * n + 3)
        layers = []
        for l in range(n):
            layer = st.layers[l]
            sat, z_l2, g_l2, g_zero = (float(a) for a in host[l])
            row = {
                "saturation": sat,
                "preact_l2": z_l2,
                "grad_l2": g_l2,
                "grad_zero_frac": g_zero,
            }
            row.update(probes.streamed_value_stats(layer.values))
            row.update(probes.streamed_importance_quantiles(layer.values, layer.cols,
                                                            layer.out_dim))
            layers.append(row)
        return layers


def analysis_programs():
    """Registry hook: the two streamed shard programs — the ONLY device
    products the out-of-core substrate runs — at the reference's audit
    scale (d_max=32, B=8, one 128-slot shard of 64-wide chunks) and
    contracts. They take the reference's operands; the shard's window
    (``kernels.ops.shard_window``: its segment offsets, kernel A's route
    and kernel F's runs) is made on the host when the program is built, as
    the stream makes it with each shard, and passed in, so the program
    reads no segment id back from the device. Without a window the shard
    product makes it from ``segment_idx`` itself: one device sync, by
    design, outside the stream's hot path."""
    from repro_torch.analysis.registry import AuditProgram, Contract, ProgramSpec
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import make_xl_shard_acc, make_xl_shard_dw, shard_window

    d_max, B, cap, chunk = 32, 8, 128, 64

    def operands(device):
        dev = resolve_device(device)
        idx = torch.arange(cap, dtype=torch.int32, device=dev)
        return dev, idx % d_max, torch.sort(idx % d_max).values

    def build_acc(device=None) -> AuditProgram:
        dev, gather_idx, segment_idx = operands(device)
        args = (
            torch.zeros((d_max, B), dtype=torch.float32, device=dev),  # acc (donated)
            torch.zeros((d_max, B), dtype=torch.float32, device=dev),  # srcT
            torch.zeros((cap,), dtype=torch.float32, device=dev),      # values
            gather_idx,
            segment_idx,                                               # sorted
        )
        return AuditProgram(
            make=lambda donate: make_xl_shard_acc(donate=donate),
            args=args,
            kwargs={"n_segments": d_max, "chunk": chunk,
                    "window": shard_window(segment_idx, d_max)},
            meta={"d_max": d_max, "batch": B, "capacity": cap},
        )

    def build_dw(device=None) -> AuditProgram:
        dev, rows, cols = operands(device)
        args = (
            torch.zeros((d_max, B), dtype=torch.float32, device=dev),  # xT
            torch.zeros((d_max, B), dtype=torch.float32, device=dev),  # dyT
            rows,
            cols,                                                      # sorted
        )
        return AuditProgram(
            make=lambda donate: make_xl_shard_dw(donate=donate),
            args=args,
            kwargs={"chunk": chunk, "window": shard_window(cols, d_max, rows=rows)},
            meta={"d_max": d_max, "batch": B, "capacity": cap},
        )

    shard_contract = dict(
        # sorted segment sums only: ZERO unsorted scatters anywhere in the
        # streamed substrate, forward or backward
        max_unsorted_scatter=0,
        max_intermediate_elems=4 * chunk * B,
        max_temp_bytes=1024 * 1024,
        expected_compiles=1,
    )
    return [
        ProgramSpec(
            name="xl.shard_acc",
            subsystem=__name__,
            contract=Contract(donate_argnums=(0,), **shard_contract),
            build=build_acc,
            notes="one program for streamed fwd AND dX; acc donated",
            kernels=("xl_shard_acc",),
        ),
        ProgramSpec(
            name="xl.shard_dw",
            subsystem=__name__,
            contract=Contract(**shard_contract),
            build=build_dw,
            notes="per-shard dW batch contraction; all inputs reused",
            kernels=("xl_shard_dw",),
        ),
    ]
