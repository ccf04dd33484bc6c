"""On-device training-dynamics probes. Twin of ``repro.obs.probes``
(DESIGN.md §12).

The spans observe the *machinery*; this module observes the *model*:
per-layer gradient and value norms, zero-fractions, All-ReLU
pre-activation saturation, in/out-degree histograms, prune/regrow churn,
and neuron-importance quantiles — the distributional signals whose silent
drift is how sparse training fails (dead layers, regrowth collapse,
importance concentration).

Two strictly separated halves:

* **Device reductions** (everything above :func:`record_snapshot`) —
  functions of tensors already on the device, returning device tensors:
  nothing in them reads a value on the host (no ``.item()``, no
  ``nonzero``, no ``bincount``, whose CUDA version reads the largest index
  on the host), so they add no synchronisation. The trainer runs them behind
  ``probe=True`` (``train.trainer.make_segment_program``,
  ``core.wasap.make_phase1_epoch_fn``); with ``probe=False`` nothing here
  runs. Each sums in one fixed order: the importance sums |w| over a
  column's slots in slot order (``torch.segment_reduce`` over the column
  offsets), never with float atomics, so a probe gives the same bits every
  run; degree counts are integer sums, exact in any order. Accumulation is
  f32, ``torch.quantile`` interpolates linearly, as ``jnp.quantile`` does.
* **Host-side recording** (:func:`record_snapshot` and below, copied from
  the reference) — converts a device probe dict to plain floats (the one
  host synchronisation), writes it to the active
  :mod:`repro_torch.obs.timeline`, and feeds the
  :mod:`repro_torch.obs.detect` monitor.

Stat taxonomy (per layer; keys are the timeline schema):

====================  =====================================================
``grad_l2``           L2 norm of the sparse-weight gradient (probe batch)
``grad_zero_frac``    fraction of exactly-zero gradient entries
``value_l2``          L2 norm of the live sparse weights
``value_zero_frac``   fraction of exactly-zero live weights
``saturation``        fraction of pre-activations <= 0 (AllReLU negative
                      branch / ReLU dead zone; logit sign balance for the
                      output layer)
``imp_q10/q50/q90``   quantiles of the paper's neuron importance
                      (sum_j |w_ij| per output neuron)
``dead_out_frac``     output neurons with zero in-degree
``dead_in_frac``      input neurons with zero out-degree
``in_deg_hist``       log2-bucketed in-degree histogram (len = HIST_BINS)
``out_deg_hist``      log2-bucketed out-degree histogram
``churn_frac``        pruned links / nnz at the last evolution (host-merged
                      by :func:`record_snapshot`, not computed here)
====================  =====================================================

Degree/importance stats need COO coordinates, so they are emitted for the
``element`` impl only (an ``ElemTopoArrays`` topology); block, masked and
dense layers carry the value/grad/saturation subset, as the reference's
docstring states (its code takes a block topology's arrays for COO ones
and fails on them).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.importance import neuron_importance_jnp
from repro_torch.obs import _state, detect, timeline
from repro_torch.tree import tree_flatten

__all__ = [
    "IMPORTANCE_QS",
    "HIST_BINS",
    "value_l2",
    "zero_fraction",
    "saturation_fraction",
    "grad_sq_norm_tree",
    "importance_quantiles",
    "degree_histogram",
    "dead_fraction",
    "layer_value_stats",
    "segment_probe",
    "padded_buffer_probe",
    "probe_compile_counts",
    "snapshot_layers",
    "streamed_value_stats",
    "streamed_importance_quantiles",
    "record_snapshot",
    "set_snapshot_transform",
    "zero_layer_transform",
    "scale_grads_transform",
]

IMPORTANCE_QS = (0.1, 0.5, 0.9)
HIST_BINS = 8  # log2 degree buckets: [0], [1], [2-3], [4-7], ... [128+]


# ---------------------------------------------------------------------------
# device reductions
# ---------------------------------------------------------------------------


def value_l2(v: torch.Tensor) -> torch.Tensor:
    """L2 norm, accumulated in f32 regardless of storage dtype."""
    return torch.sqrt(torch.sum(torch.square(v.float())))


def zero_fraction(v: torch.Tensor) -> torch.Tensor:
    """Fraction of exactly-zero entries (pruned-but-resident slots)."""
    return torch.mean((v == 0).float())


def saturation_fraction(z: torch.Tensor) -> torch.Tensor:
    """Fraction of pre-activations in the non-positive branch."""
    return torch.mean((z <= 0).float())


def grad_sq_norm_tree(grads: Any) -> torch.Tensor:
    """Total squared gradient norm over a tree — the paper's Fig 5
    gradient-flow statistic (first-order loss decrease)."""
    leaves, _ = tree_flatten(grads)
    return sum(torch.sum(torch.square(l.float())) for l in leaves)


def importance_quantiles(
    values: torch.Tensor, cols: torch.Tensor, out_dim: int,
    qs: Sequence[float] = IMPORTANCE_QS, col_ptr: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Quantiles of the paper's neuron importance: sum of |w| into each
    output neuron (``core.importance.neuron_importance_jnp`` of the f32
    values), then ``torch.quantile`` (linear interpolation). ``col_ptr``
    are the column offsets of a column-sorted ``cols`` (an element
    topology's canonical order); without them the slots are sorted by
    column (stably) first."""
    imp = neuron_importance_jnp(values.float(), cols, out_dim, col_ptr=col_ptr)
    return torch.quantile(imp, torch.tensor(qs, dtype=torch.float32, device=imp.device))


def _degrees(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Links per neuron: an integer sum, exact in any order."""
    deg = torch.zeros((dim,), dtype=torch.int64, device=idx.device)
    return deg.index_add_(0, idx.long(), torch.ones_like(idx, dtype=torch.int64))


def degree_histogram(
    idx: torch.Tensor, dim: int, bins: int = HIST_BINS
) -> torch.Tensor:
    """Log2-bucketed degree histogram over ``dim`` neurons: bucket 0 holds
    degree-0 (dead) neurons, bucket b holds degrees in [2^(b-1), 2^b).
    int32, as the reference's."""
    deg = _degrees(idx, dim)
    bucket = torch.where(
        deg == 0,
        torch.zeros_like(deg),
        1 + torch.floor(torch.log2(deg.float())).long(),
    )
    bucket = torch.clamp(bucket, 0, bins - 1)
    hist = torch.zeros((bins,), dtype=torch.int64, device=idx.device)
    return hist.index_add_(0, bucket, torch.ones_like(bucket)).int()


def dead_fraction(idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Fraction of ``dim`` neurons no link touches (degree zero)."""
    return torch.mean((_degrees(idx, dim) == 0).float())


def layer_value_stats(v: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The value-only stat subset, for paths without grads/topology."""
    return {"value_l2": value_l2(v), "value_zero_frac": zero_fraction(v)}


def segment_probe(
    params: Dict[str, Any],
    grads: Dict[str, Any],
    topo_arrays: Sequence[Any],
    preacts: Sequence[torch.Tensor],
    layer_dims: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Composed per-layer probe, run after the ``probe=True`` segment's
    extra forward and backward. Returns a dict of stacked ``(n_layers,)``
    device tensors (plus ``(n_layers, HIST_BINS)`` histograms for the
    element impl) — O(n_layers) numbers, read on the host only by
    :func:`record_snapshot`.
    """
    from repro_torch.core.sparsity import ElemTopoArrays, registered_offsets

    n_layers = len(layer_dims) - 1
    element = all(isinstance(t, ElemTopoArrays) for t in topo_arrays)
    out: Dict[str, List[torch.Tensor]] = {
        "grad_l2": [], "grad_zero_frac": [],
        "value_l2": [], "value_zero_frac": [], "saturation": [],
    }
    if element:
        for k in ("imp_q10", "imp_q50", "imp_q90", "dead_out_frac",
                  "dead_in_frac", "in_deg_hist", "out_deg_hist"):
            out[k] = []
    for l in range(n_layers):
        v = params["values"][l]
        g = grads["values"][l]
        out["grad_l2"].append(value_l2(g))
        out["grad_zero_frac"].append(zero_fraction(g))
        out["value_l2"].append(value_l2(v))
        out["value_zero_frac"].append(zero_fraction(v))
        out["saturation"].append(saturation_fraction(preacts[l]))
        if element:
            rows, cols = topo_arrays[l].rows, topo_arrays[l].cols
            in_dim, out_dim = layer_dims[l], layer_dims[l + 1]
            q = importance_quantiles(v, cols, out_dim, col_ptr=registered_offsets(cols))
            out["imp_q10"].append(q[0])
            out["imp_q50"].append(q[1])
            out["imp_q90"].append(q[2])
            out["dead_out_frac"].append(dead_fraction(cols, out_dim))
            out["dead_in_frac"].append(dead_fraction(rows, in_dim))
            out["in_deg_hist"].append(degree_histogram(cols, out_dim))
            out["out_deg_hist"].append(degree_histogram(rows, in_dim))
    return {k: torch.stack(vs) for k, vs in out.items()}


# every (shape, dtype) padded_buffer_probe has been called with
_PADDED_SHAPES: set = set()


def padded_buffer_probe(z: torch.Tensor, n_valid_rows: torch.Tensor):
    """Stats over a ``(d_max, batch)`` padded XL buffer, masking the
    padding rows. ``n_valid_rows`` is a tensor (on ``z``'s device, or a
    CPU scalar), so nothing is read on the host and one buffer shape serves
    every layer of a run (shapes are uniform at ``d_max``).
    Returns ``(saturation, l2, zero_frac)`` over the valid region, as
    0-d device tensors."""
    _PADDED_SHAPES.add((tuple(z.shape), str(z.dtype)))
    n_valid = torch.as_tensor(n_valid_rows).to(z.device)
    valid = (torch.arange(z.shape[0], device=z.device)[:, None] < n_valid)
    zf = z.float()
    denom = (n_valid * z.shape[1]).float()
    sat = torch.sum((zf <= 0) & valid) / denom
    l2 = torch.sqrt(torch.sum(torch.where(valid, torch.square(zf), torch.zeros_like(zf))))
    zero = torch.sum((zf == 0) & valid) / denom
    return sat, l2, zero


def probe_compile_counts() -> Dict[str, int]:
    """The number of distinct (shape, dtype) :func:`padded_buffer_probe`
    has been called with since import — the port's form of the reference's
    jit-cache size, as ``xl.stream.compile_counts`` counts the substrate's
    buffers: probing more layers must not grow it."""
    return {"obs_padded_buffer_probe": len(_PADDED_SHAPES)}


# ---------------------------------------------------------------------------
# host-side numpy probes (XL shard streaming, LM example; copied)
# ---------------------------------------------------------------------------


def streamed_value_stats(
    values: np.ndarray, shard_rows: int = 1 << 20
) -> Dict[str, float]:
    """Host pass over a (possibly huge) value vector in bounded slices —
    the XL path's values live host-side, so the O(capacity) working set
    must never be materialized as a float64 temp all at once."""
    sq = 0.0
    zeros = 0
    n = int(values.shape[0])
    for lo in range(0, n, shard_rows):
        v = np.asarray(values[lo:lo + shard_rows], dtype=np.float64)
        sq += float(np.sum(v * v))
        zeros += int(np.count_nonzero(v == 0))
    return {
        "value_l2": float(np.sqrt(sq)),
        "value_zero_frac": zeros / max(1, n),
    }


def streamed_importance_quantiles(
    values: np.ndarray, cols: np.ndarray, out_dim: int,
    qs: Sequence[float] = IMPORTANCE_QS, shard_rows: int = 1 << 20,
) -> Dict[str, float]:
    """Shard-streamed neuron importance (|w| bincount by output column) +
    quantiles, host-side for XL layers."""
    imp = np.zeros((out_dim,), np.float64)
    n = int(values.shape[0])
    for lo in range(0, n, shard_rows):
        v = np.abs(np.asarray(values[lo:lo + shard_rows], np.float64))
        c = np.asarray(cols[lo:lo + shard_rows], np.int64)
        imp += np.bincount(c, weights=v, minlength=out_dim)
    q10, q50, q90 = (float(np.quantile(imp, q)) for q in qs)
    return {"imp_q10": q10, "imp_q50": q50, "imp_q90": q90,
            "dead_out_frac": float(np.mean(imp == 0))}


# ---------------------------------------------------------------------------
# host-side recording (copied) — between device calls, never inside one
# ---------------------------------------------------------------------------


_snapshot_transform: Optional[Callable[[str, int, List[dict]], List[dict]]] \
    = None


def set_snapshot_transform(
    fn: Optional[Callable[[str, int, List[dict]], List[dict]]]
) -> None:
    """Install a host-side transform applied to every snapshot's layer
    stats before recording — the CI pathology harness uses this to inject
    dead layers / exploded gradients into an otherwise-healthy run without
    touching the training math. ``fn(kind, step, layers) -> layers``;
    ``None`` removes it."""
    global _snapshot_transform
    _snapshot_transform = fn


def zero_layer_transform(layer: int = 0):
    """Pathology: report layer ``layer`` as dead (zero value/grad mass)."""
    def fn(kind, step, layers):
        if 0 <= layer < len(layers):
            st = dict(layers[layer])
            for k in ("value_l2", "grad_l2", "imp_q10", "imp_q50", "imp_q90"):
                if k in st:
                    st[k] = 0.0
            layers = list(layers)
            layers[layer] = st
        return layers
    return fn


def scale_grads_transform(factor: float = 1e6):
    """Pathology: report every layer's gradient norm scaled by ``factor``
    (a loss-scale blow-up / fp overflow signature)."""
    def fn(kind, step, layers):
        out = []
        for st in layers:
            st = dict(st)
            if "grad_l2" in st:
                st["grad_l2"] = float(st["grad_l2"]) * factor
            out.append(st)
        return out
    return fn


def snapshot_layers(probe: Dict[str, Any]) -> List[dict]:
    """Convert a device probe dict (stacked ``(L,)`` / ``(L, bins)``
    tensors) into a list of per-layer plain-python stat dicts: the one
    host synchronisation of a probe."""
    host = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in probe.items()}
    n_layers = next(iter(host.values())).shape[0]
    layers: List[dict] = []
    for l in range(n_layers):
        st: Dict[str, Any] = {}
        for k, a in host.items():
            if a.ndim == 1:
                st[k] = float(a[l])
            else:
                st[k] = [int(x) for x in a[l]]
        layers.append(st)
    return layers


def record_snapshot(
    step: int,
    kind: str,
    probe: Optional[Dict[str, Any]] = None,
    *,
    layers: Optional[List[dict]] = None,
    churn: Optional[Sequence[float]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[dict]:
    """Record one training-dynamics snapshot, host-side.

    Accepts either a device probe dict (converted via
    :func:`snapshot_layers` — this is the one host sync) or pre-built ``layers``.
    ``churn`` merges per-layer ``churn_frac`` values in. The snapshot is
    written to the active timeline (if any), fed to the anomaly monitor
    (if any), and any newly fired alerts are appended to the timeline.
    Returns the snapshot dict, or ``None`` under ``obs.disabled()``.

    Runs between device calls, never inside one.
    """
    if not _state.is_enabled():
        return None
    if layers is None:
        layers = snapshot_layers(probe) if probe is not None else []
    else:
        layers = [dict(st) for st in layers]
    if churn is not None:
        for st, c in zip(layers, churn):
            st["churn_frac"] = float(c)
    if _snapshot_transform is not None:
        layers = _snapshot_transform(kind, int(step), layers)
    snap = {
        "step": int(step), "kind": str(kind), "layers": layers,
        "extra": dict(extra) if extra else {},
    }
    _state.note_alloc()
    writer = timeline.current()
    if writer is not None:
        writer.record(snap["step"], snap["kind"], layers, extra=snap["extra"])
    monitor = detect.get_monitor()
    if monitor is not None:
        fired = monitor.observe(
            snap["step"], snap["kind"], layers, extra=snap["extra"]
        )
        if writer is not None:
            for alert in fired:
                writer.alert(alert.to_dict())
    return snap
