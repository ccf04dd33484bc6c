"""Deployment-time compaction (the paper's Table 6 Importance Pruning as a
serving feature).

Twin of ``repro.serve.compact``, on host numpy as in the reference. Element
(COO) granularity, the SET-MLP serving path:

1. **Importance pruning** (``importance_prune_mlp``) — the *lossy* stage:
   neurons whose strength (Eq. 4) falls below a percentile/absolute threshold
   are removed wholesale — incoming connections, bias, and outgoing
   connections (cascade).

2. **Dead-neuron elimination** (``eliminate_dead_neurons``) — the *lossless*
   stage: hidden neurons with zero out-degree, or zero in-degree with zero
   bias (they emit ``act(0) == 0``), are physically removed and the COO
   arrays and layer dims shrink. Removing a zero contribution never changes a
   surviving segment sum that is taken left to right in slot order, which is
   how kernel A sums, so the compacted model's logits are bit-equal to its
   input model's on the card as on the CPU. Elimination cascades, so the
   pass iterates to a fixpoint.

Block granularity, the LM's sparse FFN (:func:`compact_block_lm`): per
repeat, ``importance_prune_block`` zeroes the weak neurons' columns of
``win`` and frees its empty blocks; the pruned neurons' rows of ``wout``
are zeroed and its empty blocks freed; every block-column keeps at least one
slot (the coverage invariant). The stacked repeats of a slot must share one
block count, so each is re-padded to the slot's largest surviving count with
zero-valued blocks at positions it freed, and re-sorted into canonical
(col, row) order. A removed zero block adds exact zeros, so beyond the
pruning decision the compacted forward computes what the uncompacted one
does with those blocks zeroed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.all_relu import activation_fn
from repro_torch.core.importance import (
    PruningSchedule,
    element_degrees,
    importance_prune_block,
    importance_prune_element,
)
from repro_torch.core.sparsity import BlockMeta, BlockTopology, ElementTopology
from repro_torch.models.mlp import SparseMLP

__all__ = [
    "CompactionReport",
    "compact_block_lm",
    "compact_element_mlp",
    "eliminate_dead_neurons",
    "importance_prune_mlp",
]


@dataclasses.dataclass
class CompactionReport:
    params_before: int
    params_after: int
    dims_before: Tuple[int, ...]
    dims_after: Tuple[int, ...]
    pruned_neurons: int = 0       # removed by the lossy importance stage
    eliminated_neurons: int = 0   # removed by the lossless dead-neuron stage
    rounds: int = 0

    @property
    def shrink(self) -> float:
        return 1.0 - self.params_after / max(1, self.params_before)


def _host_f32(t: torch.Tensor) -> np.ndarray:
    # f32 staging is exact for bf16/f16 values, and each layer's dtype is
    # restored afterwards, so the host stages stay bitwise lossless
    return t.detach().to("cpu", torch.float32).numpy().copy()


def importance_prune_mlp(
    model: SparseMLP, schedule: PruningSchedule
) -> Tuple[SparseMLP, int]:
    """Post-training Importance Pruning with *serving* semantics: a pruned
    neuron is deleted from the network — incoming connections, bias, and
    outgoing connections all go — rather than left emitting ``act(bias)``.
    Returns (pruned model, number of pruned neurons). Output units are
    protected (paper protocol); dims are unchanged — the physical shrink
    happens in :func:`eliminate_dead_neurons`."""
    cfg = model.config
    topos = list(model.topos)
    dtypes = [v.dtype for v in model.values]
    bias_dtypes = [b.dtype for b in model.biases]
    values = [_host_f32(v) for v in model.values]
    biases = [_host_f32(b) for b in model.biases]
    n_pruned = 0
    pruned_prev: Optional[np.ndarray] = None
    for l in range(cfg.n_layers):
        topo = topos[l]
        # cascade: outgoing connections of neurons pruned at layer l-1
        if pruned_prev is not None and pruned_prev.size:
            keep = ~np.isin(topo.rows, pruned_prev)
            topo = ElementTopology(
                topo.in_dim, topo.out_dim, topo.rows[keep], topo.cols[keep]
            )
            values[l] = values[l][keep]
        if l == cfg.n_layers - 1:  # output layer: cascade only
            topos[l] = topo
            pruned_prev = None
            continue
        res = importance_prune_element(topo, values[l], schedule)
        topos[l] = res.topology
        values[l] = res.values
        biases[l][res.pruned_neurons] = 0.0  # neuron removed wholesale
        n_pruned += int(res.pruned_neurons.size)
        pruned_prev = res.pruned_neurons
    out = SparseMLP.from_state(
        cfg, topos,
        [torch.as_tensor(v).to(dt) for v, dt in zip(values, dtypes)],
        [torch.as_tensor(b).to(dt) for b, dt in zip(biases, bias_dtypes)],
        device=model.device,
    )
    return out, n_pruned


def eliminate_dead_neurons(
    model: SparseMLP, *, max_rounds: int = 16
) -> Tuple[SparseMLP, CompactionReport]:
    """Physically remove dead hidden neurons and shrink the COO arrays.

    Dead = out-degree 0 (output never consumed), or in-degree 0 with zero
    bias *when* ``act(0) == 0`` for that layer's activation (true for
    All-ReLU at every parity). Input features and output units are never
    touched. Bit-equivalent to the input model by construction; iterates to
    a fixpoint because each removal can create new dead neurons one layer
    up (out-degree drops) or down (in-degree drops)."""
    cfg = model.config
    act = activation_fn(cfg.activation, alpha=cfg.alpha)
    dims = list(cfg.layer_dims)
    topos = list(model.topos)
    dtypes = [v.dtype for v in model.values]
    values = [_host_f32(v) for v in model.values]
    biases = [_host_f32(b) for b in model.biases]
    bias_dtypes = [b.dtype for b in model.biases]
    params_before = sum(t.nnz for t in topos) + sum(b.size for b in biases)
    dims_before = tuple(dims)
    eliminated = 0
    rounds = 0
    for rounds in range(1, max_rounds + 1):
        changed = False
        for h in range(1, len(dims) - 1):  # hidden layers only
            l_in, l_out = h - 1, h  # incoming / outgoing matrices
            _, in_deg = element_degrees(topos[l_in])
            out_deg, _ = element_degrees(topos[l_out])
            # act(0) must be exactly 0 for the constant-neuron rule; the
            # paper's hidden activations use 1-based layer parity
            act0 = float(act(torch.zeros(()), h))
            dead = out_deg == 0
            if act0 == 0.0:
                dead |= (in_deg == 0) & (biases[l_in] == 0.0)
            if dead.all():
                # keep one neuron so downstream shapes stay non-degenerate
                dead[0] = False
            if not dead.any():
                continue
            changed = True
            eliminated += int(dead.sum())
            keep_ids = np.flatnonzero(~dead)
            remap = np.full(dims[h], -1, np.int64)
            remap[keep_ids] = np.arange(keep_ids.size)
            # incoming matrix: drop dead columns, renumber the rest
            k = ~dead[topos[l_in].cols]
            topos[l_in] = ElementTopology(
                dims[h - 1], keep_ids.size,
                topos[l_in].rows[k], remap[topos[l_in].cols[k]],
            )
            values[l_in] = values[l_in][k]
            biases[l_in] = biases[l_in][keep_ids]
            # outgoing matrix: drop dead rows, renumber the rest
            k = ~dead[topos[l_out].rows]
            topos[l_out] = ElementTopology(
                keep_ids.size, dims[h + 1],
                remap[topos[l_out].rows[k]], topos[l_out].cols[k],
            )
            values[l_out] = values[l_out][k]
            dims[h] = keep_ids.size
        if not changed:
            break
    new_cfg = dataclasses.replace(cfg, layer_dims=tuple(dims))
    out = SparseMLP.from_state(
        new_cfg, topos,
        [torch.as_tensor(v).to(dt) for v, dt in zip(values, dtypes)],
        [torch.as_tensor(b).to(dt) for b, dt in zip(biases, bias_dtypes)],
        device=model.device,
    )
    report = CompactionReport(
        params_before=params_before,
        params_after=sum(t.nnz for t in topos) + sum(b.size for b in biases),
        dims_before=dims_before,
        dims_after=tuple(dims),
        eliminated_neurons=eliminated,
        rounds=rounds,
    )
    return out, report


def compact_element_mlp(
    model: SparseMLP, schedule: Optional[PruningSchedule] = None
) -> Tuple[SparseMLP, CompactionReport]:
    """The full deployment-time compaction: optional lossy importance pruning
    followed by lossless dead-neuron elimination. The report's
    ``params_before`` counts the *original* model, so ``shrink`` covers both
    stages."""
    before = model.n_params
    pruned = 0
    if schedule is not None:
        model, pruned = importance_prune_mlp(model, schedule)
    out, report = eliminate_dead_neurons(model)
    report.pruned_neurons = pruned
    report.params_before = before
    return out, report


# ---------------------------------------------------------------------------
# block granularity — the LM's sparse FFN
# ---------------------------------------------------------------------------


def _free_empty_blocks(
    topo: BlockTopology, values: np.ndarray
) -> Tuple[np.ndarray, BlockTopology, np.ndarray]:
    """Keep mask freeing all-zero blocks while preserving >= 1 slot per
    output block-column (the coverage invariant: every output tile has a
    slot that writes it)."""
    empty = np.abs(values).sum(axis=(1, 2)) == 0
    col_counts = np.bincount(topo.cols, minlength=topo.meta.grid_n)
    keep = np.ones(topo.n_blocks, bool)
    for i in np.flatnonzero(empty):
        c = topo.cols[i]
        if col_counts[c] > 1:
            keep[i] = False
            col_counts[c] -= 1
    return keep, BlockTopology(topo.meta, topo.rows[keep], topo.cols[keep]), values[keep]


def _repad_blocks(
    meta: BlockMeta,
    rows: np.ndarray,
    cols: np.ndarray,
    values: np.ndarray,
    dropped_rows: np.ndarray,
    dropped_cols: np.ndarray,
    target: int,
) -> Tuple[BlockTopology, np.ndarray]:
    """Resurrect ``target - kept`` previously dropped positions as zero-valued
    blocks so every rep of a stacked slot keeps the same n_blocks."""
    need = target - rows.size
    if need > 0:
        rows = np.concatenate([rows, dropped_rows[:need]])
        cols = np.concatenate([cols, dropped_cols[:need]])
        values = np.concatenate(
            [values, np.zeros((need,) + values.shape[1:], values.dtype)]
        )
    order = np.lexsort((rows, cols))  # canonical (col, row) order
    return BlockTopology(meta, rows[order], cols[order]), values[order]


def compact_block_lm(model, schedule: PruningSchedule) -> CompactionReport:
    """Compact a sparse-FFN ``PatternLM`` in place: per rep, importance-prune
    ``win`` (zero weak neuron columns, free empty blocks), zero the pruned
    neurons' rows in ``wout`` and free its empty blocks, then re-pad each
    slot's reps to a uniform block count so the stacked shapes hold. The new
    weights go back to the model's device in its dtype; the caller makes
    the topology arrays afterwards (``model.topo_arrays()``), from which
    kernel C plans for the new block counts. Lossless beyond the pruning
    decision itself: pruned neurons emit ``act(0) == 0``, so zeroed and
    freed blocks contribute nothing.

    Only the pattern's stacked slots are compacted, as in the reference; a
    model with remainder layers raises ``ValueError``."""
    rest = [slot for slot in model.topologies if slot not in model.params["stack"]]
    if rest:
        raise ValueError(f"compact_block_lm compacts the stacked slots; {rest} are not")
    params = model.params
    before = _lm_live_params(model)
    dims = (model.cfg.d_model, model.cfg.d_ff)
    pruned_total = 0
    for slot, topo_list in model.topologies.items():
        ffn = params["stack"][slot]["ffn"]
        win, wout = _host_f32(ffn["win"]), _host_f32(ffn["wout"])
        kept: List[Tuple] = []
        for r, (t_in, t_out) in enumerate(topo_list):
            meta_out = t_out.meta
            res = importance_prune_block(t_in, win[r], schedule)
            pruned_total += int(res.pruned_neurons.size)
            keep_in = _keep_mask_from(t_in, res.topology)
            # wout: zero the pruned neurons' rows (their input is act(0)=0)
            v_out = wout[r].copy()
            pr_blocks = res.pruned_neurons // meta_out.block_m
            pr_offs = res.pruned_neurons % meta_out.block_m
            for b, o in zip(pr_blocks, pr_offs):
                v_out[t_out.rows == b, o, :] = 0.0
            keep_out, t_out2, v_out2 = _free_empty_blocks(t_out, v_out)
            kept.append((res.topology, res.values, t_in, keep_in, t_out2, v_out2, t_out,
                         keep_out))
        nb_in = max(k[0].n_blocks for k in kept)
        nb_out = max(k[4].n_blocks for k in kept)
        new_topos, win_new, wout_new = [], [], []
        for t_in2, v_in2, t_in, keep_in, t_out2, v_out2, t_out, keep_out in kept:
            ti, vi = _repad_blocks(t_in.meta, t_in2.rows, t_in2.cols, v_in2,
                                   t_in.rows[~keep_in], t_in.cols[~keep_in], nb_in)
            to, vo = _repad_blocks(t_out.meta, t_out2.rows, t_out2.cols, v_out2,
                                   t_out.rows[~keep_out], t_out.cols[~keep_out], nb_out)
            new_topos.append((ti, to))
            win_new.append(vi)
            wout_new.append(vo)
        model.topologies[slot] = new_topos
        for name, new in (("win", win_new), ("wout", wout_new)):
            old = ffn[name]
            ffn[name] = torch.as_tensor(np.stack(new)).to(device=old.device, dtype=old.dtype)
    # the model's memoized per-layer views belong to the old tensors
    model._views = model._topo_views = None
    return CompactionReport(
        params_before=before,
        params_after=_lm_live_params(model),
        dims_before=dims,
        dims_after=dims,
        pruned_neurons=pruned_total,
    )


def _keep_mask_from(old: BlockTopology, new: BlockTopology) -> np.ndarray:
    """Boolean mask over old slots marking those surviving in ``new``."""
    old_flat = old.rows.astype(np.int64) * old.meta.grid_n + old.cols
    new_flat = new.rows.astype(np.int64) * new.meta.grid_n + new.cols
    return np.isin(old_flat, new_flat)


def _lm_live_params(model) -> int:
    """The sparse FFN's nonzero weights over every stacked slot."""
    total = 0
    for slot in model.topologies:
        ffn = model.params["stack"][slot]["ffn"]
        total += int(torch.count_nonzero(ffn["win"]))
        total += int(torch.count_nonzero(ffn["wout"]))
    return total
