"""WASAP-SGD (paper Algorithm 1) on one card. Twin of ``repro.core.wasap``.

Phase 1 (paper: async parameter server) is **local SGD with periodic sparse
model averaging**: K workers take H local momentum-SGD steps on their data
shards, then weights (and momentum) are averaged. H > 1 reproduces
asynchrony's communication avoidance and staleness; H = 1 with the Goyal
warmup / linear-scaling schedule is the paper's synchronous control,
WASSP-SGD.

Phase 1 runs device-resident: the training set lives on the device, and
the host ships only each worker shard's epoch permutation
(``ShardedLoader.epoch_order``), per-step learning rates and validity
weights (tail rounds are padded to a fixed H, and a padded step leaves the
state exactly as it was). PyTorch runs eagerly, so the reference's jitted
scan over sync rounds is a loop over rounds, and its vmap over the worker
axis is a loop over the K workers inside each round: each worker starts
from the round's averaged state and runs H masked steps
(``launch.steps.scan_masked_segment``) on kernels A and F; the K results
are stacked and averaged in worker order (a sum over workers 0..K-1, then
``/ K``, as ``jnp.mean`` reduces). ``torch.func.vmap`` cannot batch these
steps: they launch ctypes-bound kernels through a ``torch.autograd.
Function``, which has no batching rule. ``worker_axis="vmap"`` is that
loop; ``"shard_map"`` (the pod program) raises until the pod machinery
(ROADMAP Queue 1, item 9: ``torch.distributed``).

The master's SET evolution between phase-1 epochs runs on the device on
fixed-capacity arrays (``core.topology.evolve_element_layers_device``),
with no host sync; values are re-aligned to the evolved topology before
the workers resume (the paper's ``RetainValidUpdates``, Algorithm 1 line
14). The host mirror (``model.topos``) is synced once, after phase 1:
``n_params`` in the history reads it, which is right because SET keeps the
connection count.

Phase 2: each worker trains **locally** on fused epoch segments
(``train.trainer.make_segment_program``) from fresh velocity at the
constant ``lr``, and evolves its own topology on the device from its own
generator; at the end the K sparse models are averaged over the union of
their topologies and re-sparsified to the target connection count by the
paper's sign-aware magnitude rule (Algorithm 1, line 37), on the host.

Randomness: dropout and device evolution draw from ``torch.Generator``\\ s
(phase 1 from the trainer's one generator, in the order round, worker,
step; phase 2 from one generator per worker, seeded from it). The
reference splits ``jax.random`` keys, another stream, so trajectory parity
with the reference runs at dropout 0, with device evolution fed the
reference's draws (``core.topology.evolution_draws``).

``WASAPConfig.fused=False`` keeps the seed-era round loop (per-round
dispatch, host replication, numpy batch stacking, per-batch phase 2) with
host evolution on the reference's numpy rng, so at dropout 0 it follows
the reference's own draws.

The fused path resumes at any epoch boundary (DESIGN.md §8):
``epoch_end_hook(trainer, epoch)`` runs after each epoch of either phase,
and ``save_checkpoint`` writes, in the reference's layout, the averaged
master (phase 1) or the master and every worker's params, velocity,
topology and generator state (phase 2), with the history and both random
streams; a fresh trainer restored from it (``restore_checkpoint``: the
phase, ``start_epoch``, ``_p1_state`` or ``_p2_workers``) runs on to the
same bits. The checkpoint crosses between the packages in both directions.

Observability, as the reference's: the spans ``wasap.run``,
``wasap.epoch``, ``wasap.sync_rounds`` (phase 1), ``wasap.worker_segments``
(phase 2) and ``wasap.merge``, the point ``wasap.evolve``, and with
``WASAPConfig(probe=True)`` one ``"wasap"`` snapshot per fused epoch: in
phase 1 the epoch function's probe of the averaged master on the epoch's
first batch, in phase 2 worker 0's segment probe, each with its SET churn.
A probe reads the weights and never writes them.

Not in this slice, and refused with an error naming the ROADMAP item: the
``shard_map`` worker axis (item 9); a heartbeat ``monitor`` (elastic
rounds), a ``fault_hook`` and ``step_retries`` (runtime, item 5); and
buffer donation (item 5). Its contract-auditor registration
(``analysis_programs``) comes with item 8.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sparsity import ElementTopology
from repro_torch.core.topology import (
    evolve_element,
    evolve_element_layers_device,
    prune_indices_by_magnitude,
)
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import Dataset
from repro_torch.launch.steps import (
    make_mlp_step_core,
    make_mlp_train_step,
    scan_masked_segment,
)
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, cross_entropy_loss, mlp_forward
from repro_torch.obs import probes
from repro_torch.optim.sgd import MomentumSGD, SGDState, replace_values_velocity
from repro_torch.train.trainer import (
    _params_like,
    evaluate,
    generator_entry,
    jax_key_words,
    make_segment_program,
    restore_generator,
)
from repro_torch.tree import tree_map

__all__ = [
    "WASAPConfig",
    "WASAPTrainer",
    "make_phase1_epoch_fn",
    "sparse_average_and_resparsify",
]

_SHARD_MAP = ("worker_axis='shard_map' comes with the pod machinery (ROADMAP Queue 1, item 9: "
              "torch.distributed); one card runs worker_axis='vmap'")


@dataclasses.dataclass
class WASAPConfig:
    n_workers: int = 4
    phase1_epochs: int = 6
    phase2_epochs: int = 2
    sync_every: int = 4          # H — local steps between averages (1 => WASSP)
    lr: float = 0.01
    lr_boost: float = 2.0        # paper §2.3: larger LR early in async phase
    lr_boost_epochs: int = 2
    warmup_steps: int = 50       # WASSP: Goyal et al. gradual warmup
    momentum: float = 0.9
    weight_decay: float = 2e-4
    zeta: float = 0.3
    mode: str = "wasap"          # wasap | wassp
    seed: int = 0
    batch_size: int = 32
    average_momentum: bool = True
    fused: bool = True           # device-resident epochs and SET (False: seed loop)
    worker_axis: str = "vmap"    # vmap | shard_map (refused: ROADMAP Queue 1, item 9)
    probe: bool = False          # training-dynamics probes (obs.probes, DESIGN.md §12)


# ---------------------------------------------------------------------------
# worker programs
# ---------------------------------------------------------------------------


def _average_pytree(stacked, weights=None):
    """The mean of every leaf over its leading (worker) axis, as the
    reference's ``mean(axis=0)``: a sum over workers in order 0..K-1, then
    ``/ K``. An integer leaf (the step counter) is averaged in f32, as
    ``jnp.mean`` promotes it; :func:`_cast_like` casts it back. With
    ``weights`` ((K,), renormalised to sum to 1): the sum of ``a[k] *
    w[k]`` in worker order, as the reference's ``(a * w).sum(axis=0)``."""
    if weights is None:
        def mean(a):
            a = a if a.is_floating_point() else a.float()
            acc = a[0]
            for k in range(1, a.shape[0]):
                acc = acc + a[k]
            return acc / a.shape[0]

        return tree_map(mean, stacked)
    w = weights / weights.sum()

    def wavg(a):
        acc = a[0] * w[0]
        for k in range(1, a.shape[0]):
            acc = acc + a[k] * w[k]
        return acc

    return tree_map(wavg, stacked)


def _cast_like(tree, ref):
    """Restore the reference dtypes after an averaging reduction (the mean
    promotes the int32 step counter to float; the carry must keep its
    dtypes)."""
    return tree_map(lambda a, r: a.to(r.dtype), tree, ref)


def _replicate(tree, k: int):
    return tree_map(lambda a: a.expand((k,) + tuple(a.shape)), tree)


def _take_worker0(tree):
    return tree_map(lambda a: a[0], tree)


def _stack(trees: List):
    """K worker trees as one tree of (K, ...) leaves, in worker order."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def make_phase1_epoch_fn(
    config: SparseMLPConfig,
    opt: MomentumSGD,
    *,
    n_workers: int,
    average_momentum: bool = True,
    worker_axis: str = "vmap",
    mesh=None,
    weighted: bool = False,
    donate=None,
    probe: bool = False,
):
    """Build the phase-1 epoch: sync rounds over the device-resident data.

    ``epoch_fn(params, opt_state, topo, x_all, y_all, idx, lrs, valid, keys)``

    * ``idx``   — (R, K, H, B) sample indices into the device-resident
      ``x_all``/``y_all`` (each worker shard's ``ShardedLoader.
      epoch_order``, padded to R*H steps);
    * ``lrs``/``valid`` — (R, H) per-step learning rates and validity
      weights (0 on padded tail steps: those steps run but leave the
      state untouched, so the tail round never changes a shape);
    * ``keys``  — the ``torch.Generator`` dropout draws from, in the order
      (round, worker, step).

    Each round, every worker starts from the round's state and runs its H
    masked steps (:func:`scan_masked_segment`), one worker after another;
    then the K results are averaged in worker order (:func:`
    _average_pytree`). With ``average_momentum=False`` the velocity is
    worker 0's. Returns ``(params, opt_state, loss_sums)``, ``loss_sums``
    the (R,) per-round sums of valid per-step losses, on the device: the
    epoch never syncs.

    ``weighted=True`` appends a tenth argument ``worker_w`` — (K,)
    validity weights over the worker axis, renormalised inside the average
    — so a dead worker contributes zero while the round completes with the
    survivors. ``mesh`` goes with ``worker_axis="shard_map"``, which is
    refused here (ROADMAP Queue 1, item 9), as is ``donate`` (item 5).

    ``probe=True`` appends a fourth output: the per-layer training-dynamics
    stats of ``obs.probes.segment_probe`` (device tensors), from one
    forward and backward at the epoch's final averaged weights on its first
    batch (round 0, worker 0: always a valid step), after the rounds. It
    draws nothing and writes no weight.
    """
    if worker_axis not in ("vmap", "shard_map"):
        raise ValueError(f"worker_axis must be vmap|shard_map, got {worker_axis!r}")
    if worker_axis == "shard_map":
        raise NotImplementedError(_SHARD_MAP)
    if donate is not None:
        raise NotImplementedError(
            "buffer donation comes with the runtime slice (ROADMAP Queue 1, item 5)")

    def local_steps(params, opt_state, topo, x_all, y_all, idx_h, lrs_h, valid_h, key):
        step_core = make_mlp_step_core(config, opt, topo, x_all, y_all)
        params, opt_state, _, losses = scan_masked_segment(
            step_core, params, opt_state, key, (idx_h, lrs_h), valid_h
        )
        return params, opt_state, losses.sum()

    def epoch_program(params, opt_state, topo, x_all, y_all, idx, lrs, valid, keys,
                      worker_w=None):
        if idx.shape[1] != n_workers:
            raise ValueError(f"idx has {idx.shape[1]} workers, the epoch runs {n_workers}")
        loss_sums = []
        for r in range(idx.shape[0]):
            outs = [local_steps(params, opt_state, topo, x_all, y_all, idx[r, wk], lrs[r],
                                valid[r], keys) for wk in range(n_workers)]
            sp, so = _stack([o[0] for o in outs]), _stack([o[1] for o in outs])
            new_params = _cast_like(_average_pytree(sp, worker_w), params)
            opt_state = (_cast_like(_average_pytree(so, worker_w), opt_state)
                         if average_momentum else _take_worker0(so))
            params = new_params
            loss_sums.append(torch.stack([o[2] for o in outs]).sum())
        if not probe:
            return params, opt_state, torch.stack(loss_sums)
        # probe on the epoch's first batch (round 0, worker 0: always valid;
        # padding only reaches tail rounds)
        xb, yb = x_all.index_select(0, idx[0, 0, 0]), y_all.index_select(0, idx[0, 0, 0])
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        logits, preacts = mlp_forward(leaves, topo, xb, config, train=False,
                                      return_preacts=True)
        grads = torch.autograd.grad(cross_entropy_loss(logits, yb), leaves["values"])
        stats = probes.segment_probe(params, {"values": grads}, topo,
                                     [z.detach() for z in preacts], config.layer_dims)
        return params, opt_state, torch.stack(loss_sums), stats

    if weighted:
        return epoch_program
    return functools.partial(epoch_program, worker_w=None)


def _make_worker_round(config: SparseMLPConfig, opt: MomentumSGD):
    """Seed-era round: each worker runs H local steps over stacked batches,
    ``worker_round(stacked_params, stacked_opt, topo, xs, ys, lrs, valid,
    rngs) -> (stacked_params, stacked_opt, loss_sums)`` with ``xs`` (K, H,
    B, F), ``ys`` (K, H, B), ``lrs``/``valid`` (H,) and ``rngs`` the
    ``torch.Generator`` dropout draws from, in the order (worker, step).

    Kept as the measured baseline for the fused epoch (per-round dispatch,
    host-side replication, numpy batch stacking). Tail rounds are padded to
    a fixed H with ``valid`` weights, as in the fused epoch.
    """

    def worker_round(stacked_params, stacked_opt, topo, xs, ys, lrs, valid, rngs):
        step_core = make_mlp_step_core(config, opt, topo)
        outs = []
        for wk in range(xs.shape[0]):
            params, opt_state, _, losses = scan_masked_segment(
                step_core, tree_map(lambda a: a[wk], stacked_params),
                tree_map(lambda a: a[wk], stacked_opt), rngs, (xs[wk], ys[wk], lrs), valid,
            )
            outs.append((params, opt_state, losses.sum()))
        return (_stack([o[0] for o in outs]), _stack([o[1] for o in outs]),
                torch.stack([o[2] for o in outs]))

    return worker_round


# ---------------------------------------------------------------------------
# final merge (Algorithm 1, line 37), numpy, as the reference's
# ---------------------------------------------------------------------------


def _sign_aware_drop(avg: np.ndarray, surplus: int) -> np.ndarray:
    """Indices of ``surplus`` connections to drop by the paper's sign-aware
    magnitude rule: exact zeros first, then each sign's proportional
    low-magnitude tail (the smallest positives and the largest negatives,
    via :func:`prune_indices_by_magnitude`), with any integer remainder
    topped up from the smallest remaining ``|avg|``."""
    zeros = np.flatnonzero(avg == 0)
    if zeros.size >= surplus:
        return zeros[:surplus]
    n_signed = int((avg > 0).sum() + (avg < 0).sum())
    zeta = (surplus - zeros.size) / n_signed
    drop = prune_indices_by_magnitude(avg, zeta)  # zeros + per-sign tails
    short = surplus - drop.size  # >= 0: per-sign tail sizes are floored
    if short > 0:
        rest = np.setdiff1d(np.arange(avg.size), drop)
        rest = rest[np.argsort(np.abs(avg[rest]), kind="stable")]
        drop = np.concatenate([drop, rest[:short]])
    return drop


def sparse_average_and_resparsify(
    topos: List[ElementTopology],
    values: List[np.ndarray],
    target_nnz: int,
) -> Tuple[ElementTopology, np.ndarray]:
    """Average K sparse models over the union of their topologies, then keep
    ``target_nnz`` connections by the paper's sign-aware magnitude rule
    (Algorithm 1 line 37): the surplus is pruned as exact zeros, the
    smallest-positive tail and the largest-negative tail — each sign
    contributing its proportional share — not a plain |value| ranking."""
    k = len(topos)
    if k < 1:
        raise ValueError("the merge needs at least one worker")
    in_dim, out_dim = topos[0].in_dim, topos[0].out_dim
    flat_all = np.concatenate(
        [t.rows.astype(np.int64) * out_dim + t.cols for t in topos]
    )
    val_all = np.concatenate([np.asarray(v, np.float64) for v in values])
    uniq, inv = np.unique(flat_all, return_inverse=True)
    summed = np.zeros(uniq.size, np.float64)
    np.add.at(summed, inv, val_all)
    avg = (summed / k).astype(np.float32)  # absent connections count as zero

    surplus = uniq.size - int(target_nnz)
    if surplus > 0:
        # surplus = S' - S unimportant connections pruned (Algorithm 1 l.37)
        drop = _sign_aware_drop(avg, surplus)
        keep = np.setdiff1d(np.arange(uniq.size), drop)
    else:
        keep = np.arange(uniq.size)
    rows = (uniq[keep] // out_dim).astype(np.int32)
    cols = (uniq[keep] % out_dim).astype(np.int32)
    topo = ElementTopology(in_dim, out_dim, rows, cols)
    order = np.lexsort((rows, cols))
    return topo, avg[keep][order]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class WASAPTrainer:
    """Two-phase WASAP/WASSP-SGD for SET-MLPs (element sparsity), on the
    model's device: the card unless the model was built with
    ``device="cpu"``."""

    def __init__(self, model: SparseMLP, data: Dataset, wc: WASAPConfig):
        if model.config.impl != "element":
            raise ValueError(f"the WASAP path trains element sparsity, not {model.config.impl!r}")
        if wc.worker_axis not in ("vmap", "shard_map"):
            raise ValueError(f"worker_axis must be vmap|shard_map, got {wc.worker_axis!r}")
        if wc.worker_axis == "shard_map":
            raise NotImplementedError(_SHARD_MAP)
        self.model = model
        self.data = data
        self.wc = wc
        self.device = model.device
        self.opt = MomentumSGD(momentum=wc.momentum, weight_decay=wc.weight_decay)
        self.rng = np.random.default_rng(wc.seed)  # host evolution draws, as the reference's
        self.key = torch.Generator(device=self.device)  # dropout and device evolution draws
        self.key.manual_seed(wc.seed)
        cfg = model.config
        # the device paths encode flat positions in int32
        self._device_ok = all(
            cfg.layer_dims[l] * cfg.layer_dims[l + 1] < 2**31
            for l in range(cfg.n_layers)
        )
        if not self._device_ok and wc.fused:
            warnings.warn(
                "fused WASAP needs in_dim*out_dim < 2**31 per layer; "
                "falling back to the seed round loop",
                stacklevel=2,
            )
        self._fused = wc.fused and self._device_ok
        self._h = 1 if wc.mode == "wassp" else wc.sync_every
        if self._fused:
            self._epoch_fn = make_phase1_epoch_fn(
                cfg, self.opt, n_workers=wc.n_workers, average_momentum=wc.average_momentum,
                worker_axis=wc.worker_axis, probe=wc.probe,
            )
            self._segment = make_segment_program(cfg, self.opt)
            # phase 2's probe segment, for worker 0 only
            self._probe_segment = make_segment_program(cfg, self.opt, True) if wc.probe else None
        else:
            self._round = _make_worker_round(cfg, self.opt)
        self.loaders = [
            ShardedLoader(
                data.x_train, data.y_train, wc.batch_size,
                seed=wc.seed, shard_id=k, num_shards=wc.n_workers,
            )
            for k in range(wc.n_workers)
        ]
        self.history: Dict[str, list] = {
            "epoch": [], "phase": [], "test_acc": [], "train_loss": [],
            "n_params": [], "epoch_seconds": [],
        }
        self._device_data = None  # lazy: one upload shared by both phases
        # -- resume surface (DESIGN.md §8), fused path -----------------------
        self.start_epoch = 0            # absolute epoch run() continues from
        self.epoch_next = 0
        self.epoch_end_hook = None      # hook(trainer, epoch) at boundaries
        self._phase = 1                 # 1 | 2 — which phase run() enters
        self._p1_state = None           # (params, opt_state, topo) at a boundary
        self._p2_workers = None         # phase-2 replicas at a boundary
        self._last_churn = None         # (n_pruned, nnz) of the last probed SET
        # the reference's elasticity and fault-tolerance seams; refused by run()
        self.monitor = None
        self.fault_hook = None
        self.step_retries = 0

    def _data_on_device(self):
        if self._device_data is None:
            self._device_data = (
                torch.as_tensor(self.data.x_train, device=self.device),
                torch.as_tensor(self.data.y_train, device=self.device).long(),
            )
        return self._device_data

    # -- lr schedules --------------------------------------------------------

    def _lr(self, gstep: int, epoch: int) -> float:
        wc = self.wc
        if wc.mode == "wassp":
            # gradual warmup + linear scaling rule (Goyal et al. 2017)
            target = wc.lr * wc.n_workers
            frac = min(1.0, (gstep + 1) / max(1, wc.warmup_steps))
            return wc.lr + frac * (target - wc.lr)
        # wasap: larger LR for the first few epochs, then fixed (paper §2.3)
        return wc.lr * wc.lr_boost if epoch < wc.lr_boost_epochs else wc.lr

    # -- phases --------------------------------------------------------------

    def run(self) -> Dict[str, list]:
        if self.monitor is not None or self.fault_hook is not None or self.step_retries:
            raise NotImplementedError(
                "heartbeat monitors, fault hooks and step retries come with the runtime "
                "slice (ROADMAP Queue 1, item 5)"
            )
        with obs.span("wasap.run", mode=self.wc.mode, workers=self.wc.n_workers,
                      fused=self._fused, worker_axis=self.wc.worker_axis):
            if self._fused:
                if self._phase == 1:
                    self._run_phase1_fused()
                    self._phase = 2
                worker_states = self._run_phase2_fused()
            else:
                self._run_phase1_roundloop()
                worker_states = self._run_phase2_perbatch()
            with obs.span("wasap.merge", workers=len(worker_states)):
                self._merge_workers(worker_states)
        acc = evaluate(self.model, self.data.x_test, self.data.y_test)
        wc = self.wc
        self.history["epoch"].append(wc.phase1_epochs + wc.phase2_epochs)
        self.history["phase"].append("final")
        self.history["train_loss"].append(float("nan"))
        self.history["test_acc"].append(acc)
        self.history["n_params"].append(self.model.n_params)
        self.history["epoch_seconds"].append(0.0)
        return self.history

    # -- phase 1: local SGD + periodic averaging (device-resident) -----------

    def _phase1_steps(self) -> int:
        """Steps a worker takes in a phase-1 epoch: the shortest shard's."""
        steps = min(ld.steps_per_epoch for ld in self.loaders)
        if steps == 0:
            raise ValueError("batch_size larger than the worker shards")
        return steps

    def _phase1_inputs(self, epoch: int, gstep: int):
        """A phase-1 epoch's ``(idx, lrs, valid)`` on the device, shaped (R,
        K, H, B), (R, H), (R, H): each worker shard's epoch order, padded to
        whole rounds of H steps, whose padded steps weigh 0."""
        wc, dev = self.wc, self.device
        k, h, bsz = wc.n_workers, self._h, wc.batch_size
        steps = self._phase1_steps()
        rounds = -(-steps // h)
        padded = rounds * h
        idx = np.zeros((rounds, k, h, bsz), np.int64)
        for wk, ld in enumerate(self.loaders):
            order = np.zeros((padded, bsz), np.int64)
            order[:steps] = ld.epoch_order(epoch)[: steps * bsz].reshape(steps, bsz)
            idx[:, wk] = order.reshape(rounds, h, bsz)
        valid = np.zeros((padded,), np.float32)
        valid[:steps] = 1.0
        lrs = np.zeros((padded,), np.float32)
        lrs[:steps] = [self._lr(gstep + i, epoch) for i in range(steps)]
        return (torch.as_tensor(idx, device=dev),
                torch.as_tensor(lrs.reshape(rounds, h), device=dev),
                torch.as_tensor(valid.reshape(rounds, h), device=dev))

    def _record_probe(self, step: int, probe_dev, churn_src, extra: Dict) -> None:
        """A fused epoch's ``"wasap"`` snapshot, host-side after the
        epoch's sync: the probe's stats and the SET churn of ``churn_src``
        (``(n_pruned, nnz)`` or None)."""
        churn = None
        if churn_src is not None:
            counts, nnz = churn_src
            churn = [float(c) / max(1, n) for c, n in zip(counts.tolist(), nnz)]
        probes.record_snapshot(step, "wasap", probe_dev, churn=churn, extra=extra)

    def _run_phase1_fused(self) -> None:
        wc, model, dev = self.wc, self.model, self.device
        k, steps = wc.n_workers, self._phase1_steps()
        x_all, y_all = self._data_on_device()
        if self._p1_state is not None:  # resumed at an epoch boundary
            params, opt_state, topo = self._p1_state
        else:
            params = model.params()
            opt_state = self.opt.init(params)
            topo = model.topo_arrays()
        start = min(self.start_epoch, wc.phase1_epochs)
        gstep = start * steps
        rounds = -(-steps // self._h)
        for epoch in range(start, wc.phase1_epochs):
            with obs.span("wasap.epoch", epoch=epoch, phase=1, rounds=rounds) as ep_sp:
                t0 = time.perf_counter()
                # the epoch's rounds; the span waits for their losses at close
                with obs.span("wasap.sync_rounds", rounds=rounds, h=self._h,
                              elastic=False) as sr_sp:
                    out = self._epoch_fn(
                        params, opt_state, topo, x_all, y_all,
                        *self._phase1_inputs(epoch, gstep), self.key,
                    )
                    params, opt_state, loss_sums = out[:3]
                    probe_dev = out[3] if wc.probe else None
                    sr_sp.block_on(loss_sums)
                gstep += steps
                # master topology evolution on the averaged model; momentum is
                # re-aligned (RetainValidUpdates semantics for velocity)
                topo, params, opt_state = self._evolve_device(topo, params, opt_state,
                                                              self.key, master=True)
                obs.point("wasap.evolve", epoch=epoch, device=True)
                # wait for the epoch's device work, so that epoch_seconds
                # measures it, not its enqueueing
                _sync(dev)
                dt = time.perf_counter() - t0
                train_loss = float(loss_sums.sum()) / (k * steps)
                acc = evaluate(model, self.data.x_test, self.data.y_test, params=params,
                               topo_arrays=topo)
                if probe_dev is not None:
                    self._record_probe(gstep, probe_dev, self._last_churn,
                                       {"epoch": epoch, "phase": 1, "loss": train_loss,
                                        "acc": float(acc)})
                    self._last_churn = None
                ep_sp.set(loss=train_loss, acc=float(acc))
                self._log(epoch, 1, train_loss, dt, acc)
                self._p1_state = (params, opt_state, topo)
                self.epoch_next = epoch + 1
                if self.epoch_end_hook is not None:
                    self.epoch_end_hook(self, epoch)
        model.set_params(params)
        self._sync_topos_to_host(topo)
        self.epoch_next = wc.phase1_epochs

    def _run_phase1_roundloop(self) -> None:
        """Seed-era phase 1: per-round dispatch, host replication, numpy
        batch stacking, host numpy evolution — the fused baseline."""
        wc, model, dev = self.wc, self.model, self.device
        k, h = wc.n_workers, self._h
        gstep = 0
        params = model.params()
        opt_state = self.opt.init(params)
        for epoch in range(wc.phase1_epochs):
            t0 = time.perf_counter()
            topo = model.topo_arrays()
            batches = [list(ld.epoch(epoch)) for ld in self.loaders]
            steps = min(len(b) for b in batches)
            if steps == 0:
                raise ValueError("batch_size larger than the worker shards")
            loss_total, s = 0.0, 0
            x0, y0 = batches[0][0]
            while s < steps:
                hh = min(h, steps - s)
                # pad the tail round to the fixed H (valid-masked)
                xs = np.zeros((k, h) + x0.shape, x0.dtype)
                ys = np.zeros((k, h) + y0.shape, y0.dtype)
                for wk, b in enumerate(batches):
                    for i in range(hh):
                        xs[wk, i], ys[wk, i] = b[s + i]
                valid = np.zeros((h,), np.float32)
                valid[:hh] = 1.0
                lrs = np.zeros((h,), np.float32)
                lrs[:hh] = [self._lr(gstep + i, epoch) for i in range(hh)]
                sp, so, lsum = self._round(
                    _replicate(params, k), _replicate(opt_state, k), topo,
                    torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev).long(),
                    torch.as_tensor(lrs, device=dev), torch.as_tensor(valid, device=dev),
                    self.key,
                )
                params = _cast_like(_average_pytree(sp), params)
                opt_state = (_cast_like(_average_pytree(so), opt_state)
                             if wc.average_momentum else _take_worker0(so))
                loss_total += float(lsum.sum())
                s += hh
                gstep += hh
            model.set_params(params)
            # master topology evolution on the averaged model (host numpy)
            opt_state = self._evolve_master(opt_state)
            params = model.params()
            _sync(dev)
            dt = time.perf_counter() - t0
            acc = evaluate(model, self.data.x_test, self.data.y_test)
            self._log(epoch, 1, loss_total / (k * steps), dt, acc)

    # -- phase 2: independent local training ---------------------------------

    def _run_phase2_fused(self) -> List[tuple]:
        """Each worker owns a device-resident replica: one fused epoch
        segment per worker-epoch, then its own device SET evolution, drawn
        from its own generator."""
        wc, model, dev = self.wc, self.model, self.device
        cfg = model.config
        k, bsz = wc.n_workers, wc.batch_size
        x_all, y_all = self._data_on_device()
        if self._p2_workers is not None:  # resumed at an epoch boundary
            workers = self._p2_workers
        else:
            base = model.params()
            seeds = torch.randint(0, 2**62, (k,), generator=self.key, device=dev).tolist()
            workers = []
            for wk in range(k):
                key = torch.Generator(device=dev)
                key.manual_seed(seeds[wk])
                # fresh velocity: phase 2 starts every worker from opt.init
                workers.append({"params": base, "opt": self.opt.init(base),
                                "topo": model.topo_arrays(), "key": key})
        start = max(self.start_epoch, wc.phase1_epochs)
        steps_per_epoch = min(ld.steps_per_epoch for ld in self.loaders)
        for epoch in range(start, wc.phase1_epochs + wc.phase2_epochs):
            with obs.span("wasap.epoch", epoch=epoch, phase=2, workers=k) as ep_sp:
                t0 = time.perf_counter()
                losses = []
                p2_probe = None  # worker 0's probe stats
                # one span over all K worker segments and evolutions, waited
                # for once at its close
                with obs.span("wasap.worker_segments", workers=k) as ws_sp:
                    for wk, w in enumerate(workers):
                        ld = self.loaders[wk]
                        steps = ld.steps_per_epoch
                        perm = torch.as_tensor(ld.epoch_order(epoch).reshape(steps, bsz),
                                               device=dev)
                        lrs = torch.full((steps,), wc.lr, dtype=torch.float32, device=dev)
                        # worker 0 carries the probe: one representative
                        # replica is enough for phase-2 dynamics
                        probing = self._probe_segment is not None and wk == 0
                        seg = self._probe_segment if probing else self._segment
                        out = seg(w["params"], w["opt"], w["topo"], x_all, y_all, perm, lrs,
                                  w["key"])
                        w["params"], w["opt"], w["key"], ls = out[:4]
                        if probing:
                            p2_probe = out[4]
                        losses.append(ls.mean())
                        # per-worker evolution (divergent topologies)
                        w["topo"], w["params"], w["opt"] = self._evolve_device(
                            w["topo"], w["params"], w["opt"], w["key"], master=probing)
                    ws_sp.block_on([w["params"] for w in workers])
                _sync(dev)
                dt = time.perf_counter() - t0
                loss = float(torch.stack(losses).mean())
                if p2_probe is not None:
                    self._record_probe((epoch + 1) * steps_per_epoch, p2_probe,
                                       self._last_churn,
                                       {"epoch": epoch, "phase": 2, "loss": loss})
                    self._last_churn = None
                ep_sp.set(loss=loss)
                self._log(epoch, 2, loss, dt, float("nan"))
                self._p2_workers = workers
                self.epoch_next = epoch + 1
                if self.epoch_end_hook is not None:
                    self.epoch_end_hook(self, epoch)
        out = []
        for w in workers:
            topos = [
                ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1],
                                t.rows.cpu().numpy(), t.cols.cpu().numpy())
                for l, t in enumerate(w["topo"])
            ]
            out.append((topos, [_host(v) for v in w["params"]["values"]],
                        list(w["params"]["biases"])))
        return out

    def _run_phase2_perbatch(self) -> List[tuple]:
        """Seed-era phase 2: per-batch dispatch + host numpy evolution."""
        wc, model, dev = self.wc, self.model, self.device
        cfg = model.config
        k = wc.n_workers
        worker_models = [
            SparseMLP.from_state(cfg, list(model.topos), list(model.values),
                                 list(model.biases), device=dev)
            for _ in range(k)
        ]
        worker_opt = [self.opt.init(m.params()) for m in worker_models]
        worker_rngs = [np.random.default_rng(wc.seed * 97 + 13 * wk) for wk in range(k)]
        step_fn = make_mlp_train_step(cfg, self.opt)
        lr = torch.tensor(wc.lr, dtype=torch.float32, device=dev)
        for epoch in range(wc.phase1_epochs, wc.phase1_epochs + wc.phase2_epochs):
            t0 = time.perf_counter()
            losses = []
            for wk in range(k):
                m = worker_models[wk]
                params = m.params()
                topo = m.topo_arrays()
                ostate = worker_opt[wk]
                for xb, yb in self.loaders[wk].epoch(epoch):
                    params, ostate, loss = step_fn(
                        params, ostate, topo, torch.as_tensor(xb, device=dev),
                        torch.as_tensor(yb, device=dev).long(), lr, self.key,
                    )
                    losses.append(loss)
                m.set_params(params)
                # per-worker evolution (divergent topologies)
                vel = list(ostate.velocity["values"])
                for l in range(cfg.n_layers):
                    res = evolve_element(
                        m.topos[l], _host(m.values[l]), wc.zeta, worker_rngs[wk],
                        momentum=_host(vel[l]), init_scheme=cfg.init,
                    )
                    m.topos[l] = res.topology
                    m.values[l] = torch.as_tensor(res.values, device=dev)
                    vel[l] = torch.as_tensor(res.momentum, device=dev)
                worker_opt[wk] = replace_values_velocity(ostate, vel)
            _sync(dev)
            dt = time.perf_counter() - t0
            loss = float(torch.stack(losses).double().mean()) if losses else float("nan")
            self._log(epoch, 2, loss, dt, float("nan"))
        return [(list(m.topos), [_host(v) for v in m.values], list(m.biases))
                for m in worker_models]

    # -- final: SWA + re-sparsify --------------------------------------------

    def _merge_workers(self, worker_states: List[tuple]) -> None:
        model = self.model
        cfg = model.config
        target_nnz = [t.nnz for t in model.topos]
        for l in range(cfg.n_layers):
            topo, vals = sparse_average_and_resparsify(
                [ws[0][l] for ws in worker_states],
                [ws[1][l] for ws in worker_states],
                target_nnz[l],
            )
            model.topos[l] = topo
            model.values[l] = torch.as_tensor(vals, device=self.device)
            model.biases[l] = _average_pytree(torch.stack([ws[2][l] for ws in worker_states]))

    # -- resume (DESIGN.md §8) ------------------------------------------------

    def save_checkpoint(self, manager) -> None:
        """Phase-aware epoch-boundary snapshot of the fused path, at step
        ``epoch_next``, in the reference's layout. Phase 1 saves the averaged
        master (params, velocity, topology); phase 2 also saves every worker
        replica (``w{k}_params``, ``w{k}_velocity`` and ``w{k}_layer{l}``
        topologies), since the replicas have diverged, with the reference's
        ``worker_keys`` (:func:`jax_key_words`) and ``worker_opt_steps`` and
        each worker generator's state (``worker_generators``). Both carry
        the trainer's generator state, its numpy rng and the history."""
        if not self._fused:
            raise RuntimeError(
                "WASAP checkpointing covers the fused path; the seed-era "
                "round loop is a measured baseline, not a production path"
            )
        cfg = self.model.config
        resume = {
            "kind": "wasap",
            "phase": self._phase,
            "epoch_next": int(self.epoch_next),
            "jax_key": jax_key_words(self.key),
            "numpy_rng": self.rng.bit_generator.state,
            "history": self.history,
            "torch_generator": generator_entry(self.key),
        }

        def topo_entry(t):
            return {"rows": t.rows, "cols": t.cols}

        if self._phase == 1 and self._p1_state is not None:
            params, opt_state, topo = self._p1_state
            resume["opt_step"] = int(opt_state.step)
            manager.save(self.epoch_next, params, extra={"velocity": opt_state.velocity},
                         topologies={f"layer{l}": topo_entry(topo[l])
                                     for l in range(cfg.n_layers)},
                         meta={"resume": resume})
            return
        # phase 2 (or the phase boundary itself): master + worker replicas
        topologies = {f"layer{l}": topo_entry(self.model.topos[l]) for l in range(cfg.n_layers)}
        extra = {}
        worker_keys, worker_opt_steps, worker_generators = [], [], []
        for wk, w in enumerate(self._p2_workers or []):
            extra[f"w{wk}_params"] = w["params"]
            extra[f"w{wk}_velocity"] = w["opt"].velocity
            worker_keys.append(jax_key_words(w["key"]))
            worker_opt_steps.append(int(w["opt"].step))
            worker_generators.append(generator_entry(w["key"]))
            for l in range(cfg.n_layers):
                topologies[f"w{wk}_layer{l}"] = topo_entry(w["topo"][l])
        resume.update(phase=2, n_saved_workers=len(worker_keys), worker_keys=worker_keys,
                      worker_opt_steps=worker_opt_steps, worker_generators=worker_generators)
        manager.save(self.epoch_next, self.model.params(), extra=extra,
                     topologies=topologies, meta={"resume": resume})

    def restore_checkpoint(self, manager, step=None) -> int:
        """Rewind to a saved epoch boundary (the newest *valid* checkpoint by
        default: corrupt ones are quarantined by the scan); ``run()`` then
        continues from the saved phase and epoch. The device arrays, with
        kernel A's offsets and kernel F's run plan, are made from the saved
        host topologies; the generators resume their saved streams, or, from
        a reference checkpoint, are seeded from its keys
        (``train.trainer.restore_generator``). Returns the step."""
        if step is None:
            step = manager.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoints under {manager.dir}")
        manifest = manager.read_manifest(step)
        res = manifest["meta"]["resume"]
        cfg, dev = self.model.config, self.device
        like = _params_like(manifest["shapes"], cfg.n_layers)

        def layer_topo(l, entry) -> ElementTopology:
            return ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1],
                                   entry["rows"], entry["cols"])

        def sgd_state(velocity, opt_step) -> SGDState:
            return SGDState(velocity=velocity,
                            step=torch.tensor(int(opt_step), dtype=torch.int32, device=dev))

        if res["phase"] == 1:
            params, extra, topologies, _ = manager.restore(
                step, like=like, like_extra={"velocity": like}, device=dev)
            topo = tuple(layer_topo(l, topologies[f"layer{l}"]).device_arrays(dev)
                         for l in range(cfg.n_layers))
            self._p1_state = (params, sgd_state(extra["velocity"], res["opt_step"]), topo)
            self._phase = 1
        else:
            n_saved = int(res.get("n_saved_workers", self.wc.n_workers))
            like_extra = {}
            for wk in range(n_saved):
                like_extra[f"w{wk}_params"] = like
                like_extra[f"w{wk}_velocity"] = like
            params, extra, topologies, _ = manager.restore(
                step, like=like, like_extra=like_extra, device=dev)
            for l in range(cfg.n_layers):
                self.model.topos[l] = layer_topo(l, topologies[f"layer{l}"])
            self.model.set_params(params)
            generators = res.get("worker_generators")
            workers = []
            for wk in range(n_saved):
                key = torch.Generator(device=dev)
                restore_generator(key, generators[wk] if generators else None,
                                  res["worker_keys"][wk])
                workers.append({
                    "params": extra[f"w{wk}_params"],
                    "opt": sgd_state(extra[f"w{wk}_velocity"], res["worker_opt_steps"][wk]),
                    "topo": tuple(layer_topo(l, topologies[f"w{wk}_layer{l}"]).device_arrays(dev)
                                  for l in range(cfg.n_layers)),
                    "key": key,
                })
            self._p2_workers = workers if workers else None
            self._phase = 2
        restore_generator(self.key, res.get("torch_generator"), res["jax_key"])
        self.rng.bit_generator.state = res["numpy_rng"]
        self.start_epoch = self.epoch_next = int(res["epoch_next"])
        self.history = {k: list(v) for k, v in res["history"].items()}
        return step

    # -- helpers --------------------------------------------------------------

    def _evolve_device(self, topo, params, opt_state: SGDState, key: torch.Generator,
                       master: bool = False):
        """SET on the device for every layer, drawing from ``key``: the
        master's between phase-1 epochs (the reference's
        ``_evolve_master_device``) and each worker's in phase 2. Returns the
        new arrays (with the kernels' plans), params and re-aligned
        velocity; nothing syncs. With ``probe`` on, the pruned counts of
        the probed replica (``master``: phase 1's master, phase 2's worker
        0) are kept for the epoch's snapshot."""
        cfg, wc = self.model.config, self.wc
        topo, values, vel, pruned = evolve_element_layers_device(
            topo, list(params["values"]), list(opt_state.velocity["values"]), key,
            layer_dims=cfg.layer_dims, zeta=wc.zeta, init_scheme=cfg.init, probe=wc.probe,
        )
        if wc.probe and master:
            self._last_churn = (pruned, [int(t.rows.shape[0]) for t in topo])
        params = {"values": tuple(values), "biases": params["biases"]}
        return topo, params, replace_values_velocity(opt_state, vel)

    def _sync_topos_to_host(self, topo) -> None:
        cfg = self.model.config
        for l in range(cfg.n_layers):
            self.model.topos[l] = ElementTopology(
                cfg.layer_dims[l], cfg.layer_dims[l + 1],
                topo[l].rows.cpu().numpy(), topo[l].cols.cpu().numpy(),
            )

    def _evolve_master(self, opt_state: SGDState) -> SGDState:
        """Host SET of the master (``model``) on the trainer's numpy rng, as
        the reference's; returns ``opt_state`` with its velocity re-aligned."""
        model, wc = self.model, self.wc
        cfg = model.config
        vel = list(opt_state.velocity["values"])
        for l in range(cfg.n_layers):
            res = evolve_element(
                model.topos[l], _host(model.values[l]), wc.zeta, self.rng,
                momentum=_host(vel[l]), init_scheme=cfg.init,
            )
            model.topos[l] = res.topology
            model.values[l] = torch.as_tensor(res.values, device=self.device)
            vel[l] = torch.as_tensor(res.momentum, device=self.device)
        return replace_values_velocity(opt_state, vel)

    def _log(self, epoch, phase, loss, dt, acc) -> None:
        self.history["epoch"].append(epoch)
        self.history["phase"].append(phase)
        self.history["train_loss"].append(loss)
        self.history["test_acc"].append(acc)
        self.history["n_params"].append(self.model.n_params)
        self.history["epoch_seconds"].append(dt)
