"""Sequential SET trainer — paper Algorithm 2 (SET + Importance Pruning).

Twin of ``repro.train.trainer.SequentialTrainer`` for element-sparse (COO,
the paper's) and block-sparse SET-MLPs and the paper's masked and dense
baselines, with the same ``TrainerConfig``, the same epoch protocol and the
same ``history`` keys. A masked or dense model has no topology phase: SET
and importance pruning are skipped where the reference skips them, so its
mask (and a dense model's full matrix) stays as drawn. Two execution modes
(``TrainerConfig.fused_epochs``):

* **Fused (default)** — the training set lives on the device, the host ships
  only the epoch's shuffled index permutation and learning rates, and
  ``launch.steps.scan_segment`` runs every minibatch step with the losses
  kept on the device: one host synchronisation per epoch. Between segments
  the SET prune/regrow cycle runs on the device too, on fixed-capacity
  topology arrays (``core.topology.evolve_element_layers_device``,
  ``evolve_block_layers_device``; ``device_evolution=True``, the default),
  and rebuilds the arrays and the kernels' plans there, with no host sync.
  The host topology mirror (``model.topos``) is synchronised lazily: only
  before importance pruning (a host operation that changes shapes), at an
  epoch-end hook, and at the end of the run. With
  ``device_evolution=False``, or a layer whose flat positions overflow
  int32, SET runs on the host as in per-batch mode.
* **Per-batch** — one step call per minibatch from host numpy batches, SET
  on the host, as the reference's.

Per epoch, both modes: momentum-SGD minibatch steps (on the card the
element products run on kernels A, F and G, the block products on C, D and
E), then
  1. Importance Pruning (if the schedule fires): remove the weak hidden
     neurons' incoming connections and, on an element model, their outgoing
     ones in the next layer too (the output layer takes only that cascade);
     a block model zeroes the neurons' columns and frees the tiles left
     empty;
  2. the SET pruning-regrowing cycle (element: the zeta-tail per sign,
     random regrowth drawn by the model's init scheme; block: the zeta-tail
     of tiles by mean |w|, zero-init), keeping the connection or tile
     count; momentum is kept on survivors and reset on regrown ones;
then evaluation. Host SET (``core.topology.evolve_element``,
``evolve_block``) draws from the reference's numpy rng, so at dropout 0 the
topology follows the reference's host-evolution run. Device SET draws from
the trainer's one ``torch.Generator``, which dropout draws from too, as the
reference draws both from its one jax key chain; the two generators give
other numbers, so device SET follows the reference's only when fed its
draws (``core.topology.evolution_draws``). After a host topology phase the
device arrays (and an element topology's offsets and run plan) are made
once, from the host, and serve the evaluation and the next epoch.

Checkpoints (``save_checkpoint``/``restore_checkpoint``, DESIGN.md §8)
are taken at an epoch boundary, usually from ``epoch_end_hook``, in the
reference's layout (``checkpoint.manager``): params, velocity, topology,
the counters, both random streams and the history, so that a fresh trainer
restored from one runs the remaining epochs to the same bits as the run
that never stopped. A checkpoint crosses between the packages in both
directions (see ``restore_checkpoint`` for the random streams).

:class:`XLTrainer` is the out-of-core trainer (the paper's Table-4
regime): the same epoch protocol on the shard-streamed substrate
(``repro_torch.xl``), with streamed checkpoints.

Observability (``repro_torch.obs``, DESIGN.md §11-§12): a span for each
phase of a run, opened where the work is done, never once a step.
``train.run`` holds ``train.prepare`` (the run's upload of the training
set, fused mode only, and the topology's device arrays; ``h2d_bytes``) and
one ``train.epoch`` an epoch, which holds ``train.feed`` (the epoch's
permutation and learning rates, fused mode; ``h2d_bytes``),
``train.segment`` (``block_on`` its losses or parameters, so on a card it
ends where the device's work ends), ``train.topology`` (``pruned``,
``evolved``, ``device``, and ``n_params`` after a pruning),
``train.wait`` (the epoch's synchronise and the mean loss's read),
``train.evaluate`` (opened by :func:`evaluate` itself: ``rows``,
``batches``, ``acc``, ``h2d_bytes``) and ``train.hook`` (the epoch-end
hook). No span synchronises (``obs.trace``). With
``TrainerConfig(probe=True)``, one snapshot per epoch
(``obs.probes.record_snapshot``): the segment adds one forward and one
backward on half of its last minibatch and the probe's reductions
(:func:`make_segment_program`), and device SET reports its churn. A probe
reads the weights and never writes them: a probed run's history,
topologies and weights are the unprobed run's, bit for bit.

Fault tolerance (``runtime.supervisor``, DESIGN.md §8), as the reference
wires it: ``fault_hook(gstep)`` fires once a fused segment (at its first
step) or once a per-batch step, before anything is drawn or written, and
with ``step_retries > 0`` the call runs under ``retry_step``
(``retry_backoff_s`` apart). The in-core step and segment are not donated
(``runtime.donation``): they return new params and velocity and leave their
inputs untouched. What they draw (dropout) comes from ``self.key``, a
``torch.Generator`` that advances inside the call, so its state is taken
before the first attempt and put back before every retry: a retry re-enters
with the first attempt's inputs, also after a fault raised inside the call,
and the run stays bit-equal to the one that never failed.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.importance import (
    PruningSchedule,
    importance_prune_block,
    importance_prune_element,
)
from repro_torch.core.sparsity import BlockTopology, ElementTopology
from repro_torch.core.topology import (
    evolve_block,
    evolve_block_layers_device,
    evolve_element,
    evolve_element_layers_device,
)
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import Dataset
from repro_torch.launch.steps import make_mlp_step_core, make_mlp_train_step, scan_segment
from repro_torch.models.mlp import (
    SPARSE_IMPLS,
    SparseMLP,
    SparseMLPConfig,
    block_meta,
    cross_entropy_loss,
    mlp_forward,
)
from repro_torch.obs import probes
from repro_torch.optim.sgd import MomentumSGD, SGDState, replace_values_velocity
from repro_torch.runtime.supervisor import retry_step
from repro_torch.tree import tree_map

__all__ = [
    "SequentialTrainer",
    "TrainerConfig",
    "XLTrainer",
    "evaluate",
    "make_eval_fn",
    "make_segment_fn",
    "make_segment_program",
    "make_step_fn",
]

@dataclasses.dataclass
class TrainerConfig:
    epochs: int = 10
    batch_size: int = 128
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 2e-4
    zeta: float = 0.3
    evolve: bool = True
    pruning: Optional[PruningSchedule] = None
    eval_every: int = 1
    seed: int = 0
    lr_schedule: Optional[Callable] = None
    fused_epochs: bool = True  # one device-resident segment per epoch
    device_evolution: bool = True  # SET on the device between fused segments
    probe: bool = False  # training-dynamics probes (obs.probes, DESIGN.md §12)


def make_step_fn(config: SparseMLPConfig, opt: MomentumSGD):
    """The single-minibatch step, ``launch.steps.make_mlp_train_step``:
    ``step(params, opt_state, topo_arrays, x, y, lr, rng) -> (params,
    opt_state, loss)``. The reference jits it; PyTorch runs it eagerly."""
    return make_mlp_train_step(config, opt)


def make_segment_program(config: SparseMLPConfig, opt: MomentumSGD, probe: bool = False):
    """The epoch segment: ``segment(params, opt_state, topo_arrays, x_all,
    y_all, perm, lrs, key) -> (params, opt_state, key, losses)`` gathers the
    epoch's batches from the device-resident dataset by the (steps, batch)
    index permutation and runs them in order; ``losses`` stay on the
    device.

    ``probe=False`` runs exactly the steps and nothing else. ``probe=True``
    then runs ONE extra forward (``mlp_forward(..., return_preacts=True)``)
    and backward on the first half of the segment's last minibatch, at the
    segment's final weights, and the ``obs.probes.segment_probe``
    reductions, and returns ``(..., losses, probe_stats)``, the stats as
    device tensors. The probe draws nothing and writes no weight."""

    def segment(params, opt_state, topo_arrays, x_all, y_all, perm, lrs, key):
        step_core = make_mlp_step_core(config, opt, topo_arrays, x_all, y_all)
        out = scan_segment(step_core, params, opt_state, key, (perm, lrs))
        if not probe:
            return out
        params2, opt_state2, key2, losses = out
        # probe batch: half of the last minibatch — the stats want post-
        # segment weights, and a half batch keeps the extra fwd+bwd cheap
        idx = perm[-1, : max(1, perm.shape[1] // 2)]
        xb, yb = x_all.index_select(0, idx), y_all.index_select(0, idx)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params2)
        logits, preacts = mlp_forward(leaves, topo_arrays, xb, config, train=False,
                                      return_preacts=True)
        grads = torch.autograd.grad(cross_entropy_loss(logits, yb), leaves["values"])
        stats = probes.segment_probe(params2, {"values": grads}, topo_arrays,
                                     [z.detach() for z in preacts], config.layer_dims)
        return params2, opt_state2, key2, losses, stats

    return segment


@functools.lru_cache(maxsize=32)
def make_segment_fn(config: SparseMLPConfig, opt: MomentumSGD, probe: bool = False):
    """The epoch segment of :func:`make_segment_program`, cached per (model
    config, optimizer, probe) as the reference's is, so repeated trainers
    share one program. The reference jits the segment and donates the
    parameters' and optimizer state's buffers; there is no ``jit`` in
    PyTorch: the program runs eagerly, and nothing is donated."""
    return make_segment_program(config, opt, probe)


@functools.lru_cache(maxsize=64)
def make_eval_fn(config: SparseMLPConfig):
    """The evaluation forward ``fwd(params, topo_arrays, x) -> logits``
    (``mlp_forward(..., train=False)``, with no autograd record), cached
    per config as the reference's jitted one is."""

    def fwd(params, topo_arrays, x):
        with torch.no_grad():
            return mlp_forward(params, topo_arrays, x, config, train=False)

    return fwd


EVAL_BATCH = 512  # the rows of an evaluation batch, :func:`evaluate`'s default


def evaluate(model: SparseMLP, x: np.ndarray, y: np.ndarray, batch: int = EVAL_BATCH, *,
             params=None, topo_arrays=None) -> float:
    """Accuracy on (x, y), counted on the device with one synchronisation.
    ``params``/``topo_arrays`` override the model's own views: the caller's
    device state (WASAP's averaged phase-1 master, whose host mirror lags),
    or device arrays it already has; without them they are made from the
    model. Traced as one ``train.evaluate`` span; its ``h2d_bytes`` are the
    bytes of the slices copied from the host to a card (:func:`_h2d_nbytes`):
    0 where ``x`` and ``y`` already lie on the model's device."""
    n = x.shape[0]
    with obs.span("train.evaluate", rows=int(n), batches=-(-n // batch)) as sp:
        params = model.params() if params is None else params
        topo = model.topo_arrays() if topo_arrays is None else topo_arrays
        dev = model.device
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        h2d_bytes = 0
        with torch.no_grad():
            for s in range(0, n, batch):
                xs, ys = x[s : s + batch], y[s : s + batch]
                h2d_bytes += _h2d_nbytes(xs, dev) + _h2d_nbytes(ys, dev)
                xb = torch.as_tensor(xs, device=dev)
                yb = torch.as_tensor(ys, device=dev).long()
                logits = mlp_forward(params, topo, xb, model.config, train=False)
                correct += (logits.argmax(-1) == yb).sum()
        acc = int(correct) / n
        sp.set(acc=acc, h2d_bytes=int(h2d_bytes))
    return acc


def _h2d_nbytes(a, dev) -> int:
    """Bytes that ``torch.as_tensor(a, device=dev)`` copies from the host to
    a card: the size of a numpy array or a CPU tensor where ``dev`` is a CUDA
    device, else 0 (no copy, or none that crosses to a card)."""
    if torch.device(dev).type != "cuda":
        return 0
    if isinstance(a, np.ndarray):
        return int(a.nbytes)
    if isinstance(a, torch.Tensor) and a.device.type == "cpu":
        return a.numel() * a.element_size()
    return 0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- checkpoint glue (DESIGN.md §8) -------------------------------------------


def _params_like(shapes: Dict, n_layers: int):
    """A tree in the trainer's params structure with the *checkpoint's* leaf
    shapes and dtypes (``meta`` tensors: no memory), the restore target: SET
    keeps the slot count but importance pruning shrinks it, so the live
    model's shapes need not match the saved ones."""

    def leaf(name):
        shape, dtype = shapes[name]
        return torch.empty(tuple(shape), dtype=getattr(torch, dtype), device="meta")

    return {
        "values": tuple(leaf(f"values__{l}") for l in range(n_layers)),
        "biases": tuple(leaf(f"biases__{l}") for l in range(n_layers)),
    }


def generator_entry(generator: torch.Generator) -> Dict:
    """A generator's state for a checkpoint's JSON meta: its device type and
    ``get_state()``'s bytes (a CPU generator's Mersenne Twister state; a
    CUDA generator's seed and offset)."""
    return {"device": generator.device.type,
            "state": generator.get_state().tolist()}


def jax_key_words(generator: torch.Generator) -> List[int]:
    """The two uint32 words written as the reference's ``jax_key``, which
    its ``restore_checkpoint`` reads: the first 8 bytes of the SHA-256 of
    the generator's state. They are not the port's stream (a
    ``torch.Generator`` cannot be a jax key); they only give the reference
    a key that follows the port's state."""
    digest = hashlib.sha256(bytes(generator.get_state().tolist())).digest()
    return [int.from_bytes(digest[:4], "big"), int.from_bytes(digest[4:8], "big")]


def seed_from_jax_key(words) -> int:
    """The seed the port gives its generator when a checkpoint carries only
    a reference ``jax_key`` (two uint32 words ``k0, k1``): ``k0 * 2**32 +
    k1``, the key's 64 bits read as one integer."""
    k0, k1 = (int(w) for w in words)
    return (k0 << 32) | k1


def restore_generator(generator: torch.Generator, entry: Optional[Dict], jax_key) -> None:
    """Put a saved stream into ``generator``: the state of ``entry``
    (:func:`generator_entry`), which must come from a generator of the same
    device type, else a ``ValueError`` naming both, never a quiet reseed;
    without one (a reference checkpoint), the seed
    :func:`seed_from_jax_key` makes of ``jax_key``."""
    if entry is None:
        generator.manual_seed(seed_from_jax_key(jax_key))
        return
    if entry["device"] != generator.device.type:
        raise ValueError(
            f"the checkpoint's generator state is a {entry['device']} generator's; it "
            f"cannot resume a {generator.device.type} generator's stream"
        )
    generator.set_state(torch.tensor(entry["state"], dtype=torch.uint8))


class SequentialTrainer:
    """Paper §2.2 protocol (1 worker). History mirrors Table 2 columns."""

    def __init__(self, model: SparseMLP, data: Dataset, tc: TrainerConfig):
        self.model = model
        self.data = data
        self.tc = tc
        self.device = model.device
        self.opt = MomentumSGD(momentum=tc.momentum, weight_decay=tc.weight_decay)
        self.opt_state = self.opt.init(model.params())
        self.rng = np.random.default_rng(tc.seed)  # host evolution draws, as the reference's
        self.key = torch.Generator(device=self.device)  # dropout and device evolution draws
        self.key.manual_seed(tc.seed)
        self._step = make_mlp_train_step(model.config, self.opt)
        self._segment = make_segment_fn(model.config, self.opt)
        # the probe variant is made only when asked for
        self._probe_segment = (make_segment_fn(model.config, self.opt, True) if tc.probe
                               else None)
        self._last_churn = None  # (pruned counts, nnz) per layer of the last device SET
        self.history: Dict[str, List] = {
            "epoch": [], "train_loss": [], "test_acc": [], "n_params": [],
            "epoch_seconds": [],
        }
        self.start_epoch = 0          # first epoch run() will execute
        self.epoch_next = 0           # next epoch at the last boundary
        self.gstep = 0                # global minibatch counter
        self.epoch_end_hook: Optional[Callable] = None  # hook(trainer, epoch)
        # fault tolerance (DESIGN.md §8): hook(gstep) before each segment or
        # step; retry_step around it when step_retries > 0
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.step_retries = 0
        self.retry_backoff_s = 0.0

    # -- host-side topology mutations --------------------------------------

    def _importance_prune(self, epoch: int) -> None:
        tc, model = self.tc, self.model
        if tc.pruning is None or not tc.pruning.should_prune(epoch):
            return
        element = model.config.impl == "element"
        vel = list(self.opt_state.velocity["values"])
        pruned_prev: Optional[np.ndarray] = None
        for l in range(model.config.n_layers):
            # the element cascade: connections out of neurons pruned in the
            # layer before die too
            cascade = element and pruned_prev is not None and pruned_prev.size > 0
            if l == model.config.n_layers - 1 and not cascade:
                break
            dtype = model.values[l].dtype
            topo, vals, mom = model.topos[l], _host(model.values[l]), _host(vel[l])
            if cascade:
                keep = ~np.isin(topo.rows, pruned_prev)
                topo = ElementTopology(topo.in_dim, topo.out_dim, topo.rows[keep],
                                       topo.cols[keep])
                vals, mom = vals[keep], mom[keep]
            if l < model.config.n_layers - 1:  # output units are protected
                fn = importance_prune_element if element else importance_prune_block
                res = fn(topo, vals, tc.pruning, momentum=mom)
                topo, vals, mom, pruned_prev = (res.topology, res.values, res.momentum,
                                                res.pruned_neurons)
            model.topos[l] = topo
            model.values[l] = torch.as_tensor(vals, device=self.device).to(dtype)
            vel[l] = torch.as_tensor(mom, device=self.device)
        self.opt_state = replace_values_velocity(self.opt_state, vel)

    def _evolve(self) -> None:
        tc, model = self.tc, self.model
        if not tc.evolve:
            return
        vel = list(self.opt_state.velocity["values"])
        for l in range(model.config.n_layers):
            dtype = model.values[l].dtype
            if model.config.impl == "element":
                res = evolve_element(
                    model.topos[l], _host(model.values[l]), tc.zeta, self.rng,
                    momentum=_host(vel[l]), init_scheme=model.config.init,
                )
            else:
                res = evolve_block(
                    model.topos[l], _host(model.values[l]), tc.zeta, self.rng,
                    momentum=_host(vel[l]),
                )
            model.topos[l] = res.topology
            model.values[l] = torch.as_tensor(res.values, device=self.device).to(dtype)
            vel[l] = torch.as_tensor(res.momentum, device=self.device)
        self.opt_state = replace_values_velocity(self.opt_state, vel)

    # -- device-side topology mutations --------------------------------------

    def _evolve_device(self, topo):
        """SET for every layer on the device, drawing from ``self.key``:
        returns the new device arrays (with their plans) and leaves the host
        mirror behind."""
        tc, model = self.tc, self.model
        cfg = model.config
        vel = list(self.opt_state.velocity["values"])
        if cfg.impl == "element":
            topo, values, vel, pruned = evolve_element_layers_device(
                topo, model.values, vel, self.key, layer_dims=cfg.layer_dims, zeta=tc.zeta,
                init_scheme=cfg.init, probe=tc.probe)
        else:
            topo, values, vel, pruned = evolve_block_layers_device(
                topo, model.values, vel, self.key,
                metas=[block_meta(cfg, l) for l in range(cfg.n_layers)], zeta=tc.zeta)
        if tc.probe:  # the churn probe: read on the host by the epoch's snapshot
            self._last_churn = (pruned, [int(t.rows.shape[0]) for t in topo])
        model.values = list(values)
        self.opt_state = replace_values_velocity(self.opt_state, vel)
        return topo

    def _sync_topology_to_host(self, topo) -> None:
        """Pull the device topology into the host mirror (``model.topos``),
        whose constructors check its invariants: needed only before a host
        topology operation, at an epoch-end hook and at the end of a fused
        run."""
        cfg = self.model.config
        for l, t in enumerate(topo):
            rows, cols = t.rows.cpu().numpy(), t.cols.cpu().numpy()
            if cfg.impl == "element":
                self.model.topos[l] = ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1],
                                                      rows, cols)
            else:
                self.model.topos[l] = BlockTopology(block_meta(cfg, l), rows, cols)

    def _host_topology_op(self, topo, topo_dirty: bool, op):
        """Run a host topology mutation ``op`` (it changes the model and
        ``opt_state``) after syncing the host mirror if the device topology
        has moved on, and return the device arrays made from its result."""
        if topo_dirty:
            self._sync_topology_to_host(topo)
        op()
        return self.model.topo_arrays()

    def _supports_device_evolution(self) -> bool:
        # device SET encodes flat positions in int32
        cfg = self.model.config
        if cfg.impl == "element":
            return all(cfg.layer_dims[l] * cfg.layer_dims[l + 1] < 2**31
                       for l in range(cfg.n_layers))
        return all(block_meta(cfg, l).total_blocks < 2**31 for l in range(cfg.n_layers))

    def _topology_phase(self, epoch: int, topo, topo_dirty: bool, device_evo: bool):
        """Importance pruning if it fires, then SET (none after the last
        epoch, as in the paper), on the device or on the host. Returns the
        topology's device arrays, which serve the evaluation and the next
        epoch, and whether the host mirror lags them. A masked or dense
        model has none."""
        tc = self.tc
        if self.model.config.impl not in SPARSE_IMPLS:
            return topo, topo_dirty
        prune = tc.pruning is not None and tc.pruning.should_prune(epoch)
        evolve = epoch < tc.epochs - 1 and tc.evolve
        with obs.span("train.topology", pruned=prune, evolved=evolve,
                      device=evolve and device_evo) as sp:
            if prune:
                topo = self._host_topology_op(topo, topo_dirty,
                                              lambda: self._importance_prune(epoch))
                topo_dirty = False
                sp.set(n_params=self.model.n_params)
            if evolve:
                if device_evo:
                    topo, topo_dirty = self._evolve_device(topo), True
                else:
                    topo, topo_dirty = self._host_topology_op(topo, topo_dirty,
                                                              self._evolve), False
        return topo, topo_dirty

    # -- resume (DESIGN.md §8) ----------------------------------------------

    def save_checkpoint(self, manager) -> None:
        """Epoch-boundary snapshot carrying the whole resume state at step
        ``gstep``: params, velocity, topology (the host mirror, which the
        fused loop syncs before the epoch-end hook), the epoch and step
        counters, the numpy rng, the generator's state
        (``resume.torch_generator``) and the history. The reference's meta
        keys are all there, ``jax_key`` as :func:`jax_key_words` makes it,
        so the reference restores the checkpoint too. A masked or dense
        model saves no topology, as the reference's: its restore keeps the
        live model's mask."""
        model, cfg = self.model, self.model.config
        topologies = None
        if cfg.impl in SPARSE_IMPLS:
            topologies = {
                f"layer{l}": {"rows": model.topos[l].rows, "cols": model.topos[l].cols}
                for l in range(cfg.n_layers)
            }
        meta = {
            "kind": "sequential",
            "resume": {
                "epoch_next": int(self.epoch_next),
                "gstep": int(self.gstep),
                "jax_key": jax_key_words(self.key),
                "numpy_rng": self.rng.bit_generator.state,
                "opt_step": int(self.opt_state.step),
                "history": self.history,
                "seed": self.tc.seed,
                "torch_generator": generator_entry(self.key),
            },
        }
        manager.save(self.gstep, model.params(), extra={"velocity": self.opt_state.velocity},
                     topologies=topologies, meta=meta)

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Rewind the trainer to a saved epoch boundary; ``run()`` then
        continues from there. Defaults to the newest checkpoint that passes
        verification (corrupt ones are quarantined by the scan). The
        generator resumes the saved stream exactly; a reference checkpoint,
        which has none, seeds it from its ``jax_key``
        (:func:`restore_generator`). Returns the restored step."""
        if step is None:
            step = manager.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoints under {manager.dir}")
        manifest = manager.read_manifest(step)
        res = manifest["meta"]["resume"]
        cfg = self.model.config
        like = _params_like(manifest["shapes"], cfg.n_layers)
        params, extra, topologies, _ = manager.restore(
            step, like=like, like_extra={"velocity": like}, device=self.device)
        # topology first: the values' shapes follow the saved topology
        for l in range(cfg.n_layers if cfg.impl in SPARSE_IMPLS else 0):
            t = topologies[f"layer{l}"]
            if cfg.impl == "element":
                self.model.topos[l] = ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1],
                                                      t["rows"], t["cols"])
            else:
                self.model.topos[l] = BlockTopology(block_meta(cfg, l), t["rows"], t["cols"])
        self.model.set_params(params)
        self.opt_state = SGDState(
            velocity=extra["velocity"],
            step=torch.tensor(int(res["opt_step"]), dtype=torch.int32, device=self.device),
        )
        restore_generator(self.key, res.get("torch_generator"), res["jax_key"])
        self.rng.bit_generator.state = res["numpy_rng"]
        self.start_epoch = self.epoch_next = int(res["epoch_next"])
        self.gstep = int(res["gstep"])
        self.history = {k: list(v) for k, v in res["history"].items()}
        return step

    # -- main loop -----------------------------------------------------------

    def _guarded(self, gstep: int, call: Callable):
        """``call()`` (a segment or a step) after the fault hook, under
        ``retry_step`` when ``step_retries > 0``. The generator's state is
        taken before the first attempt and put back before each one, so a
        retry draws what the first attempt drew; the call leaves its inputs
        untouched (not donated), so a retry re-enters with them."""
        def attempt():
            # the hook first: a kill or a transient fires before anything is
            # drawn or written
            if self.fault_hook is not None:
                self.fault_hook(gstep)
            return call()

        if not self.step_retries:
            return attempt()
        state = self.key.get_state()

        def retried():
            self.key.set_state(state)
            return attempt()

        return retry_step(retried, retries=self.step_retries, backoff_s=self.retry_backoff_s)

    def run(self, log_every: int = 0) -> Dict[str, List]:
        mode = "fused" if self.tc.fused_epochs else "per_batch"
        with obs.span("train.run", mode=mode, epochs=self.tc.epochs,
                      start_epoch=self.start_epoch):
            if self.tc.fused_epochs:
                return self._run_fused(log_every)
            return self._run_per_batch(log_every)

    def _prepare(self, fused: bool):
        """The run's upload: in fused mode the training set (``x_all``,
        ``y_all``; None in per-batch mode, whose batches go up step by
        step), and the topology's device arrays."""
        with obs.span("train.prepare") as sp:
            x_all = y_all = None
            h2d_bytes = 0
            if fused:
                x_all = torch.as_tensor(self.data.x_train, device=self.device)
                y_all = torch.as_tensor(self.data.y_train, device=self.device).long()
                h2d_bytes = (_h2d_nbytes(self.data.x_train, self.device)
                             + _h2d_nbytes(self.data.y_train, self.device))
            topo = self.model.topo_arrays()
            sp.set(h2d_bytes=int(h2d_bytes))
            sp.block_on((x_all, y_all, topo))
        return x_all, y_all, topo

    def _loader(self) -> ShardedLoader:
        tc = self.tc
        loader = ShardedLoader(self.data.x_train, self.data.y_train, tc.batch_size, seed=tc.seed)
        if loader.steps_per_epoch == 0:
            raise ValueError("batch_size larger than the training shard")
        return loader

    def _end_epoch(self, epoch: int, t0: float, losses: torch.Tensor, gstep: int,
                   log_every: int, topo, topo_dirty: bool = False, probe_dev=None,
                   ep_sp=obs.trace.NOOP_SPAN) -> bool:
        """Wait for the epoch's device work, evaluate, record the probe's
        snapshot (with ``probe_dev``, the segment's probe stats) and the
        history, and call the epoch-end hook, which reads the host mirror:
        synced first if it lags ``topo``. Returns whether it still lags."""
        tc, model = self.tc, self.model
        with obs.span("train.wait"):
            _sync(self.device)
            dt = time.perf_counter() - t0
            train_loss = float(losses.mean())
        if (epoch + 1) % tc.eval_every == 0 or epoch == tc.epochs - 1:
            acc = evaluate(model, self.data.x_test, self.data.y_test, topo_arrays=topo)
        else:
            acc = float("nan")
        n_params = model.n_params
        if probe_dev is not None:
            # host-side, after the sync above: the probe's stats leave the
            # device only here
            churn = None
            if self._last_churn is not None:
                counts, nnz = self._last_churn
                churn = [float(c) / max(1, n) for c, n in zip(counts.tolist(), nnz)]
                self._last_churn = None
            probes.record_snapshot(gstep, "train", probe_dev, churn=churn,
                                   extra={"epoch": epoch, "loss": train_loss,
                                          "n_params": n_params})
        self.history["epoch"].append(epoch)
        self.history["train_loss"].append(train_loss)
        self.history["test_acc"].append(acc)
        self.history["n_params"].append(n_params)
        self.history["epoch_seconds"].append(dt)
        ep_sp.set(loss=train_loss, n_params=n_params)
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch:4d} loss {train_loss:.4f} acc {acc:.4f} params {n_params}")
        self.gstep = gstep
        self.epoch_next = epoch + 1
        if self.epoch_end_hook is not None:
            with obs.span("train.hook"):
                if topo_dirty:
                    self._sync_topology_to_host(topo)
                    topo_dirty = False
                self.epoch_end_hook(self, epoch)
        return topo_dirty

    def _run_fused(self, log_every: int) -> Dict[str, List]:
        tc, model = self.tc, self.model
        dev = self.device
        loader = self._loader()
        steps = loader.steps_per_epoch
        lr_fn = tc.lr_schedule or (lambda step: tc.lr)
        x_all, y_all, topo = self._prepare(fused=True)
        gstep = self.gstep
        device_evo = tc.evolve and tc.device_evolution and self._supports_device_evolution()
        topo_dirty = False  # the device topology has moved on from model.topos
        segment = self._probe_segment or self._segment
        for epoch in range(self.start_epoch, tc.epochs):
            with obs.span("train.epoch", epoch=epoch) as ep_sp:
                t0 = time.perf_counter()
                with obs.span("train.feed") as feed_sp:
                    order = loader.epoch_order(epoch).reshape(steps, tc.batch_size)
                    rates = np.array([float(lr_fn(gstep + i)) for i in range(steps)],
                                     dtype=np.float32)
                    perm = torch.as_tensor(order, device=dev)
                    lrs = torch.as_tensor(rates, device=dev)
                    feed_sp.set(h2d_bytes=_h2d_nbytes(order, dev) + _h2d_nbytes(rates, dev))
                # on a card the span ends where the segment's losses are
                # made, so it times the device's work
                with obs.span("train.segment", steps=steps) as seg_sp:
                    out = self._guarded(gstep, lambda: segment(
                        model.params(), self.opt_state, topo, x_all, y_all, perm, lrs, self.key))
                    params, self.opt_state, self.key, losses = out[:4]
                    probe_dev = out[4] if tc.probe else None
                    seg_sp.block_on(losses)
                gstep += steps
                model.set_params(params)
                topo, topo_dirty = self._topology_phase(epoch, topo, topo_dirty, device_evo)
                topo_dirty = self._end_epoch(epoch, t0, losses, gstep, log_every, topo,
                                             topo_dirty, probe_dev=probe_dev, ep_sp=ep_sp)
        if topo_dirty:
            self._sync_topology_to_host(topo)
        return self.history

    def _run_per_batch(self, log_every: int) -> Dict[str, List]:
        tc, model = self.tc, self.model
        dev = self.device
        loader = self._loader()
        lr_fn = tc.lr_schedule or (lambda step: tc.lr)
        gstep = self.gstep
        _, _, topo = self._prepare(fused=False)
        for epoch in range(self.start_epoch, tc.epochs):
            with obs.span("train.epoch", epoch=epoch) as ep_sp:
                t0 = time.perf_counter()
                params = model.params()
                losses = []
                # one span per epoch's worth of per-batch steps, not per step
                with obs.span("train.segment", mode="per_batch") as seg_sp:
                    for xb, yb in loader.epoch(epoch):
                        lr = torch.tensor(float(lr_fn(gstep)), dtype=torch.float32, device=dev)
                        xb = torch.as_tensor(xb, device=dev)
                        yb = torch.as_tensor(yb, device=dev).long()
                        params, self.opt_state, loss = self._guarded(
                            gstep, lambda p=params: self._step(p, self.opt_state, topo, xb, yb,
                                                               lr, self.key))
                        losses.append(loss)
                        gstep += 1
                    seg_sp.set(steps=len(losses))
                    seg_sp.block_on(params)
                model.set_params(params)
                topo, _ = self._topology_phase(epoch, topo, False, device_evo=False)
                self._end_epoch(epoch, t0, torch.stack(losses), gstep, log_every, topo,
                                ep_sp=ep_sp)
        return self.history


class XLTrainer:
    """Out-of-core SET trainer: the paper's Table-4 regime, where the live
    parameters exceed the device budget. Twin of the reference's
    ``XLTrainer``.

    Same epoch protocol and history columns as :class:`SequentialTrainer`
    (same ``ShardedLoader`` order for the same seed, same loss/optimizer
    semantics as ``launch.steps.make_mlp_step_core``), but every minibatch
    step runs on the shard-streamed substrate (``repro_torch.xl.
    StreamExecutor``: kernels A, B, F and G on the card) under the memory
    plan's device budget, values/momentum stay on the host (memmap above the
    plan threshold), and SET evolution runs shard-wise on the host
    (``repro_torch.xl.evolve_model_streamed``, the numpy rng) instead of
    whole-layer. It runs on ``device`` (the card unless the caller asks for
    the CPU; a model's own device when it is built from one).

    Constraints vs the in-core trainer: element impl only, ``dropout == 0``
    (the streamed backward is hand-derived) and no importance-pruning
    schedule (shape changes would re-plan). ``fault_hook(gstep)`` fires
    before every streamed step, and ``step_retries > 0`` runs it under
    ``retry_step``, as the reference's. The streamed step is donated
    (``runtime.donation``): it writes the host values, momentum and biases
    in place, shard by shard, and fills the pinned ring as it goes. The hook
    fires before any of that, so a fault raised there leaves the state and
    the ring untouched and its retry is exact; a fault raised inside the
    step, after some shards were updated, is not retried into the same
    trajectory (the supervisor's checkpoint restore is the recovery for it).
    ``TrainerConfig(probe=True)`` records one ``"xl"`` snapshot per epoch,
    ``StreamExecutor.probe_stats`` on the epoch's last batch.
    """

    def __init__(self, model_or_state, data: Dataset, tc: TrainerConfig, plan,
                 spool_dir: Optional[str] = None, device=None):
        from repro_torch.xl import StreamExecutor, XLModelState

        if isinstance(model_or_state, XLModelState):
            self.state = model_or_state
        else:
            cfg = model_or_state.config
            if cfg.dropout != 0:
                raise ValueError("XLTrainer requires dropout == 0")
            self.state = XLModelState.from_model(
                model_or_state, plan, spool_dir=spool_dir
            )
            if device is None:
                device = model_or_state.device
        if tc.pruning is not None:
            raise ValueError("XLTrainer does not support importance pruning")
        if tc.batch_size != plan.batch:
            raise ValueError(
                f"plan solved for batch {plan.batch}, trainer uses "
                f"{tc.batch_size}: re-plan"
            )
        self.plan = plan
        self.data = data
        self.tc = tc
        self.executor = StreamExecutor(self.state, device)
        self.device = self.executor.device
        self.rng = np.random.default_rng(tc.seed)
        self.history: Dict[str, List] = {
            "epoch": [], "train_loss": [], "test_acc": [], "n_params": [],
            "epoch_seconds": [],
        }
        # resume surface, as SequentialTrainer's (DESIGN.md §8), streamed
        # state instead of tensors
        self.start_epoch = 0
        self.epoch_next = 0
        self.gstep = 0
        self.epoch_end_hook: Optional[Callable] = None
        self.fault_hook: Optional[Callable[[int], None]] = None  # hook(gstep)
        self.step_retries = 0  # retry_step wrap when > 0
        self.retry_backoff_s = 0.0

    @property
    def n_params(self) -> int:
        return sum(st.nnz + st.out_dim for st in self.state.layers)

    def evaluate(self, x: np.ndarray, y: np.ndarray) -> float:
        """Accuracy on (x, y) over the streamed forward, traced as one
        ``train.evaluate`` span (``rows``, ``batches``, ``acc``)."""
        n, b = x.shape[0], self.plan.batch
        with obs.span("train.evaluate", rows=int(n), batches=-(-n // b)) as sp:
            correct = 0
            for s in range(0, n, b):
                logits = self.executor.logits(x[s : s + b])
                correct += int((np.argmax(logits, -1) == y[s : s + b]).sum())
            acc = correct / n
            sp.set(acc=acc)
        return acc

    def save_checkpoint(self, manager, step: Optional[int] = None) -> None:
        """Streamed shard-group save (``CheckpointManager.save_streamed``),
        carrying the trainer's resume state so :meth:`from_checkpoint`
        continues the run (DESIGN.md §8); the reference's layout and meta
        keys, so either package restores it."""
        self.state.save(
            manager,
            self.gstep if step is None else step,
            extra_meta={
                "plan": self.plan.to_json(),
                "resume": {
                    "epoch_next": int(self.epoch_next),
                    "gstep": int(self.gstep),
                    "numpy_rng": self.rng.bit_generator.state,
                    "history": self.history,
                    "seed": self.tc.seed,
                },
            },
        )

    def _resume_from(self, manager, step: int) -> None:
        res = manager.read_manifest(step)["meta"].get("resume")
        if res:
            self.start_epoch = self.epoch_next = int(res["epoch_next"])
            self.gstep = int(res["gstep"])
            self.rng.bit_generator.state = res["numpy_rng"]
            self.history = {k: list(v) for k, v in res["history"].items()}

    def restore_checkpoint(
        self, manager, step: Optional[int] = None, spool_dir: Optional[str] = None
    ) -> int:
        """Rewind to a saved epoch boundary: streamed-restore the host state
        (fresh StreamExecutor) and rewind the counters so ``run()``
        continues the interrupted trajectory. Defaults to the newest *valid*
        checkpoint (corrupt ones are quarantined by the backward scan).
        Returns the restored step."""
        from repro_torch.xl import StreamExecutor, XLModelState

        if step is None:
            step = manager.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoints under {manager.dir}")
        self.state = XLModelState.restore(
            manager, self.plan, step, spool_dir=spool_dir
        )
        self.executor = StreamExecutor(self.state, self.device)
        self._resume_from(manager, step)
        return step

    @classmethod
    def from_checkpoint(
        cls,
        manager,
        data: Dataset,
        tc: TrainerConfig,
        plan,
        step: Optional[int] = None,
        spool_dir: Optional[str] = None,
        device=None,
    ) -> "XLTrainer":
        """Build a fresh trainer directly from a checkpoint (no in-core
        model required: the streamed state is the source of truth)."""
        from repro_torch.xl import XLModelState

        if step is None:
            step = manager.latest_valid_step()
            if step is None:
                raise FileNotFoundError(f"no valid checkpoints under {manager.dir}")
        state = XLModelState.restore(manager, plan, step, spool_dir=spool_dir)
        trainer = cls(state, data, tc, plan, device=device)
        trainer._resume_from(manager, step)
        return trainer

    def run(self, log_every: int = 0) -> Dict[str, List]:
        from repro_torch.xl import evolve_model_streamed
        from repro_torch.xl.stream import compile_counts

        tc = self.tc
        loader = ShardedLoader(
            self.data.x_train, self.data.y_train, tc.batch_size, seed=tc.seed
        )
        if loader.steps_per_epoch == 0:
            raise ValueError("batch_size larger than the training shard")
        lr_fn = tc.lr_schedule or (lambda step: tc.lr)
        gstep = self.gstep
        with obs.span("train.run", mode="xl", epochs=tc.epochs, start_epoch=self.start_epoch):
            for epoch in range(self.start_epoch, tc.epochs):
                with obs.span("train.epoch", epoch=epoch) as ep_sp:
                    t0 = time.perf_counter()
                    losses = []
                    probe_batch = None
                    # one span over the epoch's streamed steps, not one per
                    # shard; the executor syncs every step (it reads the loss)
                    with obs.span("train.segment", mode="xl"):
                        for xb, yb in loader.epoch(epoch):
                            probe_batch = (xb, yb)

                            def do_step(xb=xb, yb=yb, gstep=gstep):
                                # the hook fires before the streamed step
                                # writes the host state, so a transient
                                # raised here retries cleanly
                                if self.fault_hook is not None:
                                    self.fault_hook(gstep)
                                return self.executor.train_step(
                                    xb, yb, float(lr_fn(gstep)), momentum=tc.momentum,
                                    weight_decay=tc.weight_decay)

                            losses.append(
                                retry_step(do_step, retries=self.step_retries,
                                           backoff_s=self.retry_backoff_s)
                                if self.step_retries else do_step())
                            gstep += 1
                    evo_stats = None
                    if epoch < tc.epochs - 1 and tc.evolve:
                        with obs.span("train.topology", pruned=False, evolved=True,
                                      device=False):
                            evo_stats = evolve_model_streamed(self.state, tc.zeta, self.rng)
                    if tc.probe and probe_batch is not None:
                        layer_stats = self.executor.probe_stats(*probe_batch)
                        churn = None
                        if evo_stats is not None:
                            churn = [e["n_pruned"] / max(1, st.nnz)
                                     for e, st in zip(evo_stats, self.state.layers)]
                        probes.record_snapshot(gstep, "xl", layers=layer_stats, churn=churn,
                                               extra={"epoch": epoch,
                                                      "loss": float(np.mean(losses))})
                    dt = time.perf_counter() - t0
                    if (epoch + 1) % tc.eval_every == 0 or epoch == tc.epochs - 1:
                        acc = self.evaluate(self.data.x_test, self.data.y_test)
                    else:
                        acc = float("nan")
                    self.history["epoch"].append(epoch)
                    self.history["train_loss"].append(float(np.mean(losses)))
                    self.history["test_acc"].append(acc)
                    self.history["n_params"].append(self.n_params)
                    self.history["epoch_seconds"].append(dt)
                    ep_sp.set(loss=self.history["train_loss"][-1],
                              peak_dev_bytes=int(self.executor.measured_peak_bytes))
                    if log_every and (epoch + 1) % log_every == 0:
                        print(
                            f"epoch {epoch:4d} loss {self.history['train_loss'][-1]:.4f} "
                            f"acc {acc:.4f} params {self.n_params} "
                            f"peak_dev {self.executor.measured_peak_bytes}"
                        )
                    self.gstep = gstep
                    self.epoch_next = epoch + 1
                    if self.epoch_end_hook is not None:
                        self.epoch_end_hook(self, epoch)
            # the substrate's static buffers as gauges: a count that grew
            # with scale shows in the Prometheus snapshot
            obs.record_compile_counts(compile_counts(), prefix="xl_compile_cache")
        return self.history


# ---------------------------------------------------------------------------
# contract auditor registration (repro_torch.analysis, DESIGN.md §10)
# ---------------------------------------------------------------------------


def analysis_programs():
    """Registry hook: the fused epoch segment — the headline training hot
    path — at the reference's audit scale (nnz above its espmm dispatch
    thresholds), contract field for field. On the card the element
    products run kernels A and F; on the CPU their plain versions, whose
    ``index_add_`` walks the sorted segment ids. The port's segment is not
    donated (``retry_step`` re-enters it), which the waiver file records
    (``train.segment:donation-aliasing``)."""
    from repro_torch.analysis.registry import AuditProgram, Contract, ProgramSpec
    from repro_torch.core import sparsity

    audit_dims = (784, 256, 100)
    audit_eps = 20.0
    batch, steps = 32, 2

    def build(device=None) -> AuditProgram:
        cfg = SparseMLPConfig(layer_dims=audit_dims, epsilon=audit_eps, dropout=0.0)
        model = SparseMLP(cfg, seed=0, device=device)
        dev = model.device
        opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
        n_train = steps * batch
        key = torch.Generator(device=dev)
        key.manual_seed(0)
        args = (
            model.params(),
            opt.init(model.params()),
            model.topo_arrays(),
            torch.zeros((n_train, audit_dims[0]), dtype=torch.float32, device=dev),
            torch.zeros((n_train,), dtype=torch.int64, device=dev),
            torch.arange(n_train, device=dev).reshape(steps, batch),
            torch.full((steps,), 0.01, dtype=torch.float32, device=dev),
            key,
        )
        nnz = [t.nnz for t in model.topos]
        return AuditProgram(
            make=lambda donate: make_segment_program(cfg, opt),
            args=args,
            meta={"dims": audit_dims, "batch": batch, "nnz": nnz},
        )

    return [
        ProgramSpec(
            name="train.segment",
            subsystem=__name__,
            contract=Contract(
                # the reference's one legal unsorted scatter, the CE-loss
                # label gather's backward, sized (batch, n_classes)
                max_unsorted_scatter=1,
                max_unsorted_scatter_elems=batch * audit_dims[-1],
                max_intermediate_elems=sparsity.SPMM_TEMP_BUDGET_ELEMS,
                donate_argnums=(0, 1),
                max_temp_bytes=8 * 1024 * 1024,
                expected_compiles=1,
            ),
            build=build,
            notes="fused epoch: steps in order over the device-resident data",
            kernels=("coo_matmul_T", "coo_dw"),
        )
    ]
