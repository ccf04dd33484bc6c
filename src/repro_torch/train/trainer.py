"""Sequential SET trainer — paper Algorithm 2 (SET + Importance Pruning).

Twin of ``repro.train.trainer.SequentialTrainer`` for element-sparse (COO,
the paper's) and block-sparse SET-MLPs, with the same ``TrainerConfig``,
the same epoch protocol and the same ``history`` keys. Two execution modes
(``TrainerConfig.fused_epochs``):

* **Fused (default)** — the training set lives on the device, the host ships
  only the epoch's shuffled index permutation and learning rates, and
  ``launch.steps.scan_segment`` runs every minibatch step with the losses
  kept on the device: one host synchronisation per epoch.
* **Per-batch** — one step call per minibatch from host numpy batches.

Per epoch, both modes: momentum-SGD minibatch steps (on the card the
element products run on kernels A, F and G, the block products on C, D and
E), then
  1. Importance Pruning (if the schedule fires): remove the weak hidden
     neurons' incoming connections and, on an element model, their outgoing
     ones in the next layer too (the output layer takes only that cascade);
     a block model zeroes the neurons' columns and frees the tiles left
     empty;
  2. the SET pruning-regrowing cycle on the host (``core.topology.
     evolve_element``: the zeta-tail per sign, random regrowth drawn by the
     model's init scheme; ``evolve_block``: the zeta-tail of tiles by mean
     |w|, zero-init), keeping the connection or tile count; momentum is kept
     on survivors and reset on regrown ones;
then evaluation. The topology's device arrays (and an element topology's
segment offsets) are made once after each topology phase, and serve the
evaluation and the next epoch. The same seed gives the reference's epoch
order, pruning and regrowth draws, so at dropout 0 the topology follows the
reference's.

Not in this slice, and refused with an error that says so: device-resident
evolution (``device_evolution=True``), the masked/dense impls,
training-dynamics probes, checkpoints, and the fault hook / step retries.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.importance import (
    PruningSchedule,
    importance_prune_block,
    importance_prune_element,
)
from repro_torch.core.sparsity import ElementTopology
from repro_torch.core.topology import evolve_block, evolve_element
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import Dataset
from repro_torch.launch.steps import make_mlp_step_core, make_mlp_train_step, scan_segment
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, mlp_forward
from repro_torch.optim.sgd import MomentumSGD, replace_values_velocity

__all__ = [
    "SequentialTrainer",
    "TrainerConfig",
    "evaluate",
    "make_segment_program",
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
    device_evolution: bool = True  # device SET evolution: not in this slice
    probe: bool = False  # training-dynamics probes: not in this slice


def make_segment_program(config: SparseMLPConfig, opt: MomentumSGD, probe: bool = False):
    """The epoch segment: ``segment(params, opt_state, topo_arrays, x_all,
    y_all, perm, lrs, key) -> (params, opt_state, key, losses)`` gathers the
    epoch's batches from the device-resident dataset by the (steps, batch)
    index permutation and runs them in order; ``losses`` stay on the
    device."""
    if probe:
        raise NotImplementedError("training-dynamics probes come with the probes slice")

    def segment(params, opt_state, topo_arrays, x_all, y_all, perm, lrs, key):
        step_core = make_mlp_step_core(config, opt, topo_arrays, x_all, y_all)
        return scan_segment(step_core, params, opt_state, key, (perm, lrs))

    return segment


def evaluate(model: SparseMLP, x: np.ndarray, y: np.ndarray, batch: int = 512, *,
             topo_arrays=None) -> float:
    """Accuracy on (x, y), counted on the device with one synchronisation.
    ``topo_arrays`` are the model's device arrays where the caller has
    them, else they are made."""
    params = model.params()
    topo = model.topo_arrays() if topo_arrays is None else topo_arrays
    dev = model.device
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    with torch.no_grad():
        for s in range(0, x.shape[0], batch):
            xb = torch.as_tensor(x[s : s + batch], device=dev)
            yb = torch.as_tensor(y[s : s + batch], device=dev).long()
            logits = mlp_forward(params, topo, xb, model.config, train=False)
            correct += (logits.argmax(-1) == yb).sum()
    return int(correct) / x.shape[0]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SequentialTrainer:
    """Paper §2.2 protocol (1 worker). History mirrors Table 2 columns."""

    def __init__(self, model: SparseMLP, data: Dataset, tc: TrainerConfig):
        if model.config.impl not in ("element", "block"):
            raise NotImplementedError(
                f"impl={model.config.impl!r}: the port trains element and block models; "
                "the masked and dense impls come with a later slice"
            )
        if tc.evolve and tc.device_evolution:
            raise NotImplementedError(
                "device-resident SET evolution comes with a later slice; pass "
                "TrainerConfig(device_evolution=False) to evolve on the host"
            )
        if tc.probe:
            raise NotImplementedError("training-dynamics probes come with the probes slice")
        self.model = model
        self.data = data
        self.tc = tc
        self.device = model.device
        self.opt = MomentumSGD(momentum=tc.momentum, weight_decay=tc.weight_decay)
        self.opt_state = self.opt.init(model.params())
        self.rng = np.random.default_rng(tc.seed)  # evolution draws, as the reference's
        self.key = torch.Generator(device=self.device)  # dropout draws
        self.key.manual_seed(tc.seed)
        self._step = make_mlp_train_step(model.config, self.opt)
        self._segment = make_segment_program(model.config, self.opt)
        self.history: Dict[str, List] = {
            "epoch": [], "train_loss": [], "test_acc": [], "n_params": [],
            "epoch_seconds": [],
        }
        self.start_epoch = 0          # first epoch run() will execute
        self.epoch_next = 0           # next epoch at the last boundary
        self.gstep = 0                # global minibatch counter
        self.epoch_end_hook: Optional[Callable] = None  # hook(trainer, epoch)
        # the reference's fault-tolerance seams; refused by run() if set
        self.fault_hook: Optional[Callable[[int], None]] = None
        self.step_retries = 0

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

    def _topology_phase(self, epoch: int):
        """Importance pruning if it fires, then SET (none after the last
        epoch, as in the paper); returns the topology's device arrays, made
        once for the evaluation and the next epoch."""
        self._importance_prune(epoch)
        if epoch < self.tc.epochs - 1:
            self._evolve()
        return self.model.topo_arrays()

    def save_checkpoint(self, manager) -> None:
        raise NotImplementedError("checkpoints come with the checkpoint slice")

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        raise NotImplementedError("checkpoints come with the checkpoint slice")

    # -- main loop -----------------------------------------------------------

    def run(self, log_every: int = 0) -> Dict[str, List]:
        if self.fault_hook is not None or self.step_retries:
            raise NotImplementedError(
                "fault hooks and step retries come with the runtime slice"
            )
        if self.tc.fused_epochs:
            return self._run_fused(log_every)
        return self._run_per_batch(log_every)

    def _loader(self) -> ShardedLoader:
        tc = self.tc
        loader = ShardedLoader(self.data.x_train, self.data.y_train, tc.batch_size, seed=tc.seed)
        if loader.steps_per_epoch == 0:
            raise ValueError("batch_size larger than the training shard")
        return loader

    def _end_epoch(self, epoch: int, t0: float, train_loss: float, gstep: int,
                   log_every: int, topo) -> None:
        """Wait for the epoch's device work, evaluate, and record history."""
        tc, model = self.tc, self.model
        _sync(self.device)
        dt = time.perf_counter() - t0
        if (epoch + 1) % tc.eval_every == 0 or epoch == tc.epochs - 1:
            acc = evaluate(model, self.data.x_test, self.data.y_test, topo_arrays=topo)
        else:
            acc = float("nan")
        n_params = model.n_params
        self.history["epoch"].append(epoch)
        self.history["train_loss"].append(train_loss)
        self.history["test_acc"].append(acc)
        self.history["n_params"].append(n_params)
        self.history["epoch_seconds"].append(dt)
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch:4d} loss {train_loss:.4f} acc {acc:.4f} params {n_params}")
        self.gstep = gstep
        self.epoch_next = epoch + 1
        if self.epoch_end_hook is not None:
            self.epoch_end_hook(self, epoch)

    def _run_fused(self, log_every: int) -> Dict[str, List]:
        tc, model = self.tc, self.model
        dev = self.device
        loader = self._loader()
        steps = loader.steps_per_epoch
        lr_fn = tc.lr_schedule or (lambda step: tc.lr)
        x_all = torch.as_tensor(self.data.x_train, device=dev)
        y_all = torch.as_tensor(self.data.y_train, device=dev).long()
        gstep = self.gstep
        topo = model.topo_arrays()
        for epoch in range(self.start_epoch, tc.epochs):
            t0 = time.perf_counter()
            perm = torch.as_tensor(
                loader.epoch_order(epoch).reshape(steps, tc.batch_size), device=dev
            )
            lrs = torch.tensor(
                [float(lr_fn(gstep + i)) for i in range(steps)], dtype=torch.float32, device=dev
            )
            params, self.opt_state, self.key, losses = self._segment(
                model.params(), self.opt_state, topo, x_all, y_all, perm, lrs, self.key,
            )
            gstep += steps
            model.set_params(params)
            topo = self._topology_phase(epoch)
            self._end_epoch(epoch, t0, float(losses.mean()), gstep, log_every, topo)
        return self.history

    def _run_per_batch(self, log_every: int) -> Dict[str, List]:
        tc, model = self.tc, self.model
        dev = self.device
        loader = self._loader()
        lr_fn = tc.lr_schedule or (lambda step: tc.lr)
        gstep = self.gstep
        topo = model.topo_arrays()
        for epoch in range(self.start_epoch, tc.epochs):
            t0 = time.perf_counter()
            params = model.params()
            losses = []
            for xb, yb in loader.epoch(epoch):
                lr = torch.tensor(float(lr_fn(gstep)), dtype=torch.float32, device=dev)
                params, self.opt_state, loss = self._step(
                    params, self.opt_state, topo, torch.as_tensor(xb, device=dev),
                    torch.as_tensor(yb, device=dev).long(), lr, self.key,
                )
                losses.append(loss)
                gstep += 1
            model.set_params(params)
            topo = self._topology_phase(epoch)
            self._end_epoch(epoch, t0, float(torch.stack(losses).mean()), gstep, log_every,
                            topo)
        return self.history
