"""Paper-faithful WASAP-SGD phase 1: asynchronous parameter server. Twin of
``repro.core.wasap_ps``.

This is the literal Algorithm 1 protocol (Dean-style PS over shared memory),
kept for the MLP experiments and as the reference semantics for the
device-resident adaptation in ``wasap.py``:

  * K worker threads repeatedly: fetch (model, t'), compute a gradient on
    their own mini-batch on the model's device (the port's ``mlp_forward``
    and autograd: kernels A and F on the card), push (grad, t) — no barrier
    between workers.
  * The PS thread applies each incoming gradient with momentum SGD on the
    host, after ``RetainValidUpdates`` filters entries whose connections no
    longer exist (the topology may have evolved since the worker fetched).
  * Every n/B applied updates (one "epoch"), the PS pauses to run the SET
    topology-evolution step on the host, drawing from its numpy rng; the
    worker may thus be arbitrarily stale.

Straggler mitigation is inherent: a slow worker delays only itself — its
update is still merged when it arrives (optionally down-weighted by
staleness). ``straggler_delay`` injects synthetic stragglers for tests.

PyTorch releases the interpreter lock inside its operators and the kernels'
ctypes calls, so the worker threads overlap.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.topology import evolve_element, retain_valid_updates_element
from repro_torch.data.loader import ShardedLoader
from repro_torch.data.synthetic import Dataset
from repro_torch.models.mlp import SparseMLP, cross_entropy_loss, mlp_forward
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["AsyncPSConfig", "AsyncParameterServer"]


@dataclasses.dataclass
class AsyncPSConfig:
    n_workers: int = 4
    epochs: int = 4                # tau_1
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 2e-4
    zeta: float = 0.3
    batch_size: int = 32
    seed: int = 0
    # Staleness-adaptive LR (MindTheStep-style): scales each update by
    # 1/(1 + discount * staleness). Asynchrony adds *implicit* momentum
    # (Mitliagkas et al. 2016, cited by the paper) on top of the explicit
    # mu=0.9; at this emulation's tiny-step scale that diverges without a
    # discount, so a mild default is on. Set 0.0 for the paper's plain async.
    staleness_discount: float = 0.25
    straggler_delay: float = 0.0      # seconds injected into worker 0 (tests)
    evolve: bool = True


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


class AsyncParameterServer:
    """Shared-state PS with atomic (locked) fetch/push, per Figure 2. The
    model's values and biases are the server's state: they stay on the
    model's device, and each update reads and replaces them."""

    def __init__(self, model: SparseMLP, data: Dataset, cfg: AsyncPSConfig):
        if model.config.impl != "element":
            raise ValueError(f"the parameter server trains element sparsity, not "
                             f"{model.config.impl!r}")
        self.model = model
        self.data = data
        self.cfg = cfg
        self.lock = threading.Lock()
        self.grad_queue: "queue.Queue" = queue.Queue(maxsize=cfg.n_workers * 2)
        self.t_global = 0          # PS update counter  (t' in Algorithm 1)
        self.topo_version = 0
        self.stop_flag = threading.Event()
        self.rng = np.random.default_rng(cfg.seed)
        # velocity per layer (element values) + biases, on the host
        self.vel_values = [np.zeros(t.nnz, np.float32) for t in model.topos]
        self.vel_biases = [np.zeros(int(b.numel()), np.float32) for b in model.biases]
        self.applied_updates = 0
        self.stats = {
            "stale_entries_dropped": 0,
            "updates": 0,
            "evolutions": 0,
            "queue_full_retries": 0,
            "grads_dropped": 0,
        }
        # per-epoch snapshots of the counters above (cumulative), surfaced in
        # run()'s return under "history" so drops/retries are attributable to
        # an epoch instead of only a final total
        self.history: Dict[str, List[int]] = {
            "epoch": [], **{k: [] for k in self.stats}
        }
        self._worker_errors: List[BaseException] = []  # raised by run()

        self._grad_fn = self._make_grad_fn()
        self.steps_per_epoch = (
            data.x_train.shape[0] // cfg.batch_size
        )

    def _make_grad_fn(self):
        """``grad_fn(params, topo_arrays, x, y, rng) -> (loss, grads)``: the
        training forward (dropout from the generator ``rng``) and its
        gradients by autograd, on the tensors' device."""
        config = self.model.config

        def grad_fn(params, topo, x, y, rng):
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
            logits = mlp_forward(leaves, topo, x, config, train=True, rng=rng)
            loss = cross_entropy_loss(logits, y)
            flat, unflatten = tree_flatten(leaves)
            grads = torch.autograd.grad(loss, flat)
            return loss.detach(), unflatten(list(grads))

        return grad_fn

    # -- atomic PS ops (Figure 2: atomic read / write) ----------------------

    def fetch(self):
        with self.lock:
            snapshot = (
                [t for t in self.model.topos],        # immutable objects
                [_host(v) for v in self.model.values],
                [_host(b) for b in self.model.biases],
                self.topo_version,
                self.t_global,
            )
        return snapshot

    def push(self, grads_values, grads_biases, topo_version, t_worker):
        self.grad_queue.put((grads_values, grads_biases, topo_version, t_worker))

    # -- server loop ---------------------------------------------------------

    def _apply(self, gv: List[np.ndarray], gb, worker_topos, staleness: int):
        cfg = self.cfg
        dev = self.model.device
        scale = 1.0 / (1.0 + cfg.staleness_discount * staleness)
        with self.lock:
            for l in range(len(self.model.values)):
                g = gv[l]
                if worker_topos is not None:
                    # Algorithm 1 line 14: retain only valid updates
                    before = np.count_nonzero(g)
                    g = retain_valid_updates_element(
                        g, worker_topos[l], self.model.topos[l]
                    )
                    self.stats["stale_entries_dropped"] += int(
                        before - np.count_nonzero(g)
                    )
                v = _host(self.model.values[l])
                g = g + cfg.weight_decay * v
                self.vel_values[l] = (
                    cfg.momentum * self.vel_values[l] - cfg.lr * scale * g
                )
                self.model.values[l] = torch.as_tensor(v + self.vel_values[l], device=dev)
                b = _host(self.model.biases[l])
                gbl = gb[l] + cfg.weight_decay * b
                self.vel_biases[l] = (
                    cfg.momentum * self.vel_biases[l] - cfg.lr * scale * gbl
                )
                self.model.biases[l] = torch.as_tensor(b + self.vel_biases[l], device=dev)
            self.t_global += 1
            self.stats["updates"] += 1

    def _evolve(self):
        cfg = self.cfg
        dev = self.model.device
        with self.lock:  # master pauses async updates (Algorithm 1 line 16-18)
            for l in range(len(self.model.topos)):
                res = evolve_element(
                    self.model.topos[l],
                    _host(self.model.values[l]),
                    cfg.zeta,
                    self.rng,
                    momentum=self.vel_values[l],
                    init_scheme=self.model.config.init,
                )
                self.model.topos[l] = res.topology
                self.model.values[l] = torch.as_tensor(res.values, device=dev)
                self.vel_values[l] = res.momentum
            self.topo_version += 1
            self.stats["evolutions"] += 1

    def _server_loop(self):
        cfg = self.cfg
        total_updates = cfg.epochs * self.steps_per_epoch
        while self.applied_updates < total_updates:
            try:
                gv, gb, tv, tw = self.grad_queue.get(timeout=5.0)
            except queue.Empty:
                if self.stop_flag.is_set():
                    return
                continue
            worker_topos = gv.pop("topos")
            staleness = self.t_global - tw
            self._apply(
                gv["values"], gb,
                worker_topos if tv != self.topo_version else None,
                staleness,
            )
            self.applied_updates += 1
            if (
                self.applied_updates % self.steps_per_epoch == 0
                and self.applied_updates < total_updates
            ):
                if cfg.evolve:
                    self._evolve()
                self._snapshot_stats(self.applied_updates // self.steps_per_epoch)
        self.stop_flag.set()

    def _snapshot_stats(self, epoch: int) -> None:
        with self.lock:
            self.history["epoch"].append(epoch)
            for k, v in self.stats.items():
                self.history[k].append(int(v))

    # -- worker loop -----------------------------------------------------------

    def _worker_loop(self, wid: int):
        cfg = self.cfg
        dev = self.model.device
        loader = ShardedLoader(
            self.data.x_train, self.data.y_train, cfg.batch_size,
            seed=cfg.seed, shard_id=wid, num_shards=cfg.n_workers,
        )
        key = torch.Generator(device=dev)  # this worker's dropout draws
        key.manual_seed(cfg.seed * 131 + wid)
        epoch = 0
        while not self.stop_flag.is_set():
            for xb, yb in loader.epoch(epoch):
                if self.stop_flag.is_set():
                    return
                topos, values, biases, tv, tw = self.fetch()
                topo_arrays = tuple(t.device_arrays(dev) for t in topos)
                params = {
                    "values": tuple(torch.as_tensor(v, device=dev) for v in values),
                    "biases": tuple(torch.as_tensor(b, device=dev) for b in biases),
                }
                _, grads = self._grad_fn(
                    params, topo_arrays, torch.as_tensor(xb, device=dev),
                    torch.as_tensor(yb, device=dev).long(), key,
                )
                if cfg.straggler_delay and wid == 0:
                    time.sleep(cfg.straggler_delay)
                gv = {
                    "values": [_host(g) for g in grads["values"]],
                    "topos": topos,
                }
                gb = [_host(g) for g in grads["biases"]]
                # a full queue means the PS is momentarily behind — keep
                # retrying the push for THIS gradient rather than silently
                # discarding the computed work and advancing to the next batch
                pushed = False
                while not self.stop_flag.is_set():
                    try:
                        self.grad_queue.put((gv, gb, tv, tw), timeout=1.0)
                        pushed = True
                        break
                    except queue.Full:
                        with self.lock:
                            self.stats["queue_full_retries"] += 1
                if not pushed:
                    # shutdown raced the retry. A gradient the completed run
                    # never needed is surplus pipelined work, not a loss —
                    # only a gradient the run still required counts as
                    # dropped, so a clean shutdown reports zero drops.
                    total = self.cfg.epochs * self.steps_per_epoch
                    with self.lock:
                        if self.applied_updates < total:
                            self.stats["grads_dropped"] += 1
                    return
            epoch += 1

    def _worker_main(self, wid: int) -> None:
        """A worker thread: a failure (a kernel's error on the card) stops
        the run, and ``run`` raises it, instead of leaving the server
        waiting for gradients that never come."""
        try:
            self._worker_loop(wid)
        except Exception as e:  # noqa: BLE001 — reported by run()
            with self.lock:
                self._worker_errors.append(e)
            self.stop_flag.set()

    # -- entry -----------------------------------------------------------------

    def run(self) -> Dict[str, object]:
        server = threading.Thread(target=self._server_loop, daemon=True)
        workers = [
            threading.Thread(target=self._worker_main, args=(w,), daemon=True)
            for w in range(self.cfg.n_workers)
        ]
        t0 = time.perf_counter()
        server.start()
        for w in workers:
            w.start()
        server.join()
        self.stop_flag.set()
        for w in workers:
            w.join(timeout=10.0)
        if self._worker_errors:
            raise RuntimeError("a parameter-server worker failed") from self._worker_errors[0]
        # final snapshot AFTER workers exit, so drops charged during the
        # shutdown race are attributed to the last epoch rather than lost
        self._snapshot_stats(self.cfg.epochs)
        return {
            "seconds": time.perf_counter() - t0,
            **self.stats,
            "topo_version": self.topo_version,
            "history": self.history,
        }
