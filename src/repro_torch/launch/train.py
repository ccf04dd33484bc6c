"""The elastic training driver: checkpointed, heartbeat-monitored,
retrying. Twin of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20 \\
        --mesh-data 1 --per-replica-batch 2 --reduced  # one card
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
        --mesh-data 2                                  # two CPU ranks (gloo)

As the reference's, it runs on a (mesh_data, mesh_model) mesh
(``launch.mesh.make_debug_mesh``): one rank a device, the card unless the
caller asks for the CPU, in a process group of mesh_data x mesh_model ranks
(``torchrun``; a 1 x 1 mesh starts its one-rank group in the process). The
parameters and the velocity are stored as DTensors in the reference's
shape-aware shardings of ``model.specs`` (``launch.sharding``), so each
rank holds the bytes a reference shard holds. The step
(:func:`make_sharded_train_step`) gathers the parameters, runs the port's
step on the rank's ``data`` slice of the global batch (so the hand
kernels see the tensors they see on one device), reduces the gradients
and the loss over ``data``, and updates its own shards. The ``model`` axis
splits storage, not compute: the losses equal a 1 x 1 run's on the same
global batch, and no tensor-parallel speed is claimed. The control plane is
the reference's, end to end:

  * resume from the newest checkpoint that passes verification
    (``resume``; exact data-order replay: the batch stream is
    ``default_rng(1234 + start_step)``);
  * a checkpoint every ``save_every`` steps and at the last
    (``CheckpointManager``, its writes on a thread);
  * a heartbeat monitor over ``n_hosts`` hosts around every step: each step
    is one monitoring interval (``tick()``); a host whose beats stop
    (``beat_filter``) is classified straggling, then dead (a miss charged),
    and at ``policy.evict_after`` misses evicted;
  * elastic re-plan: on an eviction, or at ``simulate_failure_at``, the mesh
    is re-planned over the healthy hosts (``plan_elastic_mesh``) and the
    params are restored from ``latest_valid_step()`` onto the same
    shardings (the mesh is kept, as the reference keeps it);
  * transient step faults (``fault_hook``) recover through ``retry_step``.

Checkpoints hold full leaves in the reference's layout: every rank gathers
them on the caller's thread (a collective), then rank 0 alone hands them
to the writer thread. Every rank reads the same step, which rank 0 picks.

For a ``PatternLM`` with the paper's sparse FFN on the card the step runs
kernels C, D and E bf16. It is not donated (``runtime.donation``): it
returns new shards, so a retry re-enters with the inputs of the failed
attempt. The encoder-decoder (``WhisperConfig``) is refused, as in the
reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import default_rules, shape_aware_shardings
from repro_torch.models.transformer import PatternLM
from repro_torch.models.whisper import WhisperConfig, WhisperModel
from repro_torch.optim.sgd import SGDState
from repro_torch.runtime.supervisor import (
    HeartbeatMonitor,
    StragglerPolicy,
    plan_elastic_mesh,
    retry_step,
)
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["DriverConfig", "run_training", "main", "make_sharded_train_step",
           "shard_tree", "gather_tree"]


@dataclasses.dataclass
class DriverConfig:
    arch: str = "qwen1.5-0.5b"
    steps: int = 20
    seq: int = 64
    per_replica_batch: int = 2
    mesh_data: int = 2
    mesh_model: int = 1
    reduced: bool = True
    lr: float = 1e-3
    save_every: int = 10
    ckpt_dir: str = "/tmp/repro_ckpt"
    resume: bool = False
    simulate_failure_at: int = -1
    step_retries: int = 2
    # hosts tracked by the heartbeat monitor; defaults to mesh_data. Tests
    # set it independently so eviction/elastic logic runs on one device.
    n_hosts: Optional[int] = None
    policy: StragglerPolicy = dataclasses.field(default_factory=StragglerPolicy)
    # --- test/fault-injection hooks (DESIGN.md §8) --------------------------
    # beat_filter(host_id, step) -> bool: False suppresses that host's beat
    # this step (an injected straggler / dead host)
    beat_filter: Optional[Callable[[str, int], bool]] = None
    # fault_hook(step): raise to inject a transient step fault (recovered by
    # retry_step) — e.g. faultinject.TransientFaultInjector
    fault_hook: Optional[Callable[[int], None]] = None
    clock: Callable[[], float] = time.monotonic
    verbose: bool = True
    # where the run trains: None is the card (it raises without one)
    device: Optional[Union[str, torch.device]] = None


def synthetic_batch(rng, batch, seq, vocab, prefix=None, d_model=0, device=None):
    """The reference's batch, drawn from ``rng`` in the same order, as
    tensors on ``device`` (None: the card; it raises without one):
    ``tokens`` and ``labels`` (batch, seq) int64 (the reference's int32
    values), and with ``prefix`` the VLM's ``patch_embeds`` (batch, prefix,
    d_model) f32."""
    device = resolve_device(device)
    out = {
        "tokens": torch.as_tensor(rng.integers(0, vocab, (batch, seq)).astype(np.int32),
                                  device=device).long(),
        "labels": torch.as_tensor(rng.integers(0, vocab, (batch, seq)).astype(np.int32),
                                  device=device).long(),
    }
    if prefix:
        out["patch_embeds"] = torch.as_tensor(
            rng.standard_normal((batch, prefix, d_model)).astype(np.float32), device=device)
    return out


def shard_tree(tree, layouts):
    """Each full leaf of ``tree`` (the same on every rank) as a DTensor of
    its :class:`launch.sharding.Layout`."""
    return tree_map(lambda lay, t: lay.distribute(t), layouts, tree)


def gather_tree(tree):
    """The full tensors of a tree of DTensors. A collective: every rank
    calls it, in the same order."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def make_sharded_train_step(model, mesh, layouts, *, lr: float, microbatches: int = 1):
    """The driver's step on a mesh: ``step(params, opt_state, batch, topo)
    -> (params, opt_state, {"loss", "total"})``, ``params`` and
    ``opt_state.velocity`` DTensors of ``layouts``, ``batch`` this rank's
    slice of the global batch (over ``data``, and ``pod`` where the mesh
    has it); a ``WhisperModel``'s takes no ``topo``.

    It gathers the parameters (``full_tensor()``), takes the loss and the
    gradients of ``launch.steps.lm_loss_fn`` (``whisper_loss_fn``) on plain
    tensors (the port's step, hand kernels included), all-reduces the
    gradients, ``total`` and ``loss`` over the batch axes in one f32 buffer
    and divides by their size (the global batch's mean), then applies
    ``make_train_step``'s optimizer to this rank's shards only. Nothing is
    donated: a retry re-enters with the same inputs."""
    import torch.distributed._functional_collectives as funcol

    _, opt = steps_mod.make_train_step(model, lr=lr, microbatches=microbatches)
    names = list(mesh.mesh_dim_names)
    batch_dims = [names.index(a) for a in ("pod", "data") if a in names]
    dp = 1
    for d in batch_dims:
        dp *= mesh.size(d)
    lay_leaves, _ = tree_flatten(layouts)

    def wrap(lay, local, ref):
        return lay.from_local(local, ref.shape)

    def step(params, opt_state: SGDState, batch, topo=None):
        full = gather_tree(params)
        loss_fn = (steps_mod.whisper_loss_fn(model) if isinstance(model, WhisperModel)
                   else steps_mod.lm_loss_fn(model, topo))
        total, loss, grads = steps_mod._microbatched_grad(loss_fn, full, batch, microbatches)
        g_leaves, unflatten = tree_flatten(grads)
        if dp > 1:
            flat = torch.cat([g.reshape(-1).float() for g in g_leaves]
                             + [total.reshape(1).float(), loss.reshape(1).float()])
            for d in batch_dims:
                flat = funcol.all_reduce(flat, "sum", (mesh, d))
            flat = flat / dp
            parts = torch.split(flat, [g.numel() for g in g_leaves] + [1, 1])
            g_leaves = [p.view(g.shape).to(g.dtype) for p, g in zip(parts, g_leaves)]
            total, loss = parts[-2].reshape(()), parts[-1].reshape(())
        local_g = unflatten([lay.shard(g) for lay, g in zip(lay_leaves, g_leaves)])
        local_p = tree_map(lambda t: t.to_local(), params)
        local_v = tree_map(lambda t: t.to_local(), opt_state.velocity)
        new_p, new_s = opt.update(local_g, SGDState(local_v, opt_state.step), local_p, lr)
        return (tree_map(wrap, layouts, new_p, params),
                SGDState(tree_map(wrap, layouts, new_s.velocity, params), new_s.step),
                {"loss": loss, "total": total})

    return step, opt


def _from_rank0(value):
    """``value`` as rank 0 has it, on every rank."""
    import torch.distributed as dist

    if dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run_training(dc: DriverConfig) -> Dict[str, object]:
    """Run the elastic training loop; returns a history dict with per-step
    losses, heartbeat/eviction status, elastic replans and recovery events."""
    import torch.distributed as dist

    log = print if dc.verbose else (lambda *a, **k: None)
    device = resolve_device(dc.device)

    spec = configs.get_spec(dc.arch)
    cfg = spec.smoke if dc.reduced else spec.config
    if isinstance(cfg, WhisperConfig):
        raise SystemExit("use examples/whisper_train.py for the enc-dec driver")
    mesh = make_debug_mesh(dc.mesh_data, dc.mesh_model, device=device)
    rank = dist.get_rank()
    log = log if rank == 0 else (lambda *a, **k: None)
    model = PatternLM(cfg, seed=0, device=device)
    topo = model.topo_arrays()
    rules = default_rules(mesh, n_experts=cfg.n_experts,
                          batch_size=dc.per_replica_batch * dc.mesh_data)
    param_sh = shape_aware_shardings(rules, model.specs, model.params)
    step_fn, opt = make_sharded_train_step(model, mesh, param_sh, lr=dc.lr)
    opt_state = opt.init(model.params)
    opt_state = SGDState(shard_tree(opt_state.velocity, param_sh), opt_state.step)

    ckpt = CheckpointManager(dc.ckpt_dir, keep_last=3)
    params = shard_tree(model.params, param_sh)
    start_step = 0
    resume_at = _from_rank0(ckpt.latest_valid_step() if dc.resume and rank == 0 else None)
    if resume_at is not None:
        params, _, _, manifest = ckpt.restore(step=resume_at, like=model.params,
                                              shardings=param_sh, device=device)
        start_step = manifest["step"]
        log(f"[train] resumed from step {start_step}")

    n_hosts = dc.n_hosts if dc.n_hosts is not None else dc.mesh_data
    hosts = [f"host{i}" for i in range(n_hosts)]
    monitor = HeartbeatMonitor(hosts, dc.policy, clock=dc.clock)
    devices_per_host = max(1, dist.get_world_size() // n_hosts)
    rng = np.random.default_rng(1234 + start_step)  # replayable stream
    batch_size = dc.per_replica_batch * dc.mesh_data
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))["data"]
    rows = slice(coord * dc.per_replica_batch, (coord + 1) * dc.per_replica_batch)

    history: Dict[str, List] = {
        "loss": [], "healthy": [], "status": [],
        "replans": [], "recoveries": [], "resumed_from": start_step,
    }

    def replan_and_restore(reason: str):
        """Device loss: shrink the mesh plan to the healthy hosts and reload
        from the newest checkpoint that passes verification, onto the same
        shardings."""
        healthy = max(1, monitor.healthy_count) * devices_per_host
        plan = plan_elastic_mesh(
            healthy, model_axis=dc.mesh_model,
            per_replica_batch=dc.per_replica_batch, min_data=1,
        )
        log(f"[train] {reason}: {plan.note}; restoring latest valid checkpoint")
        ckpt.wait()
        restored = None
        step = _from_rank0(ckpt.latest_valid_step() if rank == 0 else None)
        if step is not None:
            p, _, _, manifest = ckpt.restore(step=step, like=model.params,
                                             shardings=param_sh, device=device)
            restored = manifest["step"]
        else:
            p = None  # no durable state yet: keep in-memory params
        history["replans"].append(
            {"reason": reason, "plan": plan.note, "restored_step": restored}
        )
        return p

    t0 = time.perf_counter()
    known_evicted: set = set()
    for step in range(start_step, dc.steps):
        batch = synthetic_batch(
            rng, batch_size, dc.seq, cfg.vocab,
            prefix=cfg.prefix_len if spec.family == "vlm" else 0,
            d_model=cfg.d_model, device=device,
        )
        batch = {k: v[rows] for k, v in batch.items()}  # this rank's data slice
        if step == dc.simulate_failure_at:
            p = replan_and_restore("simulated device loss")
            if p is not None:
                params = p

        def do_step(step=step, params=params, opt_state=opt_state, batch=batch):
            # the hook first: a transient fires before the step computes
            if dc.fault_hook is not None:
                dc.fault_hook(step)
            return step_fn(params, opt_state, batch, topo)

        def on_failure(attempt, err, step=step):
            history["recoveries"].append(
                {"step": step, "attempt": attempt, "error": repr(err)}
            )

        params, opt_state, metrics = retry_step(
            do_step, retries=dc.step_retries,
            backoff_s=0.0, on_failure=on_failure,
        )

        # one heartbeat interval per step: live hosts beat (unless an
        # injected fault suppresses them), then the window advances
        for w in hosts:
            if w in monitor.evicted:
                continue
            if dc.beat_filter is None or dc.beat_filter(w, step):
                monitor.beat(w)
        status = monitor.tick()
        n_healthy = monitor.healthy_count
        loss = float(metrics["loss"])
        history["status"].append(status)
        history["healthy"].append(n_healthy)
        history["loss"].append(loss)
        newly_evicted = monitor.evicted - known_evicted
        if newly_evicted and n_healthy:
            known_evicted |= newly_evicted
            p = replan_and_restore(f"evicted {sorted(newly_evicted)}")
            if p is not None:
                params = p

        if (step + 1) % dc.save_every == 0 or step + 1 == dc.steps:
            full = gather_tree(params)  # on every rank, before the writer starts
            if rank == 0:
                ckpt.save(step + 1, full, meta={"arch": dc.arch})
        if step % 5 == 0:
            log(
                f"[train] step {step} loss={loss:.4f} "
                f"healthy={n_healthy}/{n_hosts} "
                f"({time.perf_counter() - t0:.1f}s)"
            )
    ckpt.wait()
    log(f"[train] done: {dc.steps - start_step} steps, "
        f"final loss {history['loss'][-1]:.4f}")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--per-replica-batch", type=int, default=2)
    ap.add_argument("--mesh-data", type=int, default=2)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="the card (default; raises without one) or 'cpu'")
    args = ap.parse_args(argv)
    run_training(
        DriverConfig(
            arch=args.arch, steps=args.steps, seq=args.seq,
            per_replica_batch=args.per_replica_batch,
            mesh_data=args.mesh_data, mesh_model=args.mesh_model,
            reduced=args.reduced, lr=args.lr, save_every=args.save_every,
            ckpt_dir=args.ckpt_dir, resume=args.resume,
            simulate_failure_at=args.simulate_failure_at, device=args.device,
        )
    )
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
