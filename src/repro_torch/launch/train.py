"""The elastic training driver: checkpointed, heartbeat-monitored,
retrying. Twin of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20 \\
        --per-replica-batch 2 --reduced                # on the card
    python -m repro_torch.launch.train --device cpu    # the plain versions

The reference runs it per host on a (data, model) device mesh; the port
runs on ONE device, the card unless the caller asks for the CPU (the
default mesh is 1 x 1 here, and a larger one raises, naming the pod
machinery: ROADMAP Queue 1, item 9). On that device the control plane is
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
    params are restored from ``latest_valid_step()``, placed on the device;
  * transient step faults (``fault_hook``) recover through ``retry_step``.

The step is ``launch.steps.make_train_step``: for a ``PatternLM`` with the
paper's sparse FFN on the card it runs kernels C, D and E bf16. It is not
donated (``runtime.donation``): it returns new params and velocity, so a
retry re-enters with the inputs of the failed attempt. The
encoder-decoder (``WhisperConfig``) is refused, as in the reference.
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
from repro_torch.models.transformer import PatternLM
from repro_torch.models.whisper import WhisperConfig
from repro_torch.runtime.supervisor import (
    HeartbeatMonitor,
    StragglerPolicy,
    plan_elastic_mesh,
    retry_step,
)

__all__ = ["DriverConfig", "run_training", "main"]

_MESH = ("a (data, model) mesh larger than 1 x 1 comes with the pod machinery "
         "(ROADMAP Queue 1, item 9: torch.distributed); the port's driver runs on one device")


@dataclasses.dataclass
class DriverConfig:
    arch: str = "qwen1.5-0.5b"
    steps: int = 20
    seq: int = 64
    per_replica_batch: int = 2
    mesh_data: int = 1  # the reference's default is 2; the port runs on one device
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


def synthetic_batch(rng, batch, seq, vocab, prefix=None, d_model=0, device="cpu"):
    """The reference's batch, drawn from ``rng`` in the same order, as
    tensors on ``device``: ``tokens`` and ``labels`` (batch, seq) int64 (the
    reference's int32 values), and with ``prefix`` the VLM's
    ``patch_embeds`` (batch, prefix, d_model) f32."""
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


def run_training(dc: DriverConfig) -> Dict[str, object]:
    """Run the elastic training loop; returns a history dict with per-step
    losses, heartbeat/eviction status, elastic replans and recovery events."""
    log = print if dc.verbose else (lambda *a, **k: None)
    if dc.mesh_data * dc.mesh_model > 1:
        raise NotImplementedError(_MESH)
    device = resolve_device(dc.device)

    spec = configs.get_spec(dc.arch)
    cfg = spec.smoke if dc.reduced else spec.config
    if isinstance(cfg, WhisperConfig):
        raise SystemExit("use examples/whisper_train.py for the enc-dec driver")
    model = PatternLM(cfg, seed=0, device=device)
    topo = model.topo_arrays()
    step_fn, opt = steps_mod.make_train_step(model, lr=dc.lr)
    opt_state = opt.init(model.params)

    ckpt = CheckpointManager(dc.ckpt_dir, keep_last=3)
    params = model.params
    start_step = 0
    if dc.resume and ckpt.latest_valid_step() is not None:
        params, _, _, manifest = ckpt.restore(
            step=ckpt.latest_valid_step(), like=model.params, device=device
        )
        start_step = manifest["step"]
        log(f"[train] resumed from step {start_step}")

    n_hosts = dc.n_hosts if dc.n_hosts is not None else dc.mesh_data
    hosts = [f"host{i}" for i in range(n_hosts)]
    monitor = HeartbeatMonitor(hosts, dc.policy, clock=dc.clock)
    devices_per_host = max(1, 1 // n_hosts)  # one device in all
    rng = np.random.default_rng(1234 + start_step)  # replayable stream
    batch_size = dc.per_replica_batch * dc.mesh_data

    history: Dict[str, List] = {
        "loss": [], "healthy": [], "status": [],
        "replans": [], "recoveries": [], "resumed_from": start_step,
    }

    def replan_and_restore(reason: str):
        """Device loss: shrink the mesh plan to the healthy hosts and reload
        from the newest checkpoint that passes verification."""
        healthy = max(1, monitor.healthy_count) * devices_per_host
        plan = plan_elastic_mesh(
            healthy, model_axis=dc.mesh_model,
            per_replica_batch=dc.per_replica_batch, min_data=1,
        )
        log(f"[train] {reason}: {plan.note}; restoring latest valid checkpoint")
        ckpt.wait()
        restored = None
        step = ckpt.latest_valid_step()
        if step is not None:
            p, _, _, manifest = ckpt.restore(step=step, like=model.params, device=device)
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
            ckpt.save(step + 1, params, meta={"arch": dc.arch})
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
    ap.add_argument("--mesh-data", type=int, default=1)
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


if __name__ == "__main__":
    main()
