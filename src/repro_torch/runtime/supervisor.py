"""Crash recovery and fault tolerance for the resumable trainers
(DESIGN.md §8: failure model, recovery protocol, trajectory equivalence).
Twin of ``repro.runtime.supervisor``.

Two layers live here. The *run loop*: ``run_supervised(trainer, config)``
wraps any trainer exposing the resume surface (``SequentialTrainer``,
``XLTrainer``; WASAP via its own phase-wise checkpointing) with the
recovery protocol. The *fault-tolerance primitives* it and the distributed
substrate consume: ``retry_step`` (transient retry with backoff),
``HeartbeatMonitor``/``StragglerPolicy`` (liveness + WASAP-style straggler
mitigation) and ``plan_elastic_mesh``/``ElasticPlan`` (mesh recomputation
when the healthy device count changes). The serving-side counterpart of
this failure model — deadlines, load shedding, circuit breaking — is
``serve/gateway.py`` (DESIGN.md §9).

The recovery protocol:

  1. **Restore** — if the checkpoint dir holds any step dirs, rewind the
     trainer to the newest checkpoint that passes integrity verification
     (``CheckpointManager.latest_valid_step`` — corrupt/partial ones are
     quarantined, the scan falls back past them).
  2. **Checkpoint on cadence** — every ``save_every_epochs`` epoch
     boundaries (and always at the final epoch), the trainer's full resume
     state is snapshotted; the write is atomic, so a kill mid-save leaves
     only a tmp dir the next manager init sweeps.
  3. **Retry transients** — steps run under ``retry_step`` (below;
     ``step_retries`` attempts with backoff) so a transient failure costs a
     retry, not the run.
  4. **Report progress** — ``progress_file`` (atomic tmp+rename) carries
     "gstep epoch" for an external watcher; ``faultinject.wait_and_kill``
     polls it to SIGKILL the process at a deterministic step.

Trajectory equivalence (the §8 contract): because a checkpoint carries every
source of randomness (data-order seed + epoch counter, the trainer's
``torch.Generator`` state, numpy bit-generator state) plus
params/velocity/topology, a kill at any step resumes from the last epoch
boundary and replays the identical trajectory — bit-exact on the in-core
paths, and the streamed XL path round-trips float32 exactly too. Work lost
per kill is bounded by the checkpoint cadence. A retried step re-enters
with the inputs of its first attempt: the trainers restore their generator
before every retry (``train.trainer``).

The module is runnable (``python -m repro_torch.runtime.supervisor``) as a
small deterministic SET-MLP training driver: the subprocess target for the
resilience tests and the card's smoke run. It seeds its own synthetic
dataset, so two invocations with the same flags train the same run — one
uninterrupted, one killed and resumed. It runs on the card unless
``--device cpu`` asks for the CPU; without a card it raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.obs import detect

__all__ = [
    "ElasticPlan",
    "HeartbeatMonitor",
    "StragglerPolicy",
    "SupervisorConfig",
    "plan_elastic_mesh",
    "read_progress",
    "retry_step",
    "run_supervised",
    "write_progress",
]


# ---------------------------------------------------------------------------
# fault-tolerance primitives (failure model & recovery: DESIGN.md §8;
# checkpoint-restore mechanics: §5)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerPolicy:
    """WASAP-inspired mitigation: a straggler's contribution is *stale but
    valid* (RetainValidUpdates) rather than blocking the sync point; beyond
    ``evict_after`` missed beats the worker is evicted and the run goes
    elastic."""

    soft_deadline_s: float = 30.0     # beyond this: straggling (don't block)
    hard_deadline_s: float = 300.0    # beyond this: dead
    evict_after: int = 3              # consecutive hard misses -> evict


class HeartbeatMonitor:
    """Per-worker liveness with deadlines; ``classify()`` is a pure read of
    heartbeat ages, ``tick()`` advances the miss window and performs
    evictions (driver-side; in a real deployment heartbeats arrive over the
    coordination service)."""

    def __init__(self, worker_ids: List[str], policy: StragglerPolicy,
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.clock = clock
        now = clock()
        self.last_beat: Dict[str, float] = {w: now for w in worker_ids}
        self.misses: Dict[str, int] = {w: 0 for w in worker_ids}
        self.evicted: set = set()

    def beat(self, worker_id: str) -> None:
        if worker_id in self.evicted:
            return
        self.last_beat[worker_id] = self.clock()
        self.misses[worker_id] = 0

    def classify(self) -> Dict[str, str]:
        """Pure read: worker -> healthy/straggling/dead/evicted from current
        heartbeat ages. Safe to poll at any frequency — state only advances
        via `beat()` and `tick()`."""
        now = self.clock()
        out = {}
        for w, t in self.last_beat.items():
            if w in self.evicted:
                out[w] = "evicted"
                continue
            age = now - t
            if age > self.policy.hard_deadline_s:
                out[w] = "dead"
            elif age > self.policy.soft_deadline_s:
                out[w] = "straggling"
            else:
                out[w] = "healthy"
        return out

    def tick(self) -> Dict[str, str]:
        """One monitoring interval: charge a miss to every worker past the
        hard deadline, restart its window, evict at `evict_after` consecutive
        misses. Returns the classification as of this tick ("dead" for a
        worker whose miss was just charged, "evicted" once the count trips).
        Call once per poll cycle; `classify()` between ticks never inflates
        miss counts."""
        now = self.clock()
        out = self.classify()
        for w, status in out.items():
            if status != "dead":
                continue
            self.misses[w] += 1
            self.last_beat[w] = now  # restart the window
            if self.misses[w] >= self.policy.evict_after:
                self.evicted.add(w)
                out[w] = "evicted"
                obs.point(
                    "supervisor.evict", worker=w, misses=self.misses[w]
                )
        return out

    @property
    def healthy_count(self) -> int:
        return sum(1 for s in self.classify().values()
                   if s in ("healthy", "straggling"))


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pods: int
    global_batch: int
    note: str

    @property
    def n_devices(self) -> int:
        return self.data * self.model * max(1, self.pods)


def plan_elastic_mesh(
    healthy_devices: int,
    *,
    model_axis: int = 16,
    per_replica_batch: int = 16,
    min_data: int = 1,
) -> ElasticPlan:
    """Largest (pods*data) x model mesh that fits the healthy device count.
    Model axis is preserved (resharding TP state is cheap only along data);
    the data axis shrinks to the largest supported size and the global batch
    rescales. Restore is checkpoint-based: CheckpointManager manifests carry
    sharding metadata, so arrays re-shard onto the new mesh on load."""
    if healthy_devices < model_axis * min_data:
        raise RuntimeError(
            f"only {healthy_devices} healthy devices; "
            f"need >= {model_axis * min_data}"
        )
    data_total = healthy_devices // model_axis
    # prefer powers of two for collective efficiency
    d = 1
    while d * 2 <= data_total:
        d *= 2
    pods, data = (d // 16, 16) if d >= 32 else (1, d)
    return ElasticPlan(
        data=data,
        model=model_axis,
        pods=pods,
        global_batch=d * per_replica_batch,
        note=(
            f"elastic: {healthy_devices} healthy -> "
            f"mesh ({pods}x{data}x{model_axis})"
        ),
    )


def retry_step(
    fn: Callable,
    *args,
    retries: int = 3,
    backoff_s: float = 0.1,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run fn with retry/backoff; on_failure(attempt, err) between attempts
    (e.g. to restore from checkpoint or rebuild the mesh)."""
    err: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001
            err = e
            obs.point(
                "supervisor.retry",
                attempt=attempt,
                error=type(e).__name__,
                final=attempt >= retries,
            )
            if on_failure is not None:
                on_failure(attempt, e)
            if attempt < retries:
                sleep(backoff_s * (2 ** attempt))
    raise err


@dataclasses.dataclass
class SupervisorConfig:
    checkpoint_dir: str
    save_every_epochs: int = 1
    keep_last: int = 3
    async_write: bool = False      # sync writes: a published step is durable
    step_retries: int = 2
    retry_backoff_s: float = 0.0
    progress_file: Optional[str] = None


def write_progress(path: Optional[str], gstep: int, epoch: int) -> None:
    """Atomic progress record — readable mid-kill.

    Line 1: ``gstep epoch heartbeat last_span``. The first two fields keep
    the historical contract (``faultinject.wait_and_kill`` reads
    ``split()[0]``); the heartbeat is a monotonic timestamp so an external
    watcher can tell "slow step" from "hung process" by its age, and
    ``last_span`` is the innermost open obs span (``-`` when tracing is off)
    so a post-mortem of a kill knows *where* the run was.

    When an anomaly monitor is installed (``obs.detect.configure``), line 2
    carries its health block as one JSON object —
    ``{"latest_probe_snapshot", "active_alerts"}`` (DESIGN.md §12) — so the
    watcher that already polls this file sees training-dynamics pathologies
    (dead layer, gradient explosion, churn collapse) without touching the
    timeline store. Watchers reading only line 1 are unaffected.
    """
    if path is None:
        return
    span = obs.current_span_name("-").replace(" ", "_")
    body = f"{gstep} {epoch} {time.monotonic():.6f} {span}\n"
    health = detect.health_block()
    if health is not None:
        body += json.dumps(health, default=float) + "\n"
    p = Path(path)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(body)
    os.replace(tmp, p)


def read_progress(path: str) -> Dict:
    """Parse :func:`write_progress` output (the historical 2-field line,
    the 4-field line, and the optional line-2 health block)."""
    lines = Path(path).read_text().splitlines()
    fields = lines[0].split() if lines else []
    out: Dict = {"gstep": int(fields[0]), "epoch": int(fields[1])}
    if len(fields) >= 3:
        out["heartbeat"] = float(fields[2])
    if len(fields) >= 4:
        out["last_span"] = fields[3]
    rest = "".join(lines[1:]).strip()
    if rest:
        out["health"] = json.loads(rest)
    return out


def run_supervised(trainer, config: SupervisorConfig) -> Dict:
    """Run a resumable trainer under the recovery protocol. Returns
    ``{"history", "resumed_from_step", "manager"}``; call it again on a fresh
    trainer after a crash and it continues from the last valid checkpoint."""
    manager = CheckpointManager(
        config.checkpoint_dir,
        keep_last=config.keep_last,
        async_write=config.async_write,
    )
    resumed_from: Optional[int] = None
    if manager.all_steps():
        try:
            resumed_from = trainer.restore_checkpoint(manager)
            obs.point(
                "supervisor.restore",
                step=resumed_from,
                epoch_next=int(trainer.epoch_next),
            )
        except FileNotFoundError:
            # every existing checkpoint was corrupt: cold start
            obs.point("supervisor.cold_start", reason="no_valid_checkpoint")
    trainer.step_retries = config.step_retries
    trainer.retry_backoff_s = config.retry_backoff_s

    user_fault_hook = trainer.fault_hook
    user_epoch_hook = trainer.epoch_end_hook

    def on_step(gstep):
        # progress first: the watcher must see the step even if the
        # injected fault kills us right after
        write_progress(config.progress_file, gstep, trainer.epoch_next)
        if user_fault_hook is not None:
            user_fault_hook(gstep)

    def on_epoch_end(tr, epoch):
        last = epoch == tr.tc.epochs - 1
        if (epoch + 1) % config.save_every_epochs == 0 or last:
            tr.save_checkpoint(manager)
            obs.point("supervisor.checkpoint", step=tr.gstep, epoch=epoch)
        write_progress(config.progress_file, tr.gstep, tr.epoch_next)
        if user_epoch_hook is not None:
            user_epoch_hook(tr, epoch)

    trainer.fault_hook = on_step
    trainer.epoch_end_hook = on_epoch_end
    try:
        history = trainer.run()
    finally:
        trainer.fault_hook = user_fault_hook
        trainer.epoch_end_hook = user_epoch_hook
    manager.wait()
    return {
        "history": history,
        "resumed_from_step": resumed_from,
        "manager": manager,
    }


# ---------------------------------------------------------------------------
# subprocess driver — resilience tests / CI smoke / recovery benchmark
# ---------------------------------------------------------------------------


def _build_trainer(args):
    import numpy as np

    from repro_torch.data.synthetic import Dataset, make_classification
    from repro_torch.models.mlp import SparseMLP, SparseMLPConfig
    from repro_torch.train.trainer import SequentialTrainer, TrainerConfig

    rng = np.random.default_rng(args.data_seed)
    x, y = make_classification(
        args.n_train + args.n_test, args.n_features,
        n_informative=8, n_redundant=8, n_classes=args.n_classes, rng=rng,
    )
    data = Dataset(
        "supervised-smoke",
        x[: args.n_train].astype(np.float32), y[: args.n_train],
        x[args.n_train :].astype(np.float32), y[args.n_train :],
        args.n_classes,
    )
    cfg = SparseMLPConfig(
        layer_dims=(args.n_features, 64, 64, args.n_classes),
        epsilon=8, dropout=0.2,
    )
    tc = TrainerConfig(
        epochs=args.epochs, batch_size=args.batch_size, evolve=True,
        seed=args.seed, fused_epochs=not args.per_batch,
        probe=getattr(args, "probe", False),
    )
    return SequentialTrainer(SparseMLP(cfg, seed=args.seed, device=args.device), data, tc)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Supervised (crash-recoverable) SET-MLP training run"
    )
    ap.add_argument("--ckpt", required=True, help="checkpoint directory")
    ap.add_argument("--out", help="write final history JSON here")
    ap.add_argument("--progress-file", default=None)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-test", type=int, default=128)
    ap.add_argument("--n-features", type=int, default=32)
    ap.add_argument("--n-classes", type=int, default=5)
    ap.add_argument(
        "--device", default="cuda",
        help="where the run trains: the card (default; raises without one) "
        "or 'cpu' (the kernels' plain versions)",
    )
    ap.add_argument("--save-every-epochs", type=int, default=1)
    ap.add_argument(
        "--per-batch", action="store_true",
        help="per-batch stepping (fault hook fires every minibatch, so a "
        "kill lands genuinely mid-epoch)",
    )
    ap.add_argument(
        "--probe", action="store_true",
        help="enable training-dynamics probes + anomaly monitor; the "
        "progress file gains the line-2 health block (DESIGN.md §12)",
    )
    ap.add_argument(
        "--timeline", default=None,
        help="with --probe: record probe snapshots to this JSONL timeline "
        "(render with `python -m repro_torch.obs report`)",
    )
    ap.add_argument(
        "--probe-pathology", default=None,
        choices=("dead_layer", "explode"),
        help="with --probe: corrupt the probe stream on the way to the "
        "detectors (layer-0 stats zeroed / grad norms scaled 1e6) — fault "
        "injection for the anomaly-detection path, same spirit as "
        "--kill-at-step for the recovery path",
    )
    ap.add_argument(
        "--kill-at-step", type=int, default=None,
        help="self-SIGKILL when the global step counter reaches this value",
    )
    ap.add_argument(
        "--transient-at-step", type=int, action="append", default=None,
        help="inject a transient step failure (recovered by retry_step)",
    )
    args = ap.parse_args(argv)

    trainer = _build_trainer(args)

    hooks = []
    if args.kill_at_step is not None:
        from repro_torch.runtime.faultinject import KillSwitch

        hooks.append(KillSwitch(args.kill_at_step))
    injector = None
    if args.transient_at_step:
        from repro_torch.runtime.faultinject import TransientFaultInjector

        injector = TransientFaultInjector(args.transient_at_step)
        hooks.append(injector)
    if hooks:
        def fault_hook(gstep):
            for h in hooks:
                h(gstep)

        trainer.fault_hook = fault_hook

    import contextlib

    monitor = None
    with contextlib.ExitStack() as stack:
        if args.probe:
            from repro_torch.obs import probes, timeline

            monitor = detect.configure(detect.AnomalyMonitor())
            stack.callback(detect.configure, None)
            if args.probe_pathology is not None:
                stack.callback(probes.set_snapshot_transform, None)
                probes.set_snapshot_transform(
                    probes.zero_layer_transform()
                    if args.probe_pathology == "dead_layer"
                    else probes.scale_grads_transform()
                )
            if args.timeline:
                stack.enter_context(
                    timeline.timeline_to(args.timeline, run_id="supervised")
                )
        result = run_supervised(
            trainer,
            SupervisorConfig(
                checkpoint_dir=args.ckpt,
                save_every_epochs=args.save_every_epochs,
                progress_file=args.progress_file,
            ),
        )
    if args.out:
        payload = {
            "history": result["history"],
            "resumed_from_step": result["resumed_from_step"],
            "transients_raised": injector.raised if injector else 0,
        }
        if monitor is not None:
            payload["health"] = monitor.health_block()
        Path(args.out).write_text(json.dumps(payload, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
