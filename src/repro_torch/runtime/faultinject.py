"""Deterministic fault injection for resilience tests (DESIGN.md §8). Twin of
``repro.runtime.faultinject``: numpy and ``signal`` only, a copy of the
reference module, so that the same seed gives the same plan.

Every failure mode the recovery layer claims to survive is injectable here,
seeded and replayable:

  * **Process death** — :class:`KillSwitch` delivers a real ``SIGKILL`` to
    the training process at step *k* (uncatchable, mid-step, exactly what a
    preemption looks like from inside); :func:`wait_and_kill` is the
    driver-side variant that watches a supervisor progress file and kills
    the child from outside.
  * **Checkpoint corruption** — :func:`truncate_leaf`, :func:`flip_bytes`,
    :func:`delete_manifest`, :func:`orphan_tmp` damage a published step dir
    the four ways a torn writer / bad disk does; ``CheckpointManager``
    integrity checks must detect all of them.
  * **Transient step failures** — :class:`TransientFaultInjector` raises at
    chosen global steps (first attempt only, or ``persistent=N`` attempts)
    to exercise ``supervisor.retry_step``.
  * **Stragglers / missed heartbeats** — :class:`StragglerInjector` marks
    (worker, round) pairs whose heartbeat should be suppressed, driving
    ``HeartbeatMonitor`` eviction in WASAP and the elastic launch loop;
    it also carries wall-clock delays for the async PS path
    (``AsyncPSConfig.straggler_delay``).
  * **Serving-side faults** — :class:`EngineChaos` composes the two
    injectors above into a ``SparseInferenceEngine.fault_hook``: transient
    raises and straggler stalls keyed on the engine's monotone *call index*
    (prefill/decode/classify invocations), so the serving gateway's retry,
    circuit-breaker and brownout paths (DESIGN.md §9) are exercised by the
    same seeded machinery as the training stack.

:class:`FaultPlan` bundles all of the above; ``FaultPlan.from_seed``
derives a replayable plan from a PRNG seed so a failing resilience run is
reproducible from its seed alone.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

__all__ = [
    "KillSwitch",
    "TransientFault",
    "TransientFaultInjector",
    "StragglerInjector",
    "EngineChaos",
    "FaultPlan",
    "truncate_leaf",
    "flip_bytes",
    "delete_manifest",
    "orphan_tmp",
    "corrupt",
    "CORRUPTION_MODES",
    "wait_and_kill",
]


# ---------------------------------------------------------------------------
# process death
# ---------------------------------------------------------------------------


class KillSwitch:
    """SIGKILL the current process when the step counter reaches ``at_step``.

    A self-delivered SIGKILL is still uncatchable and instantaneous — the
    process dies mid-step with no atexit/finally cleanup, exactly like an
    external preemption, but at a deterministic step. Trainers call
    ``maybe_kill(gstep)`` through their ``fault_hook``.
    """

    def __init__(self, at_step: Optional[int]):
        self.at_step = at_step

    def maybe_kill(self, step: int) -> None:
        if self.at_step is not None and step >= self.at_step:
            os.kill(os.getpid(), signal.SIGKILL)

    __call__ = maybe_kill


def wait_and_kill(
    proc,
    progress_file: str,
    at_step: int,
    timeout_s: float = 300.0,
    poll_s: float = 0.01,
) -> int:
    """Driver-side kill: poll the supervisor's progress file until the child
    reports ``gstep >= at_step``, then SIGKILL it from outside. Returns the
    step actually observed at kill time (>= ``at_step``); raises on timeout
    or if the child exits first."""
    path = Path(progress_file)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"child exited (rc={proc.returncode}) before step {at_step}"
            )
        if path.exists():
            try:
                seen = int(path.read_text().split()[0])
            except (ValueError, IndexError):
                seen = -1
            if seen >= at_step:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                return seen
        time.sleep(poll_s)
    raise TimeoutError(f"child never reached step {at_step} in {timeout_s}s")


# ---------------------------------------------------------------------------
# checkpoint corruption
# ---------------------------------------------------------------------------


def _step_dir(ckpt_dir, step: int) -> Path:
    root = Path(ckpt_dir) / f"step_{step:09d}"
    if not root.is_dir():
        raise FileNotFoundError(f"no checkpoint dir {root}")
    return root


def _pick_leaf(root: Path, leaf: Optional[str], rng: np.random.Generator) -> Path:
    if leaf is not None:
        path = root / leaf
        if not path.is_file():
            raise FileNotFoundError(f"no leaf {path}")
        return path
    leaves = sorted(
        p for p in root.rglob("*.npy") if p.is_file()
    ) or sorted(p for p in root.rglob("*") if p.is_file() and p.name != "manifest.json")
    if not leaves:
        raise FileNotFoundError(f"no leaf files under {root}")
    return leaves[int(rng.integers(0, len(leaves)))]


def truncate_leaf(
    ckpt_dir, step: int, leaf: Optional[str] = None, keep_frac: float = 0.5,
    seed: int = 0,
) -> str:
    """Cut a leaf file short — a torn write. Returns the relpath hit."""
    root = _step_dir(ckpt_dir, step)
    path = _pick_leaf(root, leaf, np.random.default_rng(seed))
    size = path.stat().st_size
    with open(path, "r+b") as f:
        f.truncate(max(1, int(size * keep_frac)))
    return str(path.relative_to(root))


def flip_bytes(
    ckpt_dir, step: int, leaf: Optional[str] = None, n_bytes: int = 8,
    seed: int = 0,
) -> str:
    """XOR random bytes inside a leaf's data region — silent bit rot.
    Offsets land past the ~128-byte npy header so the file still *loads*;
    only the checksum can catch it. Returns the relpath hit."""
    rng = np.random.default_rng(seed)
    root = _step_dir(ckpt_dir, step)
    path = _pick_leaf(root, leaf, rng)
    size = path.stat().st_size
    lo = min(128, max(0, size - 1))
    with open(path, "r+b") as f:
        for off in rng.integers(lo, size, n_bytes):
            f.seek(int(off))
            b = f.read(1)
            f.seek(int(off))
            f.write(bytes([b[0] ^ 0xFF]))
    return str(path.relative_to(root))


def delete_manifest(ckpt_dir, step: int) -> str:
    """Remove manifest.json — the publish record is gone."""
    root = _step_dir(ckpt_dir, step)
    (root / "manifest.json").unlink()
    return "manifest.json"


def orphan_tmp(ckpt_dir, step: int) -> str:
    """Leave a half-written tmp dir behind, as a writer killed mid-save
    does. Returns the tmp dir name (manager init must sweep it)."""
    tmp = Path(ckpt_dir) / f".tmp_step_{step:09d}"
    (tmp / "arrays").mkdir(parents=True, exist_ok=True)
    (tmp / "arrays" / "partial.npy").write_bytes(b"\x93NUMPY... torn")
    return tmp.name


CORRUPTION_MODES = {
    "truncate_leaf": truncate_leaf,
    "flip_bytes": flip_bytes,
    "delete_manifest": delete_manifest,
    "orphan_tmp": orphan_tmp,
}


def corrupt(mode: str, ckpt_dir, step: int, **kw) -> str:
    """Apply one named corruption mode; returns what was damaged."""
    return CORRUPTION_MODES[mode](ckpt_dir, step, **kw)


# ---------------------------------------------------------------------------
# transient step failures
# ---------------------------------------------------------------------------


class TransientFault(RuntimeError):
    """The injected transient failure (preemption blip / ICI flap)."""


class TransientFaultInjector:
    """Raise :class:`TransientFault` at chosen global steps.

    ``persistent`` controls how many consecutive attempts at the same step
    fail before it succeeds (1 = fails once, recovered by the first retry).
    ``raised`` counts injections so tests can assert the path was exercised.
    """

    def __init__(self, fail_steps: Sequence[int], persistent: int = 1):
        self.fail_steps: Set[int] = set(int(s) for s in fail_steps)
        self.persistent = persistent
        self.attempts: Dict[int, int] = {}
        self.raised = 0

    def __call__(self, step: int) -> None:
        if step not in self.fail_steps:
            return
        seen = self.attempts.get(step, 0)
        self.attempts[step] = seen + 1
        if seen < self.persistent:
            self.raised += 1
            raise TransientFault(f"injected transient failure at step {step}")


# ---------------------------------------------------------------------------
# stragglers / missed heartbeats
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StragglerInjector:
    """Declarative straggler schedule.

    ``suppress`` maps worker id -> rounds/epochs whose heartbeat is
    suppressed (None = all rounds from the first listed onward is expressed
    by an explicit range upstream); ``delay_s`` is a wall-clock delay for
    paths that really sleep (the async PS worker 0 injection).
    """

    suppress: Dict[str, Set[int]] = dataclasses.field(default_factory=dict)
    delay_s: float = 0.0

    def beats(self, worker_id: str, round_index: int) -> bool:
        """Does this worker's heartbeat arrive this round?"""
        return round_index not in self.suppress.get(worker_id, ())


# ---------------------------------------------------------------------------
# serving-side engine faults
# ---------------------------------------------------------------------------


class EngineChaos:
    """A ``SparseInferenceEngine.fault_hook`` built from the two injectors.

    The engine calls ``hook(op, call_index)`` at the top of every served
    entry point (prefill/decode/classify), before any cache mutation.
    ``transient`` is a :class:`TransientFaultInjector` keyed on the call
    index (its ``persistent`` knob decides whether one gateway retry
    recovers the call or the failure sticks long enough to trip the
    breaker); ``straggler`` reuses :class:`StragglerInjector` with the op
    name as the worker id — a suppressed "beat" stalls the call by
    ``delay_s`` (a slow device, not a dead one). Both schedules live in
    call-index space, so a chaos scenario is deterministic regardless of
    wall-clock jitter.
    """

    def __init__(
        self,
        transient: Optional[TransientFaultInjector] = None,
        straggler: Optional[StragglerInjector] = None,
        sleep=time.sleep,
    ):
        self.transient = transient
        self.straggler = straggler
        self.sleep = sleep
        self.calls = 0

    def __call__(self, op: str, call_index: int) -> None:
        self.calls += 1
        if self.straggler is not None and not self.straggler.beats(
            op, call_index
        ):
            self.sleep(self.straggler.delay_s)
        if self.transient is not None:
            self.transient(call_index)

    @property
    def raised(self) -> int:
        return self.transient.raised if self.transient is not None else 0


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FaultPlan:
    """One seeded, serializable bundle of scheduled faults.

    Fields are all optional — an empty plan injects nothing, so the same
    harness drives both the fault run and its clean control.
    """

    seed: int = 0
    kill_at_step: Optional[int] = None
    transient_steps: Tuple[int, ...] = ()
    transient_persistent: int = 1
    corruptions: Tuple[Tuple[str, int], ...] = ()  # (mode, ckpt step)
    straggler_suppress: Dict[str, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict
    )
    straggler_delay_s: float = 0.0

    @classmethod
    def from_seed(
        cls,
        seed: int,
        *,
        total_steps: int,
        ckpt_steps: Sequence[int] = (),
        n_kills: int = 1,
        n_transients: int = 1,
        corruption_modes: Sequence[str] = (),
    ) -> "FaultPlan":
        """Derive a replayable plan: kill point, transient steps and
        corruption targets all drawn from ``seed``."""
        rng = np.random.default_rng(seed)
        kill = (
            int(rng.integers(1, max(2, total_steps)))
            if n_kills else None
        )
        transients = tuple(
            sorted(
                int(s)
                for s in rng.choice(
                    max(1, total_steps), size=min(n_transients, total_steps),
                    replace=False,
                )
            )
        )
        corr = []
        ckpt_steps = list(ckpt_steps)
        for mode in corruption_modes:
            if mode not in CORRUPTION_MODES:
                raise ValueError(f"unknown corruption mode {mode!r}")
            target = (
                int(ckpt_steps[int(rng.integers(0, len(ckpt_steps)))])
                if ckpt_steps else 0
            )
            corr.append((mode, target))
        return cls(
            seed=seed,
            kill_at_step=kill,
            transient_steps=transients,
            corruptions=tuple(corr),
        )

    # -- runtime views -------------------------------------------------------

    def kill_switch(self) -> KillSwitch:
        return KillSwitch(self.kill_at_step)

    def transient_injector(self) -> TransientFaultInjector:
        return TransientFaultInjector(
            self.transient_steps, persistent=self.transient_persistent
        )

    def straggler_injector(self) -> StragglerInjector:
        return StragglerInjector(
            suppress={w: set(r) for w, r in self.straggler_suppress.items()},
            delay_s=self.straggler_delay_s,
        )

    def apply_corruptions(self, ckpt_dir) -> List[str]:
        """Damage the checkpoint dir per plan; returns what was hit."""
        return [
            f"{mode}:{corrupt(mode, ckpt_dir, step, **({'seed': self.seed} if mode in ('truncate_leaf', 'flip_bytes') else {}))}"
            for mode, step in self.corruptions
        ]

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["straggler_suppress"] = {
            w: list(r) for w, r in self.straggler_suppress.items()
        }
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        d["transient_steps"] = tuple(d.get("transient_steps", ()))
        d["corruptions"] = tuple(
            (m, int(st)) for m, st in d.get("corruptions", ())
        )
        d["straggler_suppress"] = {
            w: tuple(r) for w, r in d.get("straggler_suppress", {}).items()
        }
        return cls(**d)
