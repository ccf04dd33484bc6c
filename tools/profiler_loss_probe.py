#!/usr/bin/env python3
"""Which device events ``torch.profiler`` loses late in a long process, and
which way of taking a capture keeps them, on the card.

It runs ``chip_smoke.py``'s phases from ``device`` through ``gateway`` (as
the script runs them, ~10 min), then captures one call of each of four
registered audit programs (``xl.shard_acc``, ``xl.shard_dw``,
``wasap.phase1_epoch``, ``serve.classify``, their plain builds) three
times under each strategy, and holds every capture's hand-kernel events
against the wrappers' launch counters over the same call
(``hlo_parser.hand_kernel_match``):

    plain          the call alone
    sleep          1 s of host sleep after the call, inside the capture
    trail_filler   2,000 one-element ``add_`` kernels after the call
    lead_filler    the same 2,000 before the call
    cuda_only      device activity only
    warm_session   an empty capture just before
    gc             ``gc.collect`` and ``empty_cache`` before
    reps5          the call five times in one capture

Then it runs ``python -m repro_torch.analysis`` on the four programs in a
fresh process, twice. Prints a ``census_trial`` line (whole captures of 3
by strategy and program), a ``census_trial_detail`` line (each capture's
events beside launches, device events, filler events kept, the first and
last hand-kernel positions) and the child's result.

    python3 tools/profiler_loss_probe.py
"""
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.analysis import hlo_audit, hlo_parser, registry  # noqa: E402

PROGRAMS = ("xl.shard_acc", "xl.shard_dw", "wasap.phase1_epoch", "serve.classify")
STRATEGIES = ("plain", "sleep", "trail_filler", "lead_filler", "cuda_only", "warm_session",
              "gc", "reps5")
FILLER = 2000
REPS = 3
PHASES = ("device", "build", "kernels", "block_kernels", "element_kernels", "main", "train",
          "element_train", "evolution", "element_train_device_evolution",
          "block_train_device_evolution", "timings", "train_timings", "baselines", "lm",
          "lm_compact", "lm_train", "lm_archs", "whisper", "obs", "supervisor",
          "launch_train", "gateway")


def build(name: str):
    prog = registry.get(name).build(cs.CARD)
    fn = prog.make(())
    fn(*prog.args, **prog.kwargs)
    torch.cuda.synchronize()
    return fn, prog.args, prog.kwargs


def capture(program, strategy: str, small: torch.Tensor) -> dict:
    fn, args, kwargs = program
    acts = [ProfilerActivity.CUDA] if strategy == "cuda_only" else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    if strategy == "warm_session":
        with profile(activities=acts):
            small.add_(1)
            torch.cuda.synchronize()
    if strategy == "gc":
        gc.collect()
        torch.cuda.empty_cache()
    before = hlo_audit.launch_counts()
    with profile(activities=acts) as prof:
        for _ in range(4 if strategy == "reps5" else 0):
            fn(*args, **kwargs)
        for _ in range(FILLER if strategy == "lead_filler" else 0):
            small.add_(1)
        fn(*args, **kwargs)
        for _ in range(FILLER if strategy == "trail_filler" else 0):
            small.add_(1)
        torch.cuda.synchronize()
        if strategy == "sleep":
            time.sleep(1.0)
    launched = {k: v - before[k] for k, v in hlo_audit.launch_counts().items()
                if v != before[k]}
    match = hlo_parser.hand_kernel_match(hlo_parser.kernel_census(prof.events()), launched)
    dev = sorted((e for e in prof.events() if hlo_parser._is_device_event(e)),
                 key=lambda e: e.time_range.start)
    hand = [i for i, e in enumerate(dev)
            if any(p.search(e.name) for p in hlo_parser.HAND_KERNEL_RE.values())]
    return dict(match={k: list(v) for k, v in match.items()}, events=len(dev),
                filler=sum("add" in e.name.lower() or "elementwise" in e.name.lower()
                           for e in dev),
                hand_positions=hand[:3] + hand[-3:])


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_loss_probe: runs on the card", file=sys.stderr)
        return 1
    out = {"kernels": []}
    for name in PHASES:
        t0 = time.perf_counter()
        getattr(cs, "phase_" + name)(out)
        print(f"[{name}] done ({time.perf_counter() - t0:.1f} s)", flush=True)
    programs = {name: build(name) for name in PROGRAMS}
    small = torch.zeros(1, device=cs.CARD)
    res = {f"{s}/{p}": [capture(programs[p], s, small) for _ in range(REPS)]
           for s in STRATEGIES for p in PROGRAMS}
    whole = {k: sum(all(a == b for a, b in r["match"].values()) for r in v)
             for k, v in res.items()}
    print(json.dumps({"census_trial": "after gateway", f"whole_of_{REPS}": whole}), flush=True)
    print(json.dumps({"census_trial_detail": res}), flush=True)
    for _ in range(2):  # a fresh process, as late
        r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", *PROGRAMS,
                            "--no-lint", "--root", str(ROOT)],
                           env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                           capture_output=True, text=True)
        print("child rc", r.returncode, r.stdout[-1500:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
