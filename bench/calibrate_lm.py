"""Readings that an LM cell's limits are set from: for each seed, every
number of the program against the plain reference (the lower reading), and
with ``--controls`` the same numbers of the reference in each control's
precision put in the program's place (``faults_lm.CONTROLS``: fp8 products,
a bf16 scan), and with ``--faults`` of the program with each fault of
``faults_lm.FAULTS`` planted (both upper readings: each must fail a
limit). One process builds every run in turn; no window is run.

    python3 bench/calibrate_lm.py --workload <cell> --seeds 1,2,3 [--controls]
        [--faults | --fault NAME,...]

Prints one JSON line a run: ``{"seed", "kind", "name", "readings", "failed",
"worst_leaves", "rounding", "setup_s", "check_s", "peak_bytes", "losses"}``,
``failed`` naming the limits the readings pass over, ``worst_leaves`` the
four worst leaves of each leaf-wise reading by its own denominator, and
``rounding`` for the four worst ``update_diff`` leaves (elements whose
stored update differs from the reference's, elements the reference's
update changed, elements whose f32 update is under half a step of the
leaf's dtype, elements).
"""
import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from bench.faults_lm import CONTROLS, FAULTS  # noqa: E402
from bench.harness import Cell, Context, SubWindow  # noqa: E402


def one(cell, seed, device, toy, kind, name):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    undo = FAULTS[name]() if kind == "fault" else None
    try:
        t0 = time.perf_counter()
        prog = cell.runner().build(Context(cell, seed, device, toy=toy))
        prog.measure(0.0, SubWindow(False))
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        readings = prog.control_readings(name) if kind == "control" else prog.readings()
    finally:
        if undo is not None:
            undo()
    failed = [k for k, lim in cell.limits.items()
              if not (math.isfinite(readings[k]) and readings[k] <= lim)]
    worst = {}
    parts = dict(getattr(prog, "leaf_numbers", {}), momentum=getattr(prog, "momentum_nums", {}))
    for part, nums in parts.items():
        if nums:
            med = statistics.median(n for _, n in nums.values())
            worst[part] = sorted((d / max(n, med), k) for k, (d, n) in nums.items())[-4:]
    rounding = {k: getattr(prog, "rounding", {}).get(k) for _, k in worst.get("update", [])}
    out = {"seed": seed, "kind": kind, "name": name, "readings": readings, "failed": failed,
           "worst_leaves": worst, "rounding": rounding,
           "setup_s": t1 - t0, "check_s": time.perf_counter() - t1, "peak_bytes": peak,
           "losses": prog.losses}
    del prog
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--fault", default="", help="only these faults, by name")
    ap.add_argument("--program", type=int, default=1, help="0: no program readings")
    ap.add_argument("--cpu-toy", action="store_true", help="a toy size on the CPU")
    args = ap.parse_args()
    import torch

    device = torch.device("cpu") if args.cpu_toy else torch.device("cuda", 0)
    cell = Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [("program", "program", s) for s in seeds] if args.program else []
    if args.controls:
        runs += [("control", c, seeds[i % len(seeds)]) for i, c in enumerate(CONTROLS)]
    names = sorted(FAULTS) if args.faults else [f for f in args.fault.split(",") if f]
    runs += [("fault", f, seeds[i % len(seeds)]) for i, f in enumerate(names)]
    for kind, name, seed in runs:
        print(json.dumps(one(cell, seed, device, args.cpu_toy, kind, name)), flush=True)


if __name__ == "__main__":
    main()
