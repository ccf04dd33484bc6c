"""Readings that the comparison's limits are set from, for one cell: for
each seed, every number of the program against the plain reference (the
lower reading: its first steps, the evaluation that ends its window, its
feed) and the control's, the reference computed in the
precision below the configuration's put in the program's place (the upper
reading). One process builds every seed's cell in turn; the window is
one epoch unless ``--seconds`` asks for more.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control tf32]

Prints one JSON line a seed: ``{"seed", "program": {...}, "control": {...}}``.
With ``--fault <name>`` (``bench/faults.py``) the program runs with that
fault planted, and its readings are the fault's.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from bench import compare  # noqa: E402
from bench.harness import Cell, Context, SubWindow  # noqa: E402


def eval_look(prog):
    """The scale of the last evaluation's logits beside their gap from the
    reference's: norms, the mean of |logit|, the mean of |l1 - l0| (the
    margin), the share of rows whose margin is under 1e-3 of the mean
    |logit|, and the largest gap a row reads over its own logits' norm."""
    import torch

    ref = prog.reference_eval().double()
    got = prog.eval_logits.double()
    row = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    margin = (ref[:, 1] - ref[:, 0]).abs()
    return {"ref_norm": float(ref.norm()), "diff_norm": float((got - ref).norm()),
            "mean_abs_logit": float(ref.abs().mean()), "mean_margin": float(margin.mean()),
            "thin_margin_share": float((margin < 1e-3 * ref.abs().mean()).double().mean()),
            "worst_row_gap": float(row.max()), "acc": prog.eval_acc,
            "ref_acc": float((ref.argmax(1) == torch.as_tensor(prog.y_test).long())
                             .double().mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default=None, help="the control's precision")
    ap.add_argument("--leaves", action="store_true", help="print every leaf's numbers")
    ap.add_argument("--fault", default=None, help="a fault of bench/faults.py, planted")
    ap.add_argument("--cpu-toy", action="store_true", help="a toy size on the CPU")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="the window's length (default: one epoch)")
    ap.add_argument("--eval-look", action="store_true",
                    help="print the evaluation's logits' scale beside their gap")
    args = ap.parse_args()
    import torch

    device = torch.device("cpu") if args.cpu_toy else torch.device("cuda", 0)
    cell = Cell(args.workload)
    if args.fault:
        from bench.faults import FAULTS

        FAULTS[args.fault]()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = cell.runner().build(Context(cell, seed, device, toy=args.cpu_toy))
        prog.measure(args.seconds, SubWindow(False))  # the first steps, and the window
        t1 = time.perf_counter()
        out = {"seed": seed, "setup_s": t1 - t0, "program": prog.readings()}
        out["check_s"] = time.perf_counter() - t1
        if args.eval_look:
            out["eval_look"] = eval_look(prog)
        if args.leaves:
            out["leaves"] = compare.leaf_report(prog.prog, prog.reference_snapshot())
        if args.control:
            out["control"] = prog.control_readings(args.control)
        print(json.dumps(out), flush=True)
        del prog
        if device.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
