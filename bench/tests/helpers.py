"""Shared pieces of the benchmark's CPU tests."""
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells():
    """The cells of BENCHMARK.json."""
    return [w["name"] for w in benchmark()["workloads"]]


def toy_run(name, seed=2**31 + 11, seconds=0.3, root=ROOT):
    import torch

    from bench.harness import run_cell

    return run_cell(name, seed, seconds, False, device=torch.device("cpu"), toy=True, root=root)
