#!/usr/bin/env python3
"""Whether a live one-rank ``nccl`` process group moves the serving
gateway's goodput ratio under chaos, on the card.

``chip_smoke.py``'s ``gateway`` phase holds the chaos run's goodput to
0.8 of the clean run's, and since ``launch_train`` runs on a mesh the
one-rank group it starts is alive while the gateway serves. This runs the
script's ``device``, ``build`` and ``lm`` phases, scales the reference's
times to the card's decode step and takes the rate at 2x saturation as
the phase does, then runs the phase's clean and chaos pair six times,
alternating no group and a one-rank ``nccl`` group (started with
``launch.mesh.ensure_process_group``, torn down before each run without
one). Prints one line a pair (the condition, the ratio, the clean and
chaos goodput in tokens a second) and a JSON list of them.

    python3 tools/gateway_group_probe.py
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch.mesh import ensure_process_group  # noqa: E402


def main() -> int:
    out = {"kernels": []}
    for name in ("device", "build", "lm"):
        t0 = time.perf_counter()
        line = getattr(cs, f"phase_{name}")(out)
        print(f"[{name}] {line[:200]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    engine = out["lm_engine"]
    slots = engine.cfg.max_slots
    tokens, pos = np.zeros(slots, np.int32), np.full(slots, 100)
    for _ in range(3):
        engine.decode_step(tokens, pos)
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.decode_step(tokens, pos)
        ts.append((time.perf_counter() - t0) * 1e3)
    engine.reset_slots()
    scale = float(np.median(ts)) / cs.GW_REF_DECODE_MS
    times = {k: v * scale for k, v in cs.GW_REF_TIMES.items()}
    sat = cs.ContinuousBatcher(engine, queue_capacity=64).run(cs.poisson_trace(
        16, rate=1e6, vocab=engine.model.cfg.vocab, seed=5, **cs.GW_TRACE))
    engine.reset_slots()
    rate = 2.0 * sat.throughput_tok_s / 5.0
    print("decode_ms", float(np.median(ts)), "rate", rate, flush=True)
    res = []
    for cond in ["none", "nccl"] * 3:
        if cond == "nccl" and not dist.is_initialized():
            ensure_process_group(cs.CARD)
        if cond == "none" and dist.is_initialized():
            dist.destroy_process_group()
        clean = cs.gateway_run(engine, rate, times)
        chaos = cs.gateway_run(engine, rate, times, cs.GW_FAULTS)
        good = (clean["stats"].serve.goodput_tok_s, chaos["stats"].serve.goodput_tok_s)
        res.append((cond, good[1] / good[0], *good))
        print(*res[-1], flush=True)
    print(json.dumps(res))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
