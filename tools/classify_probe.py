#!/usr/bin/env python3
"""Serving latency with nothing run before it in the process.

``chip_smoke.py`` times ``SparseInferenceEngine.classify`` after its kernel,
training and element phases. This builds the same engine (``chip_smoke``'s
seeded full-width SET-MLP, compacted by its ``SCHEDULE``) in a fresh process
and times classify at batch 1, 8, 32 and 128 at once: the median and
quartiles of 30 host-clock calls after 5 warm-ups, as ``chip_smoke.py``
does. It imports ``chip_smoke`` and the port from the directory it is run
in, so one copy of it times any checkout:

    cd <checkout> && python3 <repo>/tools/classify_probe.py      # on the card
"""
import json
import os
import subprocess
import sys
import time

sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.data.datasets import load  # noqa: E402
from repro_torch.serve import SparseInferenceEngine  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    engine = SparseInferenceEngine(chip_smoke.seeded_model("cuda"), compaction=chip_smoke.SCHEDULE)
    x_test = load("cifar10", scale=0.01).x_test
    latency = {}
    for bucket in engine.cfg.batch_buckets:
        x = chip_smoke.requests(x_test, bucket)
        for _ in range(5):
            engine.classify(x)
        ts = []
        for _ in range(30):
            t0 = time.perf_counter()
            engine.classify(x)
            ts.append((time.perf_counter() - t0) * 1e3)
        q25, q50, q75 = np.percentile(ts, [25, 50, 75])
        latency[bucket] = dict(median=float(q50), q25=float(q25), q75=float(q75))
    print(json.dumps({"classify_ms": latency}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
