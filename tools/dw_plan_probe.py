#!/usr/bin/env python3
"""Why kernel F's run plan is ordered as it is: kernel F timed on the card
under three orders of the same runs.

    first_row       the plan ``core.sparsity.dw_runs`` makes: the slot runs
                    ordered by their first slot's row, then each column's
                    empty run (its epilogue: dz and dbias), in column order;
    column          the slot runs in column order, then the empty runs;
    epilogue_first  the empty runs first, then the slot runs by first row.

The runs are the same, so every order gives the same bits (checked with
``torch.equal``); only the time moves. Each is timed with CUDA events over
200 back-to-back launches at the full-width CIFAR-10 element model's four
layers (3072-4000-1000-4000-10, epsilon 20, seed 0), batch 128, with the
layer's epilogue in the training step (All-ReLU's backward with kernel A's
mask on the hidden layers, the bias alone on the output layer) and, for the
first two orders, without one (the slot runs alone).

    PYTHONPATH=src python3 tools/dw_plan_probe.py      # on the card
"""
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs.set_mlp import mlp_config
from repro_torch.core import sparsity
from repro_torch.data.datasets import load
from repro_torch.kernels.ref import slope_for
from repro_torch.models.mlp import SparseMLP

sys.path.insert(0, "tools")
from dw_bits_probe import device_us  # noqa: E402


def orders(plan: sparsity.DwRuns) -> dict:
    """The registered plan and its two reorderings."""
    slot, empty = plan.runs[:plan.n_slot_runs], plan.runs[plan.n_slot_runs:]
    by_col = slot[torch.argsort(slot[:, 0].long() * (1 << 32) + slot[:, 1].long())]
    return {
        "first_row": plan,
        "column": plan._replace(runs=torch.cat([by_col, empty]).contiguous()),
        "epilogue_first": plan._replace(runs=torch.cat([empty, slot]).contiguous(),
                                        n_slot_runs=None),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    cfg = mlp_config("cifar10")
    model = SparseMLP(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    hT = torch.as_tensor(np.ascontiguousarray(load("cifar10", scale=0.02).x_train[:128].T),
                         device=dev)
    rows, same = [], True
    for l, (host, v, b) in enumerate(zip(model.topos, model.values, model.biases)):
        t = host.device_arrays(dev)
        dy = torch.as_tensor((0.01 * rng.standard_normal((host.out_dim, 128))).astype(np.float32),
                             device=dev)
        slope = slope_for(cfg.alpha, l + 1) if l < cfg.n_layers - 1 else None
        mask = None
        if slope is not None:
            _, mask = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim, bias=b,
                                            slope=slope, with_mask=True)
        row, outs = dict(layer=l, nnz=host.nnz), {}
        for name, plan in orders(sparsity.dw_plan(t.rows, t.cols, host.out_dim)).items():
            def call(epilogue=True):
                return sparsity._coo_dw_cuda(dy, mask if epilogue else None, slope, epilogue,
                                             xT=hT, rows=t.rows, runs=plan)[:3]

            outs[name] = call()
            torch.cuda.synchronize()
            row[f"{name}_us"] = device_us(call)
            if plan.n_slot_runs is not None:
                row[f"{name}_no_epilogue_us"] = device_us(lambda: call(False))
        same &= all(all(torch.equal(p, q) for p, q in zip(o, outs["first_row"]))
                    for o in outs.values())
        rows.append(row)
        print(json.dumps(row), flush=True)
        hT = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim, bias=b, slope=slope)
    totals = {k: sum(r[k] for r in rows) for k in rows[0] if k.endswith("_us")}
    print(json.dumps({"dw_plan_us_per_step": totals, "bit_equal_across_orders": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
