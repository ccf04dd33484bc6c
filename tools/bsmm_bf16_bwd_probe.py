#!/usr/bin/env python3
"""Kernels D and E's bf16 instances (the LM's training backward) on one card:
their builds' registers (``-Xptxas -v``), then each held within 1e-2 +
1e-2 x |plain| of its plain version, bit-equal over three launches, with
dx's uncovered block-rows exactly 0, on Qwen1.5-0.5B's first-layer W_in
(1024 -> 2816, 22 tiles) and W_out (2816 -> 1024, 15 tiles) at 1, 8, 100,
256 and 2,048 rows, on W_in's grid with every block-column holding 4, 5 or
8 slots (block-rows of up to 22 slots) at 2,048 rows, and on tiles of
16 x 16 to 128 x 64 at 77 rows; E's batch runs (``dw_splits_bf16``) are
printed beside each case. At 2,048 rows both are timed with CUDA events
over 50 calls enqueued back to back, beside their plain versions: these
times include the host's launch path, unlike ``chip_smoke.py``'s
``device_ms``. Last, an 8 x 8 tile must be refused.

    PYTHONPATH=src python3 tools/bsmm_bf16_bwd_probe.py      # on the card

Exits 1 when a check fails.
"""
import sys

import numpy as np
import torch

from repro_torch.core import sparsity as tsp
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import build


def case(meta, topo, rows, rng, dev):
    v = topo.init_values(rng, dtype=torch.bfloat16, device=dev)
    x = torch.as_tensor(rng.standard_normal((rows, meta.padded_in)).astype(np.float32),
                        device=dev).bfloat16()
    dy = torch.as_tensor(rng.standard_normal((rows, meta.padded_out)).astype(np.float32),
                         device=dev).bfloat16()
    return topo.device_arrays(dev), v, x, dy


def enqueued_us(fn, reps=50):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def within(got, want):
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("bsmm_bf16_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    for source, log in build.build(("bsmm_dx", "bsmm_dw")).items():
        print(f"== {source}\n" + "\n".join(line for line in log.splitlines() if "Used" in line))
    rng = np.random.default_rng(0)
    t_in = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(1024, 2816), 64.0, rng)
    t_out = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2816, 1024), 64.0, rng)
    cases = [(f"{name} {rows}", t.meta, t, rows) for name, t in (("win", t_in), ("wout", t_out))
             for rows in (1, 8, 100, 256, 2048)]
    meta = tsp.BlockMeta(1024, 2816, 128, 128)
    for length in (4, 5, 8):
        block_rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                                     for _ in range(meta.grid_n)])
        cases.append((f"columns of {length} 2048", meta, tsp.BlockTopology(
            meta, block_rows, np.repeat(np.arange(meta.grid_n), length)), 2048))
    for bm, bn in ((16, 16), (32, 48), (96, 16), (128, 64)):
        m = tsp.BlockMeta(bm * 5, bn * 3, bm, bn)
        cases.append((f"tiles {bm}x{bn} 77", m, tsp.BlockTopology.erdos_renyi(m, 0.5, rng), 77))
    fails = 0
    for what, meta, topo, rows in cases:
        t, v, x, dy = case(meta, topo, rows, rng, dev)

        def d():
            return bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                               grid_m=meta.grid_m)

        def e():
            return bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n)

        dxs, dws = [d() for _ in range(3)], [e() for _ in range(3)]
        torch.cuda.synchronize()
        err_d, ok_d = within(dxs[0], bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row,
                                                       t.perm_r, grid_m=meta.grid_m))
        err_e, ok_e = within(dws[0], bsm.bsmm_dw_plain(x, dy, t.rows, t.cols,
                                                       block_m=meta.block_m,
                                                       block_n=meta.block_n))
        same = all(torch.equal(a[0].view(torch.int16), b.view(torch.int16))
                   for a in (dxs, dws) for b in a[1:])
        covered = np.zeros(meta.grid_m, bool)
        covered[topo.rows] = True
        zero = bool((dxs[0][:, torch.as_tensor(np.repeat(~covered, meta.block_m),
                                                device=dev)] == 0).all())
        fails += not (ok_d and ok_e and same and zero)
        print(f"{what}: D err {err_d:.4g} ok {ok_d}, E err {err_e:.4g} ok {ok_e}, same bits "
              f"{same}, uncovered zero {zero}, E runs "
              f"{bsm.dw_splits_bf16(topo.n_blocks, rows, meta.block_m, meta.block_n)}", flush=True)
        if rows == 2048 and what.startswith("w"):
            print(f"  us, enqueued: D {enqueued_us(d):.2f}, E {enqueued_us(e):.2f}, plain D "
                  f"{enqueued_us(lambda: bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m), 10):.2f}, "  # noqa: E501
                  f"plain E {enqueued_us(lambda: bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n), 10):.2f}")  # noqa: E501
    m = tsp.BlockMeta(16, 16, 8, 8)
    t, v, x, dy = case(m, tsp.BlockTopology.erdos_renyi(m, 1.0, rng), 4, rng, dev)
    try:
        bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=8, block_n=8)
        print("an 8 x 8 tile was not refused")
        fails += 1
    except ValueError as err:
        print(f"refused: {err}")
    print(f"{fails} case(s) failed")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
