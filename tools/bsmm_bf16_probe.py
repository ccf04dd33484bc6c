#!/usr/bin/env python3
"""Kernel C's bf16 routes on the LM's served shapes, each route and block
tile the C entry takes, on one card in one process:

    tiled       the route every bf16 call took before the decode and rows
                routes (the f32 instance's design, ``fwd_parts``' split and
                its second pass);
    decode/16   the decode route (operands swapped), 16 features a block;
    rows/R/F    the rows route, R batch rows and F features a block (32 x 32
                and 64 x 64, ``ROWS_TILES``).

At Qwen1.5-0.5B's sparse FFN at full width (seed 0's first layer: W_in
1024 -> 2816 over 22 of 8 x 22 tiles, W_out 2816 -> 1024 over 15 of
22 x 8), at 1, 8 and 16 rows and at a 4-prompt prefill's 64, 128 and 256,
each variant is held within 1e-2 of the plain version, bit-equal over three
launches, and with All-ReLU in its store bit-equal to itself followed by
kernel B's bf16 entry; a decode-route row is held bit-equal alone and
within the call. Then each variant is timed with CUDA events over 200
back-to-back launches, in turns (tiled, the new variants, the new variants
again, tiled), beside ``torch.matmul`` on the densified W. The plan's
choice (``fwd_plan``) is marked. Last, the planned route at 8, 16, 64 and
256 rows on synthetic grids whose columns all hold 1, 2, 4, 5 or 8 slots,
each held within 1e-2 + 1e-2 x |plain| of the plain version and bit-equal
over three launches, and timed: what a column's length costs.

    PYTHONPATH=src python3 tools/bsmm_bf16_probe.py      # on the card

prints every row as one line of JSON.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core import sparsity
from repro_torch.kernels import all_relu_fused, build, ref
from repro_torch.kernels import block_sparse_matmul as bsm

sys.path.insert(0, "tools")
from dw_bits_probe import device_us  # noqa: E402

ROWS = (1, 8, 16, 64, 128, 256)
ALPHA = 0.6  # the LM's All-ReLU alpha
TOL = 1e-2


def variants(batch: int) -> list:
    """(name, route, tile_rows, tile_feat) the C entry takes at this batch."""
    out = [("tiled", "tiled", 0, 0)]
    if batch <= bsm.DECODE_ROWS:
        out.append(("decode/16", "decode", 0, 16))
    return out + [(f"rows/{r}/{f}", "rows", r, f) for r, f, _ in bsm.ROWS_TILES]


def launcher(x, v, t, meta, route, tile_rows, tile_feat, layer_index=None):
    """A closure that launches the bf16 entry on one variant into a fresh y."""
    fn = build.kernel("bsmm_fwd", "bsmm_fwd_bf16", bsm._FWD_ARGTYPES[torch.bfloat16])
    nb, bm, bn = v.shape
    batch = x.shape[0]
    col_ptr = bsm._offsets_once(t.cols, meta.grid_n)
    parts = bsm.fwd_parts(nb, meta.grid_n, batch, bn) if route == "tiled" else 1
    part = (torch.empty((parts, batch, meta.grid_n * bn), dtype=torch.float32, device=x.device)
            if parts > 1 else None)
    slope = 0.0 if layer_index is None else ref.scalar_in(ref.slope_for(ALPHA, layer_index),
                                                           torch.bfloat16)

    def run():
        y = torch.empty((batch, meta.grid_n * bn), dtype=torch.bfloat16, device=x.device)
        rc = fn(x.data_ptr(), v.data_ptr(), t.rows.data_ptr(), col_ptr.data_ptr(), y.data_ptr(),
                None if part is None else part.data_ptr(), batch, meta.grid_m, meta.grid_n, bm,
                bn, parts, bsm._FWD_ROUTES[route], tile_rows, tile_feat,
                int(layer_index is not None), slope, *build.stream_args(x.device))
        build.check_launch(rc, f"bsmm_fwd_bf16 {route}")
        return y

    return run


def column_sweep(dev, card: str) -> dict:
    """What a column's length costs on the planned route: grids of 8 and 22
    block-columns of 128 x 128 tiles, every column holding L slots (L = 1,
    2, 4, 5, 8; the rows 0..L-1; 5 and 8 outlast the rings), at 8, 16, 64
    and 256 rows, each checked and timed as above."""
    rng = np.random.default_rng(1)
    out = dict(card=card, us={})
    for grid_n in (8, 22):
        for length in (1, 2, 4, 5, 8):
            meta = sparsity.BlockMeta(128 * 8, 128 * grid_n, 128, 128)
            rows = np.tile(np.arange(length), grid_n)
            cols = np.repeat(np.arange(grid_n), length)
            host = sparsity.BlockTopology(meta, rows, cols)
            t = host.device_arrays(dev)
            v = host.init_values(rng, dtype=torch.bfloat16, device=dev)
            for batch in (8, 16, 64, 256):
                x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(
                    np.float32), device=dev).to(torch.bfloat16)
                plan = bsm.fwd_plan(host.n_blocks, grid_n, batch, 128, 128, bf16=True)
                run = launcher(x, v, t, meta, plan.route, plan.tile_rows, plan.tile_feat)
                what = f"{grid_n} columns x {length}, {batch} rows, {plan.route}"
                ys = [run() for _ in range(3)]
                torch.cuda.synchronize()
                check(f"{what}: 3 launches bit-equal", all(torch.equal(ys[0], y) for y in ys[1:]))
                # longer columns reach larger sums, where one bf16 ulp of a
                # sum rounded from another f32 order exceeds TOL: held as
                # chip_smoke.py holds C, within TOL + TOL x |want|
                want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                          grid_n=grid_n).float()
                diff = (ys[0].float() - want).abs()
                check(f"{what}: max |diff| {float(diff.max())} beyond {TOL} + {TOL} x |want|",
                      bool((diff <= TOL + TOL * want.abs()).all()))
                out["us"][what] = device_us(run)
    return out


def check(what: str, cond: bool) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    topos = {}
    for name, (n_in, n_out) in (("win", (1024, 2816)), ("wout", (2816, 1024))):
        meta = sparsity.BlockMeta(n_in, n_out, 128, 128)
        topos[name] = (meta, sparsity.BlockTopology.from_epsilon(meta, 64.0, rng))
    for name, (meta, host) in topos.items():
        t = host.device_arrays(dev)
        v = host.init_values(rng, dtype=torch.bfloat16, device=dev)
        dense = ref.blocks_to_dense(v, t.rows, t.cols, meta.grid_m, meta.grid_n)
        for batch in ROWS:
            x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(np.float32),
                                device=dev).to(torch.bfloat16)
            want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
            plan = bsm.fwd_plan(host.n_blocks, meta.grid_n, batch, 128, 128, bf16=True)
            row = dict(weight=name, rows=batch, card=card, plan=plan._asdict(), variants={})
            runs = {}
            for vname, route, tr, tf in variants(batch):
                run = launcher(x, v, t, meta, route, tr, tf)
                ys = [run() for _ in range(3)]
                torch.cuda.synchronize()
                check(f"{name} {batch} rows {vname}: 3 launches bit-equal",
                      all(torch.equal(ys[0], y) for y in ys[1:]))
                err = float((ys[0].float() - want.float()).abs().max())
                check(f"{name} {batch} rows {vname}: max |diff| {err} > {TOL}", err <= TOL)
                for li in (1, 2):
                    fused = launcher(x, v, t, meta, route, tr, tf, li)()
                    after = all_relu_fused.bias_all_relu(ys[0], None, alpha=ALPHA, layer_index=li)
                    check(f"{name} {batch} rows {vname}: the store's All-ReLU is C then B",
                          torch.equal(fused.view(torch.int16), after.view(torch.int16)))
                if route == "decode" and batch > 1:
                    alone = [launcher(x[r:r + 1].clone(), v, t, meta, route, tr, tf)()
                             for r in (0, batch - 1)]
                    check(f"{name} {batch} rows {vname}: a row alone as within the call",
                          torch.equal(alone[0][0], ys[0][0]) and torch.equal(alone[1][0],
                                                                              ys[0][-1]))
                runs[vname] = run
                row["variants"][vname] = dict(max_abs_err=err, us=[])
            order = list(runs)
            for vname in order[:1] + order[1:] + order[1:] + order[:1]:
                row["variants"][vname]["us"].append(device_us(runs[vname]))
            chosen = ("decode/16" if plan.route == "decode" else
                      f"rows/{plan.tile_rows}/{plan.tile_feat}")
            row["plan_variant"] = chosen
            row["plan_epilogue_us"] = device_us(launcher(x, v, t, meta, plan.route,
                                                         plan.tile_rows, plan.tile_feat, 1))
            row["matmul_us"] = device_us(lambda: torch.matmul(x, dense))
            used = int(np.unique(host.rows).size)
            row["bound_us"] = 2 * (batch * used * 128 + v.numel() + batch * meta.padded_out) \
                / 3.35e12 * 1e6
            print(json.dumps({"bsmm_bf16_probe": row}), flush=True)
    print(json.dumps({"bsmm_bf16_column_sweep": column_sweep(dev, card)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
