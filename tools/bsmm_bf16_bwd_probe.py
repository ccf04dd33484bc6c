#!/usr/bin/env python3
"""Kernels D and E's bf16 instances (the LM's training backward) on one card.

1. Their builds' registers and spills (``-Xptxas -v``), and how many of
   E's clusters of each size the card holds at once
   (``cudaOccupancyMaxActiveClusters``).
2. Each held within 1e-2 + 1e-2 x |plain| of its plain version, bit-equal
   over three launches, with dx's uncovered block-rows exactly 0: on
   Qwen1.5-0.5B's first-layer W_in (1024 -> 2816, 22 tiles) and W_out
   (2816 -> 1024, 15 tiles) at 1 to 4,096 rows (every E run count from 1
   to the cap, ragged last chunks), on W_in's grid with every block-column
   holding 4, 5 or 8 slots (block-rows of up to 22 slots), and on tiles of
   16 x 16 to 128 x 64 at 77 rows. E's S (``dw_splits_bf16``) is printed
   beside each case.
3. At 2,048 rows, CUDA events over 100 calls behind a spin kernel (as
   ``chip_smoke.py``'s ``device_ms``): D and E at S = 1..8 through the C
   entry points, beside the wrappers' own S, the plain versions and the
   library calls (``torch.matmul`` on the densified W^T, ``torch.bmm`` on
   tiles gathered beforehand).
4. A call's host time: the wrapper (its checks, allocation and the C call)
   and the C entry point alone (tensor maps, launch), microseconds a call
   over 2,000 calls, the stream drained every 100.

    PYTHONPATH=src python3 tools/bsmm_bf16_bwd_probe.py      # on the card

With ``--host LABEL`` it does only this: one JSON line with each wrapper
call's host time (as in 4) and device time (as in 3) on W_in and W_out at
2,048 rows, the card's name and power limit, and LABEL. It calls the public
wrappers alone, so that it times any tree of the port: run it with that
tree's ``src`` first on ``PYTHONPATH``, parent and change in one call.

Exits 1 when a check fails.
"""
import ctypes
import json
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import sparsity as tsp
from repro_torch.kernels import block_sparse_matmul as bsm
from repro_torch.kernels import build, ref

ROWS = (1, 8, 63, 64, 65, 100, 255, 256, 257, 512, 1100, 2048, 3100, 4096)


def case(meta, topo, rows, rng, dev):
    v = topo.init_values(rng, dtype=torch.bfloat16, device=dev)
    x = torch.as_tensor(rng.standard_normal((rows, meta.padded_in)).astype(np.float32),
                        device=dev).bfloat16()
    dy = torch.as_tensor(rng.standard_normal((rows, meta.padded_out)).astype(np.float32),
                         device=dev).bfloat16()
    return topo.device_arrays(dev), v, x, dy


def device_us(fn, reps=100):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))  # holds the stream while the host enqueues
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def host_us(fn, calls=2000):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    spent = 0.0
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        spent += time.perf_counter() - t0
        if i % 100 == 99:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return spent / calls * 1e6


def within(got, want):
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), bool((diff <= 1e-2 + 1e-2 * want.float().abs()).all())


def raw_dx(dy, v, t, meta):
    """Kernel D bf16 through its C entry point."""
    dx = torch.empty((dy.shape[0], meta.padded_in), dtype=torch.bfloat16, device=dy.device)
    row_ptr = bsm._offsets_once(t.rows_r, meta.grid_m)
    fn = build.kernel("bsmm_dx", "bsmm_dx_bf16", bsm._DX_BF16_ARGTYPES)
    args = (dy.data_ptr(), v.data_ptr(), t.cols_r.data_ptr(), t.perm_r.data_ptr(),
            row_ptr.data_ptr(), dx.data_ptr(), dy.shape[0], meta.grid_m, meta.grid_n,
            v.shape[0], meta.block_m, meta.block_n, *build.stream_args(dy.device))
    return (lambda: build.check_launch(fn(*args), "bsmm_dx_bf16")), dx


def raw_dw(x, dy, t, meta, splits):
    """Kernel E bf16 through its C entry point at a given S."""
    dw = torch.empty((t.rows.numel(), meta.block_m, meta.block_n), dtype=torch.bfloat16,
                     device=x.device)
    fn = build.kernel("bsmm_dw", "bsmm_dw_bf16", bsm._DW_BF16_ARGTYPES)
    args = (x.data_ptr(), dy.data_ptr(), t.rows.data_ptr(), t.cols.data_ptr(), dw.data_ptr(),
            t.rows.numel(), x.shape[0], meta.grid_m, meta.grid_n, meta.block_m, meta.block_n,
            splits, *build.stream_args(x.device))
    return (lambda: build.check_launch(fn(*args), "bsmm_dw_bf16")), dw


def max_clusters(source, symbol, size, dev):
    fn = build.kernel(source, symbol, [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = ctypes.c_int(0)
    build.check_launch(fn(size, dev.index, ctypes.addressof(out)), symbol)
    return out.value


def lm_weights():
    """The first layer's W_in and W_out topologies of the LM (seed 0)."""
    rng = np.random.default_rng(0)
    return rng, (("win", tsp.BlockTopology.from_epsilon(tsp.BlockMeta(1024, 2816), 64.0, rng)),
                 ("wout", tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2816, 1024), 64.0, rng)))


def host_only(label: str, dev) -> int:
    """``--host LABEL``: the public wrappers' host and device time a call."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    rng, weights = lm_weights()
    out = {"label": label, "card": smi.strip()}
    for name, topo in weights:
        meta = topo.meta
        t, v, x, dy = case(meta, topo, 2048, rng, dev)

        def d():
            return bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                               grid_m=meta.grid_m)

        def e():
            return bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=128, block_n=128)

        out[name] = {"dx_host_us": host_us(d), "dx_device_us": device_us(d),
                     "dw_host_us": host_us(e), "dw_device_us": device_us(e)}
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("bsmm_bf16_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if sys.argv[1:2] == ["--host"]:
        return host_only(sys.argv[2] if len(sys.argv) > 2 else "", dev)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    for source, log in build.build(("bsmm_dx", "bsmm_dw")).items():
        keep = [ln for ln in log.splitlines()
                if "Used" in ln or "spill" in ln or "warn" in ln.lower() or "bf16" in ln]
        print(f"== {source}\n" + "\n".join(keep), flush=True)
    print("max active clusters of E: " + ", ".join(
        f"S={s}: {max_clusters('bsmm_dw', 'bsmm_dw_bf16_max_clusters', s, dev)}"
        for s in range(1, 9)), flush=True)

    rng, weights = lm_weights()
    cases = [(f"{name} {rows}", t.meta, t, rows) for name, t in weights for rows in ROWS]
    meta = tsp.BlockMeta(1024, 2816, 128, 128)
    for length in (4, 5, 8):
        block_rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                                     for _ in range(meta.grid_n)])
        cases.append((f"columns of {length} 2048", meta, tsp.BlockTopology(
            meta, block_rows, np.repeat(np.arange(meta.grid_n), length)), 2048))
    for bm, bn in ((16, 16), (32, 48), (96, 16), (128, 64), (48, 128)):
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

        try:
            dxs, dws = [d() for _ in range(3)], [e() for _ in range(3)]
            torch.cuda.synchronize()
        except RuntimeError as err:
            print(f"{what}: FAILED to run: {err}", flush=True)
            return 1
        err_d, ok_d = within(dxs[0], bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row,
                                                       t.perm_r, grid_m=meta.grid_m))
        err_e, ok_e = within(dws[0], bsm.bsmm_dw_plain(x, dy, t.rows, t.cols,
                                                       block_m=meta.block_m,
                                                       block_n=meta.block_n))
        oracle = (within(dxs[0], ref.bsmm_dx_ref(dy.float(), v.float(), t.rows, t.cols,
                                                 grid_m=meta.grid_m, grid_n=meta.grid_n))[0],
                  within(dws[0], ref.bsmm_dw_ref(x.float(), dy.float(), t.rows, t.cols,
                                                 block_m=meta.block_m,
                                                 block_n=meta.block_n))[0])
        same = all(torch.equal(a[0].view(torch.int16), b.view(torch.int16))
                   for a in (dxs, dws) for b in a[1:])
        covered = np.zeros(meta.grid_m, bool)
        covered[topo.rows] = True
        zero = bool((dxs[0][:, torch.as_tensor(np.repeat(~covered, meta.block_m),
                                                device=dev)] == 0).all())
        fails += not (ok_d and ok_e and same and zero)
        print(f"{what}: D err {err_d:.4g} ok {ok_d}, E err {err_e:.4g} ok {ok_e}, vs ref "
              f"{oracle[0]:.4g} {oracle[1]:.4g}, same bits {same}, uncovered zero {zero}, S "
              f"{bsm.dw_splits_bf16(topo.n_blocks, rows)}", flush=True)

    if fails:
        print(f"{fails} case(s) failed")
        return 1
    # times at the train step's 2,048 rows; the raw calls at other S are held
    # to the plain version's tolerance too
    for name, topo in weights:
        meta = topo.meta
        t, v, x, dy = case(meta, topo, 2048, rng, dev)
        want_dx = bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                    grid_m=meta.grid_m)
        want_dw = bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=128, block_n=128)
        line = []
        call, dx = raw_dx(dy, v, t, meta)
        us = device_us(call)
        err, ok = within(dx, want_dx)
        fails += not ok
        line.append(f"D {us:.2f} (err {err:.3g})")
        for s in range(1, 9):
            call, dw = raw_dw(x, dy, t, meta, s)
            us = device_us(call)
            err, ok = within(dw, want_dw)
            fails += not ok
            line.append(f"E S={s} {us:.2f} (err {err:.3g})")
        dense = ref.blocks_to_dense(v, t.rows, t.cols, meta.grid_m, meta.grid_n)
        xg = x.reshape(2048, meta.grid_m, 128)[:, t.rows.long()].permute(1, 2, 0).contiguous()
        dyg = dy.reshape(2048, meta.grid_n, 128)[:, t.cols.long()].transpose(0, 1).contiguous()

        def d():
            return bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                               grid_m=meta.grid_m)

        def e():
            return bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=128, block_n=128)

        line += [f"wrapper D {device_us(d):.2f}",
                 f"wrapper E {device_us(e):.2f} (S {bsm.dw_splits_bf16(topo.n_blocks, 2048)})",
                 f"matmul {device_us(lambda: torch.matmul(dy, dense.t())):.2f}",
                 f"bmm {device_us(lambda: torch.bmm(xg, dyg)):.2f}",
                 f"plain D {device_us(lambda: bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m), 10):.2f}",  # noqa: E501
                 f"plain E {device_us(lambda: bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=128, block_n=128), 10):.2f}"]  # noqa: E501
        print(f"us at 2048 rows, {name}: " + ", ".join(line), flush=True)
        print(f"host us a call, {name}: wrapper D {host_us(d):.2f}, C entry D "
              f"{host_us(raw_dx(dy, v, t, meta)[0]):.2f}, "
              f"wrapper E {host_us(e):.2f}, C entry E "
              f"{host_us(raw_dw(x, dy, t, meta, bsm.dw_splits_bf16(topo.n_blocks, 2048))[0]):.2f}",
              flush=True)
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
