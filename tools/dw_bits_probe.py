#!/usr/bin/env python3
"""Kernel F's run design against the kernels it replaced, bit for bit: a
check run once on the card.

Kernel F (``csrc/coo_dw.cu``) gives one warp a run of one column's slots
and computes dz and dbias (kernel G's work) in its epilogue. It keeps, on
purpose, the sum orders of the one-warp-a-slot kernel F and the
one-warp-a-row kernel G it replaced (commit ed4f200), so that the training
trajectory does not move. This builds those two kernels from copies of
their sources and compares their outputs with the new kernel's with
``torch.equal``: dv against the old F on the old G's dz, dz and dbias
against the old G, in the three epilogue modes (no bias; the bias alone;
bias + All-ReLU with the mask of kernel A's training epilogue, both slope
signs, some pre-activations exactly 0), at the full-width CIFAR-10 element
model's four layers (3072-4000-1000-4000-10, epsilon 20, seed 0), batch
128 and 33, on the layer and with every third column emptied. At batch
128 it also times, per layer, the old G then the old F against the new
kernel with the layer's epilogue (CUDA events over 200 back-to-back calls).
The old kernels are built into ``build/probe/`` (gitignored); nothing here
is part of the port.

    git show ed4f200:src/repro_torch/csrc/coo_dw.cu > build/old_coo_dw.cu
    git show ed4f200:src/repro_torch/csrc/all_relu_bwd.cu > build/old_all_relu_bwd.cu
    PYTHONPATH=src python3 tools/dw_bits_probe.py      # on the card

It exits 1 with this message where the copies or the card are missing, and
1 after its report where any output differs.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.set_mlp import mlp_config
from repro_torch.core import sparsity
from repro_torch.data.datasets import load
from repro_torch.kernels import build
from repro_torch.kernels.ref import slope_for
from repro_torch.models.mlp import SparseMLP

OLD = {"coo_dw": Path("build/old_coo_dw.cu"), "all_relu_bwd": Path("build/old_all_relu_bwd.cu")}
OUT = Path("build/probe")
ARGTYPES = {
    "coo_dw": [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p],
    "all_relu_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p],
}


def build_old() -> dict:
    """The old kernels' C entry points, both built at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"libold_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, src in OLD.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for the old {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(OUT / f"libold_{name}.so")), f"{name}_f32")
        fn.argtypes, fn.restype = ARGTYPES[name], ctypes.c_int
        fns[name] = fn
    return fns


def old_outputs(fns, hT, dy, t, mode, mask, slope):
    """(dv, dz, dbias) of the old G then the old F; dz and dbias None in
    mode 0 (no epilogue)."""
    stream = build.stream_args(dy.device)
    dz = dbias = None
    if mode:
        dz, dbias = torch.empty_like(dy), torch.empty(dy.shape[0], device=dy.device)
        rc = fns["all_relu_bwd"](dy.data_ptr(), None if mask is None else mask.data_ptr(),
                                 dz.data_ptr(), dbias.data_ptr(), dy.shape[0], dy.shape[1],
                                 0.0 if slope is None else slope, *stream)
        build.check_launch(rc, "the old kernel G")
    dv = torch.empty(t.rows.shape[0], device=dy.device)
    if dv.numel():
        rc = fns["coo_dw"](hT.data_ptr(), (dy if dz is None else dz).data_ptr(),
                           t.rows.data_ptr(), t.cols.data_ptr(), dv.data_ptr(), dv.numel(),
                           dy.shape[1], *stream)
        build.check_launch(rc, "the old kernel F")
    return dv, dz, dbias


def device_us(fn, reps: int = 200) -> float:
    """Device time of one call, CUDA events around ``reps`` calls queued
    behind a spin kernel (chip_smoke.py's ``device_ms``)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main() -> int:
    missing = [str(p) for p in OLD.values() if not p.exists()]
    if missing or not torch.cuda.is_available():
        print(f"missing {missing or 'a CUDA card'}\n{__doc__}", file=sys.stderr)
        return 1
    fns = build_old()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = mlp_config("cifar10")
    model = SparseMLP(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    x_train = load("cifar10", scale=0.02).x_train
    results, n_zero, times = [], 0, []
    for batch in (128, 33):
        hT = torch.as_tensor(np.ascontiguousarray(x_train[:batch].T), device=dev)
        for l, (host, v) in enumerate(zip(model.topos, model.values)):
            t = host.device_arrays(dev)
            dy = torch.as_tensor(
                (0.01 * rng.standard_normal((host.out_dim, batch))).astype(np.float32), device=dev)
            # a bias that cancels the product in batch column 0 of every third
            # feature: pre-activations exactly 0 there (the slope branch)
            prod = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim)
            bias = torch.as_tensor((0.1 * rng.standard_normal(host.out_dim)).astype(np.float32),
                                   device=dev)
            bias[::3] = -prod[::3, 0]
            keep = host.cols % 3 != 0
            host_e = sparsity.ElementTopology(host.in_dim, host.out_dim, host.rows[keep],
                                              host.cols[keep])
            for tt, emptied in ((t, False), (host_e.device_arrays(dev), True)):
                for mode, layer_index in ((0, None), (1, None), (2, 1), (2, 2)):
                    mask = slope = None
                    if mode == 2:
                        slope = slope_for(cfg.alpha, layer_index)
                        _, mask = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim,
                                                        bias=bias, slope=slope, with_mask=True)
                        n_zero += int((prod + bias[:, None] == 0).sum())
                    old = old_outputs(fns, hT, dy, tt, mode, mask, slope)
                    new = sparsity.coo_dw(hT, dy, tt.rows, tt.cols, with_dbias=mode > 0,
                                          mask=mask, slope=slope)
                    new = new if mode else (new, None, None)
                    torch.cuda.synchronize()
                    same = {k: torch.equal(a, b) for k, a, b in zip(("dv", "dz", "dbias"), new, old)
                            if b is not None}
                    results.append(dict(layer=l, batch=batch, mode=mode, slope=slope,
                                        emptied=emptied, **same))
                    step_epilogue = (2, 1) if l < 3 else (1, None)  # All-ReLU; the bias alone
                    if batch == 128 and not emptied and (mode, layer_index) == step_epilogue:
                        times.append(dict(
                            layer=l, mode=mode,
                            old_g_then_f_us=device_us(
                                lambda: old_outputs(fns, hT, dy, tt, mode, mask, slope)),
                            new_us=device_us(lambda: sparsity.coo_dw(
                                hT, dy, tt.rows, tt.cols, with_dbias=True, mask=mask,
                                slope=slope)),
                            new_no_epilogue_us=device_us(
                                lambda: sparsity.coo_dw(hT, dy, tt.rows, tt.cols))))
            hT = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim,
                                       bias=model.biases[l],
                                       slope=slope_for(cfg.alpha, l + 1) if l < 3 else None)
    bad = [r for r in results if not all(r[k] for k in ("dv", "dz", "dbias") if k in r)]
    print(json.dumps({"dw_bits": dict(cases=len(results), differing=bad,
                                      pre_activations_exactly_0=n_zero)}))
    print(json.dumps({"dw_time_us": times}))
    print(f"{len(results) - len(bad)} of {len(results)} cases bit-equal to the old kernels F and G")
    return 1 if bad or not n_zero else 0


if __name__ == "__main__":
    sys.exit(main())
