#!/usr/bin/env python3
"""Where one block of the scalar kernel E spent its time: a probe run once
on the card before kernel E moved to cp.async and 3xTF32 tensor cores.

It takes the scalar kernel E's source (``csrc/bsmm_dw.cu`` as of commit
5dc729e: one block per (slot, 64 x 64 quarter), 32-sample slices staged by
scalar loads behind a barrier, f32 FMAs) and builds four variants of it,
each behind the same plain C entry point and ctypes call:

    orig   the kernel as it was;
    nofma  the FMA loop removed (loads, shared stores and barriers kept);
    const  the global loads replaced by constants (the FMA loop kept);
    empty  an empty kernel on the same grid.

Each is timed with CUDA events over 200 back-to-back launches at 128 x 128
tiles, for 32 and 8 tiles, batch 32 to 512. Nothing here is part of the
port; the variants are written to ``build/probe/`` (gitignored).

    git show 5dc729e:src/repro_torch/csrc/bsmm_dw.cu > build/old_bsmm_dw.cu
    python3 tools/dw_latency_probe.py build/old_bsmm_dw.cu      # on the card
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

NVCC = "/usr/local/cuda/bin/nvcc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
OUT = Path("build/probe")


def variants(src: str) -> dict:
    loop = re.compile(r"#pragma unroll 4\n    for \(int k = 0; k < k_valid; \+\+k\) \{.*?\n"
                      r"    \}\n    __syncthreads\(\);\n  \}", re.S)
    x_load = "__ldg(xt + (b0 + k) * x_stride + m)"
    dy_load = "__ldg(dyt + (b0 + k) * dy_stride + n)"
    head = "__global__ void __launch_bounds__(kThreads)\nbsmm_dw_kernel("
    if not (loop.search(src) and x_load in src and dy_load in src and head in src):
        raise SystemExit("not the scalar kernel E source this probe edits")
    # one shared read keeps the staged stores alive without the FMA loop
    nofma = loop.sub("acc[0][0] += xs[ty][tx] * ys[tx][ty];\n    __syncthreads();\n  }", src)
    const = src.replace(x_load, "1.0f").replace(dy_load, "0.5f")
    empty = src.replace(head, head.replace("bsmm_dw_kernel(", "unused_kernel(")).replace(
        "}  // namespace",
        "__global__ void __launch_bounds__(kThreads)\n"
        "bsmm_dw_kernel(const float*, const float*, const int32_t*, const int32_t*, float*,\n"
        "               int64_t, int64_t, int64_t, int, int) {}\n}  // namespace")
    return dict(orig=src, nofma=nofma, const=const, empty=empty)


def build(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        print(name, re.findall(r"Used \d+ registers[^\n]*", log))
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).bsmm_dw_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_us(fn, reps: int = 200) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))  # hold the stream while the host enqueues
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    fns = build(variants(Path(sys.argv[1]).read_text()))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for nb, grid_m, grid_n in ((32, 24, 32), (8, 32, 8)):
        rows = torch.randint(0, grid_m, (nb,), generator=gen, dtype=torch.int32).to(dev)
        cols = torch.randint(0, grid_n, (nb,), generator=gen, dtype=torch.int32).to(dev)
        dw = torch.empty(nb, 128, 128, device=dev)
        for batch in (32, 64, 128, 256, 512):
            x = torch.randn(batch, grid_m * 128, generator=gen).to(dev)
            dy = torch.randn(batch, grid_n * 128, generator=gen).to(dev)
            for name, fn in fns.items():
                def call(fn=fn, x=x, dy=dy, batch=batch):
                    rc = fn(x.data_ptr(), dy.data_ptr(), rows.data_ptr(), cols.data_ptr(),
                            dw.data_ptr(), nb, batch, grid_m, grid_n, 128, 128, 0, stream)
                    assert rc == 0, rc
                res[f"tiles{nb}_batch{batch}_{name}"] = device_us(call)
    print(json.dumps({"dw_probe_us": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
