#!/usr/bin/env python3
"""Where one block of kernels A (staged route) and D, and one CTA of kernels
D's and E's bf16 instances, spends its cycles, on the card: clock64 spans
inside copies of the kernels' sources.

It copies ``src/repro_torch/csrc/coo_matmul_T.cu`` and ``bsmm_dx.cu`` into
``build/probe/`` (gitignored), adds clock64 reads at fixed points and a
``read_clk`` entry point, builds them with the port's nvcc flags, and runs
them behind the kernels' own ctypes signatures on the shapes the main paths
give them:

    A   the full-width Table-4 output layer (500,000 -> 2, dense: 2
        segments of 500,000 slots) at batch 32 and 512 with the bias
        epilogue, and the served output layer (10 segments of 2,800 slots)
        at batch 1 and 128: per block, the summing warp's cycles per slot,
        split into its waits for a stage to land and the rest (its FMAs,
        shared-memory loads and barriers), beside the FMA chain's floor;
        a loader's cycles and its waits for a free stage. At full width
        also the real kernel's time (CUDA events) beside its bytes bound,
        the chain's floor, the plain version's and ``torch.sparse.mm``'s;
    D   the full-width block model's layers 1-3 at batch 128: per block,
        cycles from entry to row_ptr read, to the first stage and the whole
        prologue (3 stages) issued, to the first compute (the first stage
        landed, the fourth issued), and in compute per 32-deep stage.

The floor is a chain of dependent FMAs through the addend on one warp
(cycles per FMA and the clock rate), as kernel A's chains run. Timings of
the instrumented kernels (CUDA events) are printed beside them; the clock
reads cost a few cycles each.

``bf16``: kernels D's and E's bf16 instances on Qwen1.5-0.5B's first-layer
W_in (1024 -> 2816, 22 tiles) and W_out (2816 -> 1024, 15 tiles) at the LM
train step's 2,048 rows, E at S = 1, 2, 4, 8 runs a cluster, through the
kernels' own C entry points, beside three copies of each source with one
change:

    empty   each CTA returns at its first instruction: a launch's floor;
    loop    each CTA returns after its main loop: the loads and products
            without the sum or the store;
    spans   clock64 reads in thread 0 (a consumer): entry to the consumers'
            start (the barriers set up), the main loop, and the rest (E's
            cluster sum and the stores), in thousands of cycles, mean and
            largest over the CTAs; and the main loop's TMA bytes over its
            longest span, in bytes a cycle, summed over the card.

Nothing here is part of the port.

    python3 tools/block_span_probe.py [a] [f32] [bf16]   # from the repository root, on the card

``a`` runs kernel A's part alone, ``f32`` kernels A's and D's.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as bsm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.serve import SparseInferenceEngine  # noqa: E402

OUT = ROOT / "build" / "probe"
N_SPANS = 8192
SPANS = (f"\n__device__ long long g_spans[{N_SPANS}][4];\n"
         "extern \"C\" int read_spans(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_spans, sizeof(g_spans)));\n}\n"
         "extern \"C\" int clear_spans() {\n  void* p = nullptr;\n"
         "  cudaError_t err = cudaGetSymbolAddress(&p, g_spans);\n"
         "  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof(g_spans));\n"
         "  return static_cast<int>(err);\n}\n")
RECORD = ("  if (tid == 0) {\n"
          "    long long* o = g_spans[blockIdx.x + gridDim.x * blockIdx.y];\n"
          "    o[0] = t_ready - t_entry; o[1] = t_loop - t_ready; o[2] = clock64() - t_loop;"
          " o[3] = 1;\n  }\n")
ENTRY = "  extern __shared__ unsigned char smem_raw[];\n"
LOOP_END = "  const bool consumer = warp < kConsumersH * 4;\n"
# the ends of the bf16 kernels' epilogues: D's one; E's without a cluster,
# then with one
BF16_ENDS = {
    "bsmm_dx": ("  sm90::copy_rows<kPitchB>(stage_b, b_valid, bm, out, dx_stride, tid, kThreadsH);"
                "\n}\n",),
    "bsmm_dw": (
        "    sm90::copy_rows<kPitchB>(stage_b, bm, bn, out, bn, tid, kThreadsH);\n    return;\n",
        "  sm90::cluster_wait();            // ... once all have, no copy still reads a staging\n}\n"),
}
N_CLK = 1 << 17
GLOBALS = f"__device__ long long g_clk[{N_CLK}];\n"
READ = ("\nextern \"C\" int read_clk(void* dst, int n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_clk, n * sizeof(long long)));\n}\n")
CHAIN = r'''
#include <cuda_runtime.h>
__global__ void chain(float* out, long long* cycles, int n) {
  float s = out[threadIdx.x], a = out[32 + threadIdx.x], b = out[64 + threadIdx.x];
  const long long t0 = clock64();
#pragma unroll 32
  for (int i = 0; i < n; ++i) s = fmaf(a, b, s);
  const long long t1 = clock64();
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}
extern "C" int run_chain(void* out, void* cycles, int n, void* stream) {
  chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out),
                                                         static_cast<long long*>(cycles), n);
  return static_cast<int>(cudaGetLastError());
}
'''


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"not the kernel source this probe edits: {old[:60]!r}")
    return src.replace(old, new)


def probe_a(src: str) -> str:
    """Slot 16*block: the summing warp (tid 0): total cycles, its waits for
    a stage to land, chunks; slot +8: a loader (tid 32): total cycles, its
    waits for a free stage."""
    src = sub(src, "namespace {\n", "namespace {\n" + GLOBALS)
    src = sub(src, "    auto wait_full = [&](int c) {\n",
              "    const long long c0 = clock64();\n    long long c_wait = 0;\n"
              "    auto wait_full = [&](int c) {\n      const long long cw = clock64();\n")
    src = sub(src, "(c / kStagedStages) & 1)) {\n      }\n",
              "(c / kStagedStages) & 1)) {\n      }\n      c_wait += clock64() - cw;\n")
    slot = "g_clk + 16 * ((blockIdx.x + gridDim.x * blockIdx.y) % 4096)"
    src = sub(src, "    if (summer) store(sum, bias_s, slope, mode, out, mask, s * batch + b0 + b);\n",
              "    if (summer) store(sum, bias_s, slope, mode, out, mask, s * batch + b0 + b);\n"
              f"    if (lane == 0) {{\n      long long* o = {slot};\n"
              "      o[0] = clock64() - c0; o[1] = c_wait; o[2] = n_chunks; o[3] = 1;\n    }\n")
    src = sub(src, "    const int lt = (warp < 4 ? warp - 1 : 3) * 32 + lane;\n",
              "    const int lt = (warp < 4 ? warp - 1 : 3) * 32 + lane;\n"
              "    const long long l0 = clock64();\n    long long l_wait = 0;\n")
    src = sub(src, "      if (c >= kStagedStages) sm90::mbar_wait(empty0 + 8 * st, ((c / kStagedStages) + 1) & 1);\n",
              "      const long long lw = clock64();\n"
              "      if (c >= kStagedStages) sm90::mbar_wait(empty0 + 8 * st, ((c / kStagedStages) + 1) & 1);\n"
              "      l_wait += clock64() - lw;\n")
    src = sub(src, "    tf32x3::cp_async_wait<0>();\n",
              "    tf32x3::cp_async_wait<0>();\n"
              f"    if (lt == 0) {{\n      long long* o = {slot} + 8;\n"
              "      o[0] = clock64() - l0; o[1] = l_wait;\n    }\n")
    return src + READ


def probe_d(src: str) -> str:
    """Slot 8*block (thread 0): total, row_ptr read, first stage issued,
    prologue issued, first compute, compute, stages."""
    src = sub(src, "namespace {\n", "namespace {\n" + GLOBALS)
    src = sub(src, "  extern __shared__ __align__(16) float smem[];\n  const int64_t r = blockIdx.x / parts;",
              "  extern __shared__ __align__(16) float smem[];\n  const long long c0 = clock64();\n"
              "  long long c_ptr = 0, c_ld0 = 0, c_pro = 0, c_first = 0, c_comp = 0;\n"
              "  const int64_t r = blockIdx.x / parts;")
    src = sub(src, "  for (int st = 0; st < kStages - 1; ++st) {\n    if (st < n_steps) load(st);\n",
              "  for (int st = 0; st < kStages - 1; ++st) {\n    if (st == 0) {\n"
              "      asm volatile(\"\" :: \"l\"(n_steps));\n      c_ptr = clock64() - c0;\n    }\n"
              "    if (st < n_steps) load(st);\n    if (st == 0) c_ld0 = clock64() - c0;\n")
    src = sub(src, "  for (int64_t step = 0; step < n_steps; ++step) {\n",
              "  c_pro = clock64() - c0;\n  for (int64_t step = 0; step < n_steps; ++step) {\n")
    src = sub(src, "    tf32x3::cp_async_commit();\n\n    const uint32_t stage",
              "    tf32x3::cp_async_commit();\n    const long long cc = clock64();\n"
              "    if (step == 0) c_first = cc - c0;\n\n    const uint32_t stage")
    src = sub(src, "      for (int kk = 0; kk < k_valid; kk += 8) step8(kk);\n    }\n  }\n",
              "      for (int kk = 0; kk < k_valid; kk += 8) step8(kk);\n    }\n"
              "    asm volatile(\"\" :: \"f\"(acc[0][0][0]), \"f\"(acc[1][1][3]));\n"
              "    c_comp += clock64() - cc;\n  }\n")
    src = re.sub(r"(        if \(m \+ 1 < m_valid\) xt\[b \* dx_stride \+ m \+ 1\] = acc\[i\]\[j\]\[2 \* h \+ 1\];\n"
                 r"      \}\n    \}\n  \}\n)\}",
                 r"\1  if (tid == 0) {\n"
                 r"    long long* o = g_clk + 8 * ((blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z)) % 8192);\n"
                 r"    o[0] = clock64() - c0; o[1] = c_ptr; o[2] = c_ld0; o[3] = c_pro; o[4] = c_first;"
                 r" o[5] = c_comp; o[6] = n_steps;\n  }\n}", src)
    if "o[5] = c_comp" not in src:
        raise SystemExit("not the kernel D source this probe edits: the stores")
    return src + READ


def probe_bf16(variant: str, source: str, src: str) -> str:
    """One of the copies of a bf16 kernel that the module's doc lists."""
    if variant == "empty":
        return sub(src, ENTRY, ENTRY + "  if (batch > 0) return;\n")
    if variant == "loop":
        return sub(src, LOOP_END, "  if (batch > 0) return;\n" + LOOP_END)
    src = sub(src, '#include "tf32x3.cuh"\n', '#include "tf32x3.cuh"\n' + SPANS)
    src = sub(src, ENTRY, ENTRY + "  const long long t_entry = clock64();\n"
              "  long long t_ready = t_entry;\n")
    src = sub(src, "    sm90::bar_sync(1, kThreadsH);\n",
              "    sm90::bar_sync(1, kThreadsH);\n    t_ready = clock64();\n")
    src = sub(src, LOOP_END, "  const long long t_loop = clock64();\n" + LOOP_END)
    for end in BF16_ENDS[source]:
        if end.endswith("    return;\n"):
            src = sub(src, end, end.replace("    return;\n", "  " + RECORD.replace("\n  ", "\n    ")
                                            + "    return;\n"))
        else:
            src = sub(src, end, end[:-2] + RECORD + "}\n")
    return src


def build_all(srcs: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        (OUT / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(OUT / f"lib{name}.so"), str(OUT / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def spans(lib, n: int) -> np.ndarray:
    buf = np.zeros(n, np.int64)
    torch.cuda.synchronize()
    if lib.read_clk(buf.ctypes.data_as(ctypes.c_void_p), n):
        raise SystemExit("read_clk failed")
    return buf


def bf16_spans(dev) -> None:
    """The ``bf16`` section of the module's doc."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    libs = build_all({f"{variant}_{source}": probe_bf16(
        variant, source, (build.CSRC / f"{source}.cu").read_text())
        for variant in ("empty", "loop", "spans") for source in ("bsmm_dx", "bsmm_dw")})
    build.build(("bsmm_dx", "bsmm_dw"))
    for source in ("bsmm_dx", "bsmm_dw"):
        libs[f"kernel_{source}"] = ctypes.CDLL(str(build.library_path(source)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    t_in = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(1024, 2816), 64.0, rng)
    t_out = tsp.BlockTopology.from_epsilon(tsp.BlockMeta(2816, 1024), 64.0, rng)
    for wname, topo in (("win", t_in), ("wout", t_out)):
        meta = topo.meta
        t = topo.device_arrays(dev)
        v = topo.init_values(rng, dtype=torch.bfloat16, device=dev)
        x = torch.as_tensor(rng.standard_normal((2048, meta.padded_in)).astype(np.float32),
                            device=dev).bfloat16()
        dy = torch.as_tensor(rng.standard_normal((2048, meta.padded_out)).astype(np.float32),
                             device=dev).bfloat16()
        row_ptr = bsm._offsets_once(t.rows_r, meta.grid_m)
        for source, sizes in (("bsmm_dx", (1,)), ("bsmm_dw", (1, 2, 4, 8))):
            for size in sizes:
                if source == "bsmm_dx":
                    out = torch.empty((2048, meta.padded_in), dtype=torch.bfloat16, device=dev)
                    args = (dy.data_ptr(), v.data_ptr(), t.cols_r.data_ptr(), t.perm_r.data_ptr(),
                            row_ptr.data_ptr(), out.data_ptr(), 2048, meta.grid_m, meta.grid_n,
                            topo.n_blocks, 128, 128, 0, stream)
                    argtypes, ctas = bsm._DX_BF16_ARGTYPES, meta.grid_m * 16
                    loaded = topo.n_blocks * 16 * 2 * 32768  # slots x batch tiles x stages
                else:
                    out = torch.empty((topo.n_blocks, 128, 128), dtype=torch.bfloat16, device=dev)
                    args = (x.data_ptr(), dy.data_ptr(), t.rows.data_ptr(), t.cols.data_ptr(),
                            out.data_ptr(), topo.n_blocks, 2048, meta.grid_m, meta.grid_n, 128,
                            128, size, 0, stream)
                    argtypes, ctas = bsm._DW_BF16_ARGTYPES, topo.n_blocks * size
                    loaded = topo.n_blocks * 32 * 32768  # tiles x 64-row chunks x stage
                lib = libs[f"spans_{source}"]
                build.check_launch(lib.clear_spans(), "clear_spans")
                us = {}
                for variant in ("kernel", "empty", "loop", "spans"):
                    fn = getattr(libs[f"{variant}_{source}"], f"{source}_bf16")
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    us[variant] = 1e3 * cs.device_ms(
                        lambda: build.check_launch(fn(*args), variant))  # noqa: B023
                buf = np.zeros((N_SPANS, 4), np.int64)
                torch.cuda.synchronize()
                build.check_launch(lib.read_spans(buf.ctypes.data_as(ctypes.c_void_p)),
                                   "read_spans")
                live = buf[:ctas][buf[:ctas, 3] == 1] / 1000.0
                print(json.dumps({"bf16_spans": dict(
                    weight=wname, kernel=source, cluster=size, us=us, ctas=len(live),
                    kcycles_mean={n: float(live[:, k].mean())
                                  for k, n in enumerate(("ready", "loop", "rest"))},
                    kcycles_max={n: float(live[:, k].max())
                                 for k, n in enumerate(("ready", "loop", "rest"))},
                    loop_mb=loaded / 1e6,
                    loop_bytes_a_cycle=loaded / (live[:, 1].max() * 1000.0))}), flush=True)


def a_spans(dev, libs, stream) -> None:
    """The ``A`` section of the module's doc."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    med = lambda v: float(np.median(v))  # noqa: E731
    run_chain = libs["chain"].run_chain
    run_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    buf, cyc = torch.ones(96, device=dev), torch.zeros(1, dtype=torch.int64, device=dev)
    n = 500_000
    ms = cs.device_ms(lambda: run_chain(buf.data_ptr(), cyc.data_ptr(), n, stream), reps=20)
    per_fma, ghz = int(cyc.item()) / n, int(cyc.item()) / (ms * 1e6)
    print(json.dumps({"fma_chain": dict(n=n, ms=ms, cycles_per_fma=per_fma, ghz=ghz)}))

    cols = int(re.search(r"constexpr int kCols = (\d+);",
                         (build.CSRC / "coo_matmul_T.cu").read_text()).group(1))
    fa = libs["span_a"].coo_matmul_T_f32
    fa.argtypes, fa.restype = tsp._COO_MATMUL_T_ARGTYPES, ctypes.c_int
    rng = np.random.default_rng(0)

    def spans_of(what, srcT, vals, gather, seg_ptr, bias, n_seg, slots):
        batch = srcT.shape[1]
        out = torch.empty((n_seg, batch), device=dev)
        call = lambda: build.check_launch(fa(  # noqa: E731
            srcT.data_ptr(), vals.data_ptr(), gather.data_ptr(), seg_ptr.data_ptr(), None,
            None if bias is None else bias.data_ptr(), out.data_ptr(), None, n_seg, batch,
            tsp.COO_STAGED, 0.0, 0 if bias is None else 1, 0, stream), "span_a")
        ms = cs.device_ms(call, reps=20)
        call()
        blocks = n_seg * -(-batch // cols)
        c = spans(libs["span_a"], 16 * blocks).reshape(blocks, 2, 8)
        total, wait = med(c[:, 0, 0]) / slots, med(c[:, 0, 1]) / slots
        row = dict(layer=what, batch=batch, instrumented_ms=ms, blocks=blocks, slots=slots,
                   chunks=int(c[0, 0, 2]), summer_cycles_per_slot=total,
                   summer_wait_per_slot=wait, summer_own_per_slot=total - wait,
                   chain_floor_per_slot=per_fma, loader_cycles_per_slot=med(c[:, 1, 0]) / slots,
                   loader_wait_per_slot=med(c[:, 1, 1]) / slots)
        print(json.dumps({"a_spans": row}), flush=True)

    # the full-width Table-4 output layer, as the smoke builds it
    fw = cs.full_width_output_layer(rng, dev)
    n_src, n_seg, gather, seg, vals, bias, seg_ptr = (
        fw[k] for k in ("n_src", "n", "gather", "seg", "vals", "bias", "seg_ptr"))
    nnz = n_seg * n_src
    for batch in (32, 512):
        srcT = torch.as_tensor(rng.standard_normal((n_src, batch)).astype(np.float32),
                               device=dev)
        spans_of("full_width", srcT, vals, gather, seg_ptr, bias, n_seg, n_src)
        csr = torch.sparse_csr_tensor(seg_ptr, gather.long(), vals, (n_seg, n_src))
        cs.reset_counts()
        tsp.coo_matmul_T(srcT, vals, gather, seg, n_seg, seg_ptr=seg_ptr, bias=bias)
        staged = cs.read_counts()["coo_matmul_T.staged"]
        kernel_ms = cs.device_ms(lambda: tsp.coo_matmul_T(  # noqa: B023
            srcT, vals, gather, seg, n_seg, seg_ptr=seg_ptr, bias=bias), reps=20)
        print(json.dumps({"a_full_width": dict(
            batch=batch, ms=kernel_ms, staged_launches_a_call=staged,
            chain_floor_ms=n_src * per_fma / (ghz * 1e6),
            plain_ms=cs.device_ms(lambda: tsp.coo_matmul_T_plain(  # noqa: B023
                srcT, vals, gather, seg, n_seg, bias=bias), reps=3),
            library_ms=cs.library_ms(lambda: torch.sparse.mm(csr, srcT)),  # noqa: B023
            card=smi.strip(),
            **cs.bound(4 * (srcT.numel() + 2 * nnz + n_seg * batch) + 8 * (n_seg + 1),
                       2 * nnz * batch))}), flush=True)
        del srcT, csr
        torch.cuda.empty_cache()

    engine = SparseInferenceEngine(cs.seeded_model("cuda"), compaction=cs.SCHEDULE)
    host, vals = engine.model.topos[-1], engine.model.values[-1]
    t = host.device_arrays(dev)
    seg_ptr = tsp.registered_offsets(t.cols)
    for batch in (1, 128):
        srcT = torch.as_tensor(rng.standard_normal((host.in_dim, batch)).astype(np.float32),
                               device=dev)
        spans_of("served_output", srcT, vals, t.rows, seg_ptr, None, host.out_dim,
                 int(np.diff(host.col_ptr()).max()))


def main() -> int:
    if not torch.cuda.is_available():
        print("block_span_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    what = set(sys.argv[1:]) or {"f32", "bf16"}
    if "bf16" in what:
        bf16_spans(dev)
    if not what & {"a", "f32"}:
        return 0
    libs = build_all({"span_a": probe_a((build.CSRC / "coo_matmul_T.cu").read_text()),
                      "chain": CHAIN,
                      **({"span_d": probe_d((build.CSRC / "bsmm_dx.cu").read_text())}
                         if "f32" in what else {})})
    stream = torch.cuda.current_stream().cuda_stream
    a_spans(dev, libs, stream)
    if "f32" not in what:
        return 0
    med = lambda v: float(np.median(v))  # noqa: E731
    rng = np.random.default_rng(0)

    model = cs.block_model(dev)
    x_train = cs.load("cifar10", scale=cs.TRAIN_SCALE).x_train
    fd = libs["span_d"].bsmm_dx_f32
    fd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for l, (meta, hst, bt, v, x, dy) in enumerate(cs.block_layer_inputs(model, x_train[:128],
                                                                         rng)):
        if l == 0:
            continue
        batch = x.shape[0]
        row_ptr = tsp.segment_offsets(bt.rows_r, meta.grid_m)
        parts = bsm.dx_parts(hst.n_blocks, meta.grid_m, batch, meta.block_m)
        dx = torch.empty((batch, meta.grid_m * meta.block_m), device=dev)
        part = torch.empty((parts, batch, meta.grid_m * meta.block_m), device=dev)
        call = lambda: fd(dy.data_ptr(), v.data_ptr(), bt.cols_r.data_ptr(),  # noqa: E731
                          bt.perm_r.data_ptr(), row_ptr.data_ptr(), dx.data_ptr(),
                          part.data_ptr(), batch, meta.grid_m, meta.grid_n, meta.block_m,
                          meta.block_n, parts, 0, stream)
        ms = cs.device_ms(call)
        call()
        blocks = meta.grid_m * parts * -(-batch // 64) * -(-meta.block_m // 64)
        c = spans(libs["span_d"], 8 * blocks).reshape(blocks, 8)
        busy = c[c[:, 6] > 0]
        print(json.dumps({"d_spans": dict(
            layer=l, parts=parts, ms=ms, blocks=blocks, busy_blocks=len(busy),
            stages=sorted(set(busy[:, 6].tolist())), block_cycles_med=med(busy[:, 0]),
            block_cycles_max=float(busy[:, 0].max()), row_ptr=med(busy[:, 1]),
            first_stage_issued=med(busy[:, 2]), prologue_issued=med(busy[:, 3]),
            first_compute=med(busy[:, 4]),
            compute_per_stage=med(busy[:, 5] / busy[:, 6]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
