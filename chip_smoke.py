#!/usr/bin/env python3
"""Drive the port's SET-MLP serving path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each (any failure exits non-zero):

1. device   — the card's name, count, and nvidia-smi's name and power limit;
2. build    — every kernel of the path built from ``src/repro_torch/csrc``;
3. kernels  — each kernel against its plain PyTorch version on the card, at
              the full-width SET-MLP's shapes and at the compacted shapes
              the engine serves, on the forward's own activations;
4. main     — ``SparseInferenceEngine.classify`` at full width
              (3072-4000-1000-4000-10, epsilon 20) with deployment-time
              compaction, held against the same model served on the CPU by
              the plain versions, compaction held bit-equal, and the kernels'
              launch counts;
5. timings  — per-bucket classify latency (host clock, ends in a
              synchronise) and per-kernel device time (CUDA events) beside
              its bound, its plain version and one PyTorch library call.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Without a card it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.set_mlp import mlp_config  # noqa: E402
from repro_torch.core import sparsity  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.data.datasets import load  # noqa: E402
from repro_torch.kernels import all_relu_fused, build, ref  # noqa: E402
from repro_torch.models.mlp import SparseMLP  # noqa: E402
from repro_torch.serve import SparseInferenceEngine, importance_prune_mlp  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32
# (non-tensor-core) rate. The bound of a call is the larger of its bytes over
# the first and its operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
RTOL = ATOL = 1e-5  # kernel A sums in another order than index_add_
SIZES = (1, 5, 32, 128, 300)  # 300 is above the largest bucket: chunked
SCHEDULE = PruningSchedule(tau=0, period=1, percentile=30.0)
SEED = 0
REPS = 100

KERNEL_A = dict(
    name="coo_matmul_T", route="cuda", source="src/repro_torch/csrc/coo_matmul_T.cu",
    replaces="src/repro/core/sparsity.py:477",
)
KERNEL_B = dict(
    name="bias_all_relu", route="cuda", source="src/repro_torch/csrc/bias_all_relu.cu",
    replaces="src/repro/kernels/all_relu_fused.py:23",
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def library_ms(fn):
    """Time of the PyTorch library call used as a yardstick, or None where
    this PyTorch build cannot run it on the card (the port never calls it)."""
    try:
        return device_ms(fn)
    except RuntimeError as e:
        print(f"library call unavailable: {e}", file=sys.stderr)
        return None


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls. A
    spin kernel ahead of them holds the stream while the host enqueues, so
    the events time the calls back to back and not the host's launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))  # ~0.2 ms of spinning per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def requests(x_test: np.ndarray, n: int) -> np.ndarray:
    return x_test[np.arange(n) % len(x_test)]


# -- phases -----------------------------------------------------------------


def phase_device(out: dict) -> str:
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    out.update(name=name, count=count)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return f"{name} count={count} ({smi}); torch {torch.__version__} cuda {torch.version.cuda}"


def phase_build(out: dict) -> str:
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    regs = {
        s: ",".join(re.findall(r"Used (\d+) registers", text)) for s, text in logs.items()
    }
    for s in build.KERNEL_SOURCES:
        check(build.library_path(s).exists(), f"{s} did not build")
    return f"{len(build.KERNEL_SOURCES)} sources, nvcc sm_90a, {secs:.2f} s; registers {regs}"


def seeded_model(device: str) -> SparseMLP:
    """The full-width SET-MLP with the seeded topology and init, and biases
    drawn from the same seed: the reference initialises biases to zero,
    which would leave the bias half of kernel B and the output layer's bias
    add unexercised."""
    model = SparseMLP(mlp_config("cifar10"), seed=SEED, device=device)
    rng = np.random.default_rng(SEED)
    model.biases = [
        torch.as_tensor((0.1 * rng.standard_normal(b.shape)).astype(np.float32), device=device)
        for b in model.biases
    ]
    return model


def phase_kernels(out: dict) -> str:
    """Each kernel against its plain version at the uncompacted widths and
    at the compacted ones the engine serves (the tensors phase_timings
    times), on the activations the forward gives each layer."""
    model = seeded_model("cuda")
    # compaction runs on the host at construction and launches no kernel
    engine = SparseInferenceEngine(model, compaction=SCHEDULE)
    served = engine.model
    x_test = load("cifar10", scale=0.01).x_test
    rng = np.random.default_rng(SEED)
    dev = served.device
    err = {(k, m): 0.0 for k in ("coo_matmul_T", "bias_all_relu") for m in ("full", "served")}
    n_checks = 0

    def compare_a(m, which, l, srcT, acc=None):
        nonlocal n_checks
        topo = m.topos[l]
        t = topo.device_arrays(dev)
        seg_ptr = torch.as_tensor(topo.col_ptr(), device=dev)
        got = sparsity.coo_matmul_T(
            srcT, m.values[l], t.rows, t.cols, topo.out_dim, acc=acc, seg_ptr=seg_ptr
        )
        torch.cuda.synchronize()
        want = sparsity.coo_matmul_T_plain(srcT, m.values[l], t.rows, t.cols, topo.out_dim, acc=acc)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        key = ("coo_matmul_T", which)
        err[key] = max(err[key], float((got - want).abs().max()))
        n_checks += 1
        return want

    def compare_b(which, x, b, layer_index):
        nonlocal n_checks
        got = all_relu_fused.bias_all_relu(x, b, alpha=model.config.alpha, layer_index=layer_index)
        torch.cuda.synchronize()
        want = all_relu_fused.bias_all_relu_plain(
            x, b, alpha=model.config.alpha, layer_index=layer_index)
        check(torch.equal(got, want),
              f"kernel B differs from its plain version at {tuple(x.shape)}, layer {layer_index}")
        key = ("bias_all_relu", which)
        err[key] = max(err[key], float((got - want).abs().max()))
        n_checks += 1
        return want

    # each layer's input is the activation the forward gives it, carried
    # from the requests through the plain versions; kernel B sees the
    # (B, N) product and the layer's own (nonzero) bias, as in mlp_forward
    for which, m in (("full", model), ("served", served)):
        for batch in (1, 128):
            srcT = torch.as_tensor(np.ascontiguousarray(requests(x_test, batch).T), device=dev)
            for l in range(m.config.n_layers):
                yT = compare_a(m, which, l, srcT)
                if l < m.config.n_layers - 1:
                    h = compare_b(which, yT.T.contiguous(), m.biases[l], l + 1)
                    srcT = h.T.contiguous()
    topo = served.topos[1]
    srcT = torch.as_tensor(rng.standard_normal((topo.in_dim, 128)).astype(np.float32), device=dev)
    acc = torch.as_tensor(rng.standard_normal((topo.out_dim, 128)).astype(np.float32), device=dev)
    compare_a(served, "served", 1, srcT, acc=acc)
    # no connections at all: the carry-in comes back, or exact zeros
    empty_f = torch.empty((0,), dtype=torch.float32, device=dev)
    empty_i = torch.empty((0,), dtype=torch.int32, device=dev)
    for acc_in in (None, acc):
        got = sparsity.coo_matmul_T(srcT, empty_f, empty_i, empty_i, topo.out_dim, acc=acc_in)
        torch.cuda.synchronize()
        check(torch.equal(got, torch.zeros_like(acc) if acc_in is None else acc),
              "kernel A with nnz == 0 must return the carry-in or zeros")
    # a ragged width takes kernel B's scalar path
    compare_b("full", torch.as_tensor(rng.standard_normal((5, 1001)).astype(np.float32), device=dev),
              torch.as_tensor(rng.standard_normal((1001,)).astype(np.float32), device=dev), 2)

    out.update(model=model, engine=engine, x_test=x_test,
               err={k: err[(k, "served")] for k in ("coo_matmul_T", "bias_all_relu")})
    return (
        f"{n_checks} comparisons at dims {model.config.layer_dims} and served dims "
        f"{served.config.layer_dims}; kernel A max_abs_err {err[('coo_matmul_T', 'full')]:.3g} "
        f"full, {err[('coo_matmul_T', 'served')]:.3g} served (rtol {RTOL}, atol {ATOL}); "
        f"kernel B bit-equal"
    )


def phase_main(out: dict) -> str:
    model, engine, x_test = out["model"], out["engine"], out["x_test"]
    cfg = model.config
    reqs = {n: requests(x_test, n) for n in SIZES}
    sparsity.coo_matmul_T.launches = 0
    all_relu_fused.bias_all_relu.launches = 0
    logits = {n: engine.classify(reqs[n]) for n in SIZES}
    launches = {
        "coo_matmul_T": sparsity.coo_matmul_T.launches,
        "bias_all_relu": all_relu_fused.bias_all_relu.launches,
    }
    cap = engine.cfg.batch_buckets[-1]
    forwards = sum(-(-n // cap) for n in SIZES)
    want = {"coo_matmul_T": forwards * cfg.n_layers,
            "bias_all_relu": forwards * (cfg.n_layers - 1)}
    check(launches == want, f"launch counts {launches}, expected {want}")
    for n in SIZES:
        check(logits[n].shape == (n, cfg.layer_dims[-1]), f"logits shape {logits[n].shape}")
        check(bool(np.isfinite(logits[n]).all()), "non-finite logits")

    # the same model served on the CPU by the plain versions
    cpu_engine = SparseInferenceEngine(seeded_model("cpu"), compaction=SCHEDULE, device="cpu")
    check(cpu_engine.report == engine.report, "compaction differs between card and CPU")
    err = 0.0
    for n in SIZES:
        ref = cpu_engine.classify(reqs[n])
        np.testing.assert_allclose(logits[n], ref, rtol=RTOL, atol=ATOL)
        err = max(err, float(np.abs(logits[n] - ref).max()))

    # lossless compaction: bit-equal to the importance-pruned model served
    # without elimination
    pruned, _ = importance_prune_mlp(model, SCHEDULE)
    pruned_engine = SparseInferenceEngine(pruned, compact=False)
    for n in SIZES:
        check(np.array_equal(pruned_engine.classify(reqs[n]), logits[n]),
              f"compacted logits differ from the pruned model's at n={n}")
    out.update(launches=launches)
    r = engine.report
    return (
        f"classify sizes {SIZES}: dims {r.dims_before} -> {r.dims_after}, params "
        f"{r.params_before} -> {r.params_after}; launches {launches} over {forwards} "
        f"forwards; max |card - cpu plain| {err:.3g}; compaction bit-equal"
    )


def profile_classify(engine, x: np.ndarray, latency_ms: float, calls: int = 20) -> dict:
    """Where one classify call's time goes: device time per kernel or copy
    (torch.profiler, device-side events only), the device's busy time, and
    its idle share of the unprofiled median latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.classify(x)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            engine.classify(x)
        profiled_wall_us = (time.perf_counter() - t0) * 1e6 / calls
    by_name: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key[:200]] = by_name.get(e.key[:200], 0.0) + e.self_device_time_total / calls
    busy_us = sum(by_name.values())
    return dict(batch=len(x), latency_us=latency_ms * 1e3, profiled_wall_us=profiled_wall_us,
                device_busy_us=busy_us, device_idle_share=1.0 - busy_us / (latency_ms * 1e3),
                device_us_by_name=by_name)


def phase_timings(out: dict) -> str:
    engine = out["engine"]
    latency = {}
    for bucket in engine.cfg.batch_buckets:
        x = requests(out["x_test"], bucket)
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
    for bucket in (1, 128):
        print(json.dumps({"classify_profile": profile_classify(
            engine, requests(out["x_test"], bucket), latency[bucket]["median"])}))

    dev = engine.device
    cfg = engine.model.config
    rows = []
    for batch in (1, 128):
        h = torch.as_tensor(requests(out["x_test"], batch), device=dev)
        for l in range(cfg.n_layers):
            vals, bias = engine.model.values[l], engine.model.biases[l]
            host = engine.model.topos[l]
            topo = host.device_arrays(dev)
            seg_ptr = torch.as_tensor(host.col_ptr(), device=dev)
            n_out, nnz = host.out_dim, host.nnz
            srcT = h.T.contiguous()
            csr = torch.sparse_csr_tensor(
                seg_ptr, topo.rows.long(), vals, (n_out, host.in_dim), check_invariants=True
            )
            nbytes = 4 * (srcT.numel() + 2 * nnz + n_out * batch) + 8 * (n_out + 1)
            rows.append(dict(
                kernel="coo_matmul_T", layer=l, batch=batch, shape=[host.in_dim, n_out],
                nnz=nnz,
                ms=device_ms(lambda: sparsity.coo_matmul_T(
                    srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr)),
                plain_ms=device_ms(lambda: sparsity.coo_matmul_T_plain(
                    srcT, vals, topo.rows, topo.cols, n_out)),
                library_ms=library_ms(lambda: torch.sparse.mm(csr, srcT)),
                **bound(nbytes, 2 * nnz * batch),
            ))
            y = sparsity.coo_matmul_T(srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr)
            y = y.T.contiguous()
            if l == cfg.n_layers - 1:
                break
            slope = ref.slope_for(cfg.alpha, l + 1)
            weight = torch.tensor([slope], device=dev)
            rows.append(dict(
                kernel="bias_all_relu", layer=l, batch=batch, shape=list(y.shape),
                ms=device_ms(lambda: all_relu_fused.bias_all_relu(
                    y, bias, alpha=cfg.alpha, layer_index=l + 1)),
                plain_ms=device_ms(lambda: all_relu_fused.bias_all_relu_plain(
                    y, bias, alpha=cfg.alpha, layer_index=l + 1)),
                library_ms=library_ms(lambda: F.prelu(y + bias, weight)),
                **bound(4 * (2 * y.numel() + n_out), 3 * y.numel()),
            ))
            h = all_relu_fused.bias_all_relu(y, bias, alpha=cfg.alpha, layer_index=l + 1)
    for r in rows:
        print(json.dumps({"kernel_timing": r}))

    kernels = []
    for meta in (KERNEL_A, KERNEL_B):
        # one classify call at the largest bucket: the sum over its launches
        mine = [r for r in rows if r["kernel"] == meta["name"] and r["batch"] == 128]
        total = {k: sum(r[k] for r in mine) for k in ("ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in mine]
        kernels.append(dict(
            meta, launches=out["launches"][meta["name"]], max_abs_err=out["err"][meta["name"]],
            **total,
            bound_by=bound(sum(r["bytes"] for r in mine), sum(r["ops"] for r in mine))["bound_by"],
            library_ms=None if None in lib else sum(lib),
        ))
    out["kernels"] = kernels
    return "classify median ms by bucket " + ", ".join(
        f"{b}: {latency[b]['median']:.3f}" for b in latency
    ) + "; profiles and per-kernel rows above"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 1
    out: dict = {}
    for name, phase in (
        ("device", phase_device), ("build", phase_build), ("kernels", phase_kernels),
        ("main", phase_main), ("timings", phase_timings),
    ):
        t0 = time.perf_counter()
        try:
            line = phase(out)
        except Exception as e:  # report which phase failed, then exit non-zero
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            raise
        print(f"[{name}] {line} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": out["name"], "count": out["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
