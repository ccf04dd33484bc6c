"""The general part of the benchmark: finding a cell's files by name, the
set-up clock, the measured window, the traced sub-window and its reading,
the comparison's verdict and the result line.

A runner (``runners/<runner>.py``) knows one kind of program path. Its
``build(ctx)`` makes the cell's inputs from the seed, builds the program,
drives it through its first steps (kept for the comparison) and warms up
every shape the window uses; it returns an object with

* ``measure(seconds, sub) -> {"work", "attempted", "t_start", "t_end"}``:
  the window, whole units of work (an epoch, a step) for ``seconds`` on the
  host's clock ending in a synchronise, its first unit(s) inside
  ``sub.begin()``/``sub.end()`` (the profiled stretch of a traced run); set-up
  ends where the window starts;
* ``steps_per_unit``: training steps in a unit;
* ``rate_metric``: the end-to-end rate this cell reports;
* ``info``: shapes and counts the per-layer readers need;
* ``check() -> [(name, value, limit)]``: after the window, frees the
  program's state and compares what the timed path produced (its first
  steps, its evaluation, its feed) with the plain reference.

Per-layer metrics are read by ``metrics/<name>.py`` (``read(trace) ->
float | None``) from a :class:`TraceReading`.
"""
from __future__ import annotations

import argparse
import importlib.util
import io
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package (compared whole: ``repro_torch`` is the
# port, ``repro`` the JAX package)
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")
# a late profiler capture drops its first device events: the capture opens
# with this many spin kernels, left out of every figure
PROFILE_LEAD_SPINS = 1024


def process_start_perf() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (both clocks are CLOCK_MONOTONIC on Linux; /proc gives the start in
    clock ticks since boot)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import a file by path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (default: what
    ``sys.modules`` holds)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules if names is None else names)}
    return sorted(tops.intersection(BANNED_MODULES))


class Cell:
    """A cell of ``BENCHMARK.json`` with every file it names, resolved."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root
        bench_dir = root / "bench"
        self.benchmark = load_json(root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.benchmark["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[name]
        self.name = name
        self.workload = load_json(bench_dir / "workloads" / f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if self.workload[key] != self.entry[key]:
                raise ValueError(f"workloads/{name}.json's {key} disagrees with BENCHMARK.json")
        configs = {c["name"]: c for c in self.benchmark["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(bench_dir / "traffic" / f"{self.entry['traffic']}.json")
        self.runner_path = bench_dir / "runners" / f"{self.workload['runner']}.py"
        self.generator_path = bench_dir / "traffic" / f"{self.traffic['generator']}.py"
        self.end_to_end = [m for m in self.benchmark["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.benchmark["per_layer"]
                          if name in m.get("workloads", [name])]
        self.metric_paths = {m["name"]: bench_dir / "metrics" / f"{m['name']}.py"
                             for m in self.per_layer}
        self.limits: Dict[str, float] = dict(self.workload["limits"])

    def runner(self):
        return load_module(self.runner_path, f"bench_runner_{self.workload['runner']}")

    def generator(self):
        return load_module(self.generator_path, f"bench_traffic_{self.traffic['generator']}")


class Context:
    """What a runner is given: the cell, the seed, the device and whether
    this is a CPU dry run at a toy size (``toy``; tests only)."""

    def __init__(self, cell: Cell, seed: int, device, toy: bool = False):
        self.cell = cell
        self.seed = int(seed)
        self.device = device
        self.toy = toy

    def note(self, msg: str) -> None:
        print(f"[bench] {msg}", file=sys.stderr, flush=True)


# -- the traced sub-window ------------------------------------------------------


class TraceReading:
    """What the traced run read: the device's activity in the profiled
    sub-window (kernels and copies, each ``(name, start_s, dur_s)`` on the
    host's perf_counter clock where the capture's clock was found), the
    sub-window's wall seconds and its units and steps, the port's spans over
    the whole window, and the runner's ``info``."""

    def __init__(self, device_ops, window_s, units, steps, spans, info, aligned, t0):
        self.device_ops: List[Tuple[str, float, float]] = device_ops
        self.window_s: float = window_s
        self.units: int = units
        self.steps: int = steps
        self.spans: List[Dict[str, Any]] = spans
        self.info: Dict[str, Any] = info
        self.aligned = aligned
        self.t0 = t0

    def kernel_seconds(self, pattern: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name matches."""
        import re

        rx = re.compile(pattern)
        secs, n = 0.0, 0
        for name, _, dur in self.device_ops:
            if rx.search(name):
                secs += dur
                n += 1
        return secs, n

    @property
    def busy_s(self) -> float:
        """The union of the device's intervals in the sub-window."""
        ivs = sorted((s, s + d) for _, s, d in self.device_ops)
        busy, end = 0.0, -math.inf
        for s, e in ivs:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of each gap between the device's intervals,
        from the sub-window's start to its end."""
        ivs = sorted((s, s + d) for _, s, d in self.device_ops)
        gaps, end = [], self.t0
        for s, e in ivs:
            if s > end:
                gaps.append((end, s - end))
            end = max(end, e)
        if self.t0 + self.window_s > end:
            gaps.append((end, self.t0 + self.window_s - end))
        return gaps

    def span_at(self, t: float) -> str:
        """The innermost port span open on the host at ``t``, else
        ``bench``."""
        best, best_len = "bench", math.inf
        for sp in self.spans:
            if sp["t0"] <= t < sp["t1"] and sp["t1"] - sp["t0"] < best_len:
                best, best_len = sp["name"], sp["t1"] - sp["t0"]
        return best


class SubWindow:
    """The profiled stretch of a traced run's window: ``begin()`` and
    ``end(units, steps)`` around whole units. Device activity only: a
    capture of the host's events of thousands of launches takes long to
    read and slows the host it records. The capture opens with spin
    kernels (left out) and ends in a synchronise. Disabled (untraced runs,
    the CPU), both calls do nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None

    def begin(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._wall0, self._mono0 = time.time_ns(), time.monotonic_ns()
        for _ in range(PROFILE_LEAD_SPINS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def end(self, units: int, steps: int) -> None:
        """Close the stretch: synchronise and stop the capture. Its events
        are read after the window (:meth:`read`), not inside it."""
        if not self.enabled or self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()
        self._units, self._steps = units, steps

    def read(self) -> Optional[TraceReading]:
        """The stretch's :class:`TraceReading` (None where none was taken)."""
        if self._prof is None or not hasattr(self, "_t1"):
            return None
        from torch.autograd import DeviceType

        start_ns = self._prof.profiler.kineto_results.trace_start_ns()
        # the capture's timestamps: CLOCK_MONOTONIC (perf_counter's) or the
        # wall clock; take the one its start lies next to
        if abs(start_ns - self._mono0) < abs(start_ns - self._wall0):
            offset, aligned = 0.0, abs(start_ns - self._mono0) < 5e9
        else:
            offset, aligned = (self._mono0 - self._wall0) * 1e-9, abs(start_ns - self._wall0) < 5e9
        ops = []
        for e in self._prof.events():
            if e.device_type != DeviceType.CUDA or "spin_kernel" in e.name:
                continue
            start = (start_ns + e.time_range.start * 1e3) * 1e-9 + offset
            dur = (e.time_range.end - e.time_range.start) * 1e-6
            ops.append((e.name, start, dur))
        return TraceReading(ops, self._t1 - self._t0, self._units, self._steps, [], {},
                            aligned, self._t0)


# -- the run ----------------------------------------------------------------------


def device_info(torch, chips: int) -> Dict[str, Any]:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def breakdown(tr: TraceReading) -> Dict[str, List]:
    by_name: Dict[str, float] = {}
    for name, _, dur in tr.device_ops:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(tr.idle_gaps(), key=lambda g: -g[1])[:10]
    label = (lambda t: tr.span_at(t)) if tr.aligned else (lambda t: "bench (clock unmatched)")
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(t), g] for t, g in gaps]}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device=None,
             toy: bool = False, root: Path = ROOT, t_proc: Optional[float] = None
             ) -> Dict[str, Any]:
    """Set up, warm up, measure for ``seconds``, read the trace where asked,
    compare with the reference, and return the result line's object. On
    the CPU (``toy``, tests only) no device metric is written."""
    import torch

    t_proc = time.perf_counter() if t_proc is None else t_proc
    cell = Cell(name, root)
    if device is None:
        device = torch.device("cuda", 0)
    ctx = Context(cell, seed, device, toy=toy)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    program = cell.runner().build(ctx)

    sub = SubWindow(trace and on_card)
    tracer_cm = None
    if trace:
        from repro_torch import obs

        tracer_cm = obs.trace_to(io.StringIO())
        tracer = tracer_cm.__enter__()
    failed = 0
    try:
        w = program.measure(seconds, sub)
    except RuntimeError as e:  # a step that raised: counted, and the run is not correct
        ctx.note(f"the window raised: {e!r}")
        now = time.perf_counter()
        w = {"work": 0, "attempted": program.steps_per_unit, "t_start": now, "t_end": now}
        failed = program.steps_per_unit
    setup_s = w["t_start"] - t_proc
    window_s = w["t_end"] - w["t_start"]
    work, attempted = w["work"], w["attempted"]
    tr = sub.read()
    if tracer_cm is not None:
        spans = [e for e in list(tracer._buf) if e.get("ev") == "span"]
        tracer_cm.__exit__(None, None, None)
        if tr is not None:
            tr.spans = spans

    metrics: Dict[str, Any] = {}
    dev: Dict[str, Any]
    brk = None
    if on_card:
        dev = device_info(torch, int(cell.entry["chips"]))
        if not trace:
            units = {m["name"]: m["unit"] for m in cell.end_to_end}
            metrics[program.rate_metric] = {"value": work / window_s,
                                            "unit": units[program.rate_metric]}
            metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
        elif tr is not None:
            tr.info = dict(program.info)
            for m in cell.per_layer:
                reader = load_module(cell.metric_paths[m["name"]],
                                     "bench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(tr)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            brk = breakdown(tr)
    else:
        dev = {"platform": device.type, "kind": "cpu dry run", "count": 1,
               "memory_peak_bytes": 0}

    checks = program.check()
    result: Dict[str, Any] = {
        "correct": False, "attempted": attempted, "failed": failed,
        "metrics": metrics, "device": dev,
    }
    if brk is not None:
        result["breakdown"] = brk
    ok = failed == 0 and attempted > 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["correct"] = bool(ok)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    result["window_s"] = window_s
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    t_proc = process_start_perf()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # caches inside the checkout, at fixed paths: the kernels build into
    # build/kernels (kernels/build.py); nothing else of the port compiles
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT / "src"))

    import torch

    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s) and finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the program (src/repro_torch) is not in this checkout: {e}",
              file=sys.stderr)
        return 2

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_proc=t_proc)
    found = banned_modules()
    if found:
        print(f"bench: the process loaded {found}; the benchmark runs without JAX and "
              "without the JAX package", file=sys.stderr)
        return 3
    window_s = result.pop("window_s")
    print(f"bench: window {window_s!r} s, correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
