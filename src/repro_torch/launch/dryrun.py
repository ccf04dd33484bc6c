"""The dry run: every (arch x shape x mesh) cell's step, per rank, at the
production mesh, without a device. Twin of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape all --both-meshes

The reference lowers and compiles each cell's jitted step for 256 (512)
host devices and reads XLA's memory and cost analyses. The port compiles
nothing: it runs the cell's step once, eagerly, as rank 0 of a fake
process group of 256 (512) ranks (``torch.distributed``'s ``"fake"``
backend: collectives return tensors of the right shape and move nothing)
under ``FakeTensorMode`` (tensors carry shape and dtype, no storage). The
parameters (and, for ``train``, the velocity) are DTensors on the
production mesh in the reference's shape-aware shardings of
``model.specs``, built from local shards of the rank's shape; the inputs
are the rank's shards of ``launch.specs.input_specs``, gathered over every
axis but the batch's before the step reads them (the model axis splits
storage, not compute: a cache sharded over heads is read whole). The step is the
sharded driver's (``launch.train.make_sharded_train_step``) for ``train``;
``prefill`` and ``decode`` gather the parameters the same way and run
``launch.steps``' steps on the rank's batch.

A cell's record has the reference's keys where the port can measure them:

  * ``argument_size_in_bytes``, ``output_size_in_bytes``: the rank's local
    shards of the step's arguments and results (a decode step's caches in
    their storage layout);
  * ``temp_size_in_bytes``: ``MemTracker``'s peak over the call, less the
    arguments;
  * ``flops``: the rank's, from ``launch.hlo_analysis`` over the call's op
    record (forward, backward and recomputation, every loop iteration);
    ``hbm_bytes`` beside it;
  * ``collectives``: ``CommDebugMode``'s counts by kind, and the bytes by
    kind from the op record;
  * ``analytic`` (``launch.analytic.model_flops``), ``lower_seconds``.

Each cell runs in a process of its own (its own fake world), as many at
once as the process may use CPU cores, and the cells print in order as
they finish.

Absent, never zero, because nothing compiles: ``compile_seconds``,
``generated_code_size_in_bytes``, ``alias_size_in_bytes`` (nothing is
donated) and ``bytes_accessed``/``hlo_corrected`` (XLA's own analyses; the
op record's ``hbm_bytes`` is the port's count). The registry's archs carry
no sparse FFN, so no hand kernel runs here; a fake tensor would take a
wrapper's plain version (``repro_torch.device.takes_plain``). Records go to
``experiments/dryrun_torch/``; a failing cell is reported and the run
exits 1, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import warnings
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.launch import analytic
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.axes import logical_axis_rules
from repro_torch.launch.hlo_analysis import analyze_module
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import default_rules, shape_aware_shardings
from repro_torch.launch.train import gather_tree, make_sharded_train_step
from repro_torch.models.transformer import PatternLM
from repro_torch.models.whisper import WhisperConfig, WhisperModel
from repro_torch.optim.sgd import SGDState
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["TRAIN_MICROBATCHES", "build_model", "lower_cell", "main", "save_record"]

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

_KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all", "broadcast")


def build_model(spec, *, abstract=True, overrides=None):
    cfg = spec.config
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if isinstance(cfg, WhisperConfig):
        return WhisperModel(cfg, seed=0, abstract=abstract, device="cpu")
    return PatternLM(cfg, seed=0, abstract=abstract, device="cpu")


# per-arch microbatch counts for the train_4k cell (activation-memory fit;
# gradient accumulation semantics), the reference's
TRAIN_MICROBATCHES = {
    "qwen3-moe-30b-a3b": 4,
    "mixtral-8x22b": 8,
    "gemma3-27b": 4,
    "gemma2-2b": 2,
    "paligemma-3b": 2,
    "internlm2-1.8b": 2,
    "recurrentgemma-2b": 2,
}


def _fake_world(size: int) -> None:
    """Make the default process group a fake one of ``size`` ranks (this
    process is rank 0)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _nbytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _kind(op_name: str) -> str:
    name = op_name.rsplit(".", 1)[-1].replace("allgather", "all_gather").replace(
        "allreduce", "all_reduce")
    return next((k for k in _KINDS if name.startswith(k)), name)


def _local_fake(layouts, shapes):
    """Fake local shards (inside ``FakeTensorMode``) of ``shapes`` (meta
    tensors) under ``layouts``."""
    return tree_map(lambda lay, m: torch.empty(lay.local_shape(m.shape), dtype=m.dtype),
                    layouts, shapes)


def _dtensors(layouts, shapes, locals_):
    return tree_map(lambda lay, m, t: lay.from_local(t, m.shape), layouts, shapes, locals_)


def _compute_layouts(rules, logical, layouts):
    """Where a rank computes each input: its batch slice (the ``batch``
    dim's split kept), every other dim whole. The model axis splits
    storage, not compute, so a cache sharded over heads or sequence is
    gathered over those axes before the step reads it."""
    from repro_torch.launch.sharding import Layout, is_spec_leaf

    def one(names, lay):
        names = tuple(names or ()) + (None,) * (len(lay.spec) - len(names or ()))
        return Layout(lay.mesh, tuple(ax if name == "batch" else None
                                      for name, ax in zip(names, lay.spec)))

    return tree_map(one, logical, layouts, is_leaf=is_spec_leaf)


def _to_compute(layouts, tree):
    """The plain local tensors of the DTensors ``tree`` in ``layouts``."""
    def one(lay, t):
        if tuple(t.placements) != lay.placements:
            t = t.redistribute(lay.mesh, lay.placements)
        return t.to_local()

    return tree_map(one, layouts, tree)


def lower_cell(arch: str, shape_id: str, *, multi_pod: bool = False,
               overrides: dict | None = None, fsdp: bool = True, verbose: bool = True,
               microbatches: int | None = None):
    """Run one (arch x shape x mesh) cell's step as rank 0 of the fake
    world; return the record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.analysis.jaxpr_audit import record_call

    spec = configs.get_spec(arch)
    if spec.shapes.get(shape_id) is not True:
        return {"arch": arch, "shape": shape_id,
                "skipped": spec.shapes.get(shape_id, "unknown shape")}
    t0 = time.time()
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    if getattr(spec.config, "n_experts", 0):
        dp = 32 if multi_pod else 16
        overrides = {"moe_groups": dp, **(overrides or {})}
    model = build_model(spec, abstract=True, overrides=overrides)
    cfg = model.cfg
    kind = configs.SHAPES[shape_id]["kind"]
    B = configs.SHAPES[shape_id]["global_batch"]
    rules = default_rules(mesh, n_experts=getattr(cfg, "n_experts", 0), batch_size=B,
                          fsdp=fsdp)
    inputs, logical = specs_mod.input_specs(spec, shape_id, model)
    in_sh = shape_aware_shardings(rules, logical, inputs)
    param_sh = shape_aware_shardings(rules, model.specs, model.params)
    is_whisper = isinstance(cfg, WhisperConfig)
    if kind == "train" and microbatches is None:
        microbatches = TRAIN_MICROBATCHES.get(arch, 1)

    with warnings.catch_warnings(), FakeTensorMode(allow_non_fake_inputs=True):
        warnings.simplefilter("ignore")
        topo = None if is_whisper else model.topo_arrays()
        params = _dtensors(param_sh, model.params, _local_fake(param_sh, model.params))
        batch = _dtensors(in_sh, inputs, _local_fake(in_sh, inputs))
        compute_sh = _compute_layouts(rules, logical, in_sh)
        if kind == "train":
            sharded_step, _ = make_sharded_train_step(model, mesh, param_sh, lr=1e-2,
                                                      microbatches=microbatches)

            def step_fn(p, opt_state, b, *topo_arg):
                return sharded_step(p, opt_state, _to_compute(compute_sh, b), *topo_arg)

            vel_meta = tree_map(lambda m: torch.empty(m.shape, dtype=torch.float32,
                                                      device="meta"), model.params)
            velocity = _dtensors(param_sh, vel_meta, _local_fake(param_sh, vel_meta))
            opt_state = SGDState(velocity, torch.zeros((), dtype=torch.int32))
            args = (params, opt_state, batch) + (() if is_whisper else (topo,))
        else:
            inner = (steps_mod.make_prefill_step(model) if kind == "prefill"
                     else steps_mod.make_decode_step(model))

            def step_fn(p, b, *topo_arg):
                return inner(gather_tree(p), _to_compute(compute_sh, b), *topo_arg)

            args = (params, batch) + (() if is_whisper else (topo,))
        arg_bytes = _nbytes(args)
        mt = MemTracker()
        mt.track_external(*[t.to_local() if hasattr(t, "to_local") else t
                            for t in tree_leaves(args) if isinstance(t, torch.Tensor)])
        comm = CommDebugMode()
        with logical_axis_rules(rules), mt, comm:
            out, record = record_call(step_fn, args)
        peak = max((snap.get("Total", 0) for snap in mt.get_tracker_snapshot("peak").values()),
                   default=0)
        # a decode step's caches go back to the rank's shards: counted in
        # their storage layout, as the reference's out_shardings keep them
        out_bytes = (_nbytes(out[0]) + _nbytes(batch["caches"]) if kind == "decode"
                     else _nbytes(out))
    cost = analyze_module(record)
    coll_bytes = {}
    for op in record.ops:
        if op.name.startswith(("c10d", "_c10d_functional")) and "wait" not in op.name:
            k = _kind(op.name)
            one = analyze_module(dataclasses.replace(record, ops=[op]))["collective_bytes"]
            coll_bytes[k] = coll_bytes.get(k, 0.0) + one
    counts = {}
    for op, n in comm.get_comm_counts().items():
        k = _kind(str(op))
        counts[k] = counts.get(k, 0) + int(n)
    record_out = {
        "arch": arch,
        "shape": shape_id,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "kind": kind,
        "overrides": overrides or {},
        "microbatches": microbatches if kind == "train" else None,
        "fsdp": fsdp,
        "argument_size_in_bytes": int(arg_bytes),
        "output_size_in_bytes": int(out_bytes),
        "temp_size_in_bytes": int(max(0, peak - arg_bytes)),
        "flops": float(cost["flops"]),
        "hbm_bytes": float(cost["hbm_bytes"]),
        "collectives": {"per_chip_bytes": float(cost["collective_bytes"]),
                        "by_kind": coll_bytes, "counts": counts},
        "analytic": analytic.model_flops(spec, shape_id),
        "lower_seconds": round(time.time() - t0, 2),
    }
    if "unknown_dtypes" in cost:
        record_out["unknown_dtypes"] = cost["unknown_dtypes"]
    if verbose:
        print(_summary(record_out))
    return record_out


def save_record(record: dict, tag: str = "") -> Path:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    mesh = record.get("mesh", "na").replace("x", "_")
    name = f"{record['arch']}__{record['shape']}__{mesh}{tag}.json"
    path = ART_DIR / name
    path.write_text(json.dumps(record, indent=2))
    return path


def _summary(rec: dict) -> str:
    """The cell's lines of the run's output."""
    if "skipped" in rec:
        return f"  SKIP: {rec['skipped']}"
    # the model axis splits storage, not compute: a rank runs its batch
    # slice through the whole model, the analytic total over dp
    dp = 32 if rec["mesh"] == "2x16x16" else 16
    return (f"  bytes/rank: args={rec['argument_size_in_bytes']:.3e} "
            f"out={rec['output_size_in_bytes']:.3e} temp={rec['temp_size_in_bytes']:.3e}\n"
            f"  flops/rank={rec['flops']:.3e} analytic/dp="
            f"{rec['analytic']['model_flops'] / dp:.3e} "
            f"coll={rec['collectives']['per_chip_bytes']:.3e}B {rec['collectives']['counts']} "
            f"({rec['lower_seconds']} s)")


def _cell_job(arch: str, shape_id: str, multi_pod: bool, fsdp: bool, tag: str):
    """One cell in a worker process (its own fake world): ``(summary,
    None)``, or ``(None, error)``."""
    try:
        rec = lower_cell(arch, shape_id, multi_pod=multi_pod, fsdp=fsdp, verbose=False)
        save_record(rec, tag)
        return _summary(rec), None
    except Exception as e:  # noqa: BLE001 - report and continue
        return None, repr(e)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    shape_ids = list(configs.SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(arch, shape_id, mp) for arch in archs for shape_id in shape_ids for mp in meshes
             if configs.get_spec(arch).shapes.get(shape_id) is True]
    for arch in archs:
        for shape_id in shape_ids:
            why = configs.get_spec(arch).shapes.get(shape_id, "unknown shape")
            if why is not True:
                for mp in meshes:
                    mesh = "2x16x16" if mp else "16x16"
                    print(f"[dryrun] {arch} x {shape_id} x {mesh}\n  SKIP: {why}", flush=True)
                    save_record({"arch": arch, "shape": shape_id, "mesh": mesh, "skipped": why},
                                args.tag)

    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun as this  # the workers import it by this name

    failures = []
    jobs = max(1, min(len(os.sched_getaffinity(0)), len(cells)))
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [(f"{arch} x {shape_id} x {'2x16x16' if mp else '16x16'}",
                    pool.submit(this._cell_job, arch, shape_id, mp, not args.no_fsdp, args.tag))
                   for arch, shape_id, mp in cells]
        for label, fut in futures:
            summary, err = fut.result()
            print(f"[dryrun] {label}", flush=True)
            if err is None:
                print(summary, flush=True)
            else:
                failures.append((label, err))
                print(f"  FAIL: {err}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        raise SystemExit(1)
    print("\nall dry-run cells passed")


if __name__ == "__main__":
    main()
