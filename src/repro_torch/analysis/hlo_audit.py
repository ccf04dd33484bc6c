"""Run-level contract checks: build a registered program, call it, and
verify what the call did, not what the source requested. Twin of
``repro.analysis.hlo_audit``.

* **aliasing** (``donation-aliasing``) — call the program built with the
  contract's ``donate_argnums`` (on copies of the example inputs) and
  require at least ``min_aliased_buffers`` donated input leaves to come
  back as output leaves (``hlo_parser.alias_pairs``, by ``data_ptr``). A
  donation that was dropped returns new tensors and fails here.
* **temp bytes** (``temp-bytes``) — the peak bytes one call allocates
  beyond its inputs, against the contract ceiling: on the card the caching
  allocator's peak (``reset_peak_memory_stats``/``max_memory_allocated``),
  on the CPU the record's live storages (``jaxpr_audit.record_call``).
  The report holds both where both exist.
* **host syncs** (``host-sync``, on the card) — the call runs under
  ``torch.cuda.set_sync_debug_mode``: every operation that makes the host
  wait for the device is a violation, reported with its Python stack.
* **kernel census** (``hlo-scatter``, on the card) — the scatter,
  index-put and atomic kernels in the profiler's capture of one call,
  against ``max_hlo_scatter`` where the contract opts in; reported always.
  The hand kernels' launch counters are read around the call too.
* **a whole census** (``census-incomplete``, on the card) —
  ``torch.profiler`` can lose device events, and a capture that lost them
  would back the scatter check with kernels it never saw: the capture must
  hold as many hand-kernel events as the wrappers counted launches
  (``hlo_parser.hand_kernel_match``). Each capture opens with a burst
  of no-op kernels that takes the profiler's loss, and is retaken with a
  longer burst (:data:`CENSUS_LEADS`) before this fails.
* **unknown dtypes** (``unknown-dtype``) — surfaced from the byte model,
  never silently costed.
"""
from __future__ import annotations

import contextlib
import os
import traceback
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.analysis import hlo_parser
from repro_torch.analysis.jaxpr_audit import Violation, _tensors, on_card, record_call
from repro_torch.analysis.registry import AuditProgram, Contract
from repro_torch.tree import tree_map

__all__ = ["audit_compiled", "compile_program"]


def compile_program(fn, args, kwargs=None):
    """The port builds a program at its first call: on the card this call
    builds the hand kernels (``kernels/build.py``) and makes the one-time
    checks of a new topology. It runs ``fn`` once there and returns it; on
    the CPU nothing is built and it only returns ``fn``."""
    kwargs = kwargs or {}
    if on_card((args, kwargs)):
        fn(*args, **kwargs)
        torch.cuda.synchronize()
    return fn


def _copy(tree):
    """A deep copy of a call's argument: tensors cloned, generators given
    the same state, anything else shared."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x

    return tree_map(leaf, tree)


def launch_counts() -> Dict[str, int]:
    """The hand kernels' launch counters (each wrapper adds one where it
    launches its kernel)."""
    from repro_torch.core import sparsity
    from repro_torch.kernels import all_relu_fused, ops
    from repro_torch.kernels import block_sparse_matmul as bsm

    return {
        "coo_matmul_T": sparsity.coo_matmul_T.launches,
        "coo_matmul_T.epilogue": sparsity.coo_matmul_T.epilogue_launches,
        "coo_dw": sparsity.coo_dw.launches,
        "all_relu_bwd": all_relu_fused.all_relu_bwd.launches,
        "bias_all_relu": all_relu_fused.bias_all_relu.launches,
        "bsmm_fwd": bsm.bsmm_fwd.launches,
        "bsmm_dx": bsm.bsmm_dx.launches,
        "bsmm_dw": bsm.bsmm_dw.launches,
        "xl_shard_acc": ops.xl_shard_acc.launches,
        "xl_shard_dw": ops.xl_shard_dw.launches,
    }


# what ``set_sync_debug_mode("warn")`` says at each operation that makes the
# host wait for the device (c10/cuda's warn_or_error_on_sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def watch_host_syncs(found: List[str]):
    """Run the block under ``set_sync_debug_mode("warn")`` and append the
    Python stack of every host sync it makes to ``found``."""
    torch.cuda.synchronize()
    shown = warnings.showwarning

    def keep(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if os.path.basename(f.filename) != "warnings.py"]
            found.append("".join(traceback.format_list(frames[-10:])))
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # switching the mode on warns once that it is experimental: only
        # what the block does afterwards is watched
        torch.cuda.set_sync_debug_mode("warn")
        warnings.showwarning = keep
        try:
            yield found
        finally:
            warnings.showwarning = shown
            torch.cuda.set_sync_debug_mode(0)


def host_syncs(fn, args, kwargs=None) -> List[str]:
    """The Python stacks of the host syncs one call makes (on the card)."""
    found: List[str] = []
    with watch_host_syncs(found):
        fn(*args, **(kwargs or {}))
    torch.cuda.synchronize()
    return found


def census(fn, args, kwargs=None, lead: int = 0) -> Dict[str, int]:
    """The device events of one call by name, from ``torch.profiler``. With
    ``lead``, the capture opens with that many no-op spin kernels
    (``torch.cuda._sleep``), left out of the census: late in a long process
    the profiler has dropped the first few dozen device events of each
    capture (on the H100, 42 of a capture's first 2,000), and the spins
    take that loss instead of the call's own kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1)
        fn(*args, **(kwargs or {}))
        torch.cuda.synchronize()
    return {k: n for k, n in hlo_parser.kernel_census(prof.events()).items()
            if not hlo_parser.SPIN_KERNEL_RE.search(k)}


# the leading spins of each take of a checked census (:func:`census`)
CENSUS_LEADS: Tuple[int, ...] = (1024, 4096, 16384)


def checked_census(fn, args, kwargs=None) -> dict:
    """:func:`census` of one call, held against the hand kernels' launch
    counters over the same call and retaken, with each lead of
    :data:`CENSUS_LEADS` in turn, while some family's events differ from
    its launches. Returns ``census``, ``launches`` (the counters' nonzero
    deltas), ``hand_kernels`` (``{family: (events, launches)}``),
    ``attempts`` and ``complete``."""
    for attempt, lead in enumerate(CENSUS_LEADS, 1):
        before = launch_counts()
        cen = census(fn, args, kwargs, lead=lead)
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        match = hlo_parser.hand_kernel_match(cen, launched)
        complete = all(seen == n for seen, n in match.values())
        if complete:
            break
    return dict(census=cen, launches=launched, hand_kernels=match, attempts=attempt,
                complete=complete)


def _donated_leaves(args, donate_argnums: Tuple[int, ...]) -> List[torch.Tensor]:
    return [t for i in donate_argnums if i < len(args) for t in _tensors(args[i])
            if t.numel()]


def audit_compiled(
    prog: AuditProgram, contract: Contract, program: str,
    report: Optional[dict] = None,
) -> List[Violation]:
    """Run the checks; ``report`` (a dict, if given) receives the
    measurements: ``temp_bytes`` (and ``temp_bytes_record`` on the card),
    ``launches``, ``host_syncs``, ``census``, ``census_hand_kernels``,
    ``census_attempts``, ``scatter_kernels``, ``alias_pairs``."""
    out: List[Violation] = []
    report = {} if report is None else report
    args, kwargs = prog.args, prog.kwargs
    card = on_card((args, kwargs))

    # -- plain build: temp bytes, host syncs, census ------------------------
    fn = compile_program(prog.make(()), args, kwargs)
    _, record = record_call(fn, args, kwargs, track_memory=True)
    temp = record.peak_bytes
    if card:
        report["temp_bytes_record"] = temp
        found: List[str] = []
        before = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with watch_host_syncs(found):
            result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - base
        del result
        report["launches"] = {k: v - before[k] for k, v in launch_counts().items()
                              if v != before[k]}
        report["host_syncs"] = found
        if found:
            out.append(Violation(
                program, "host-sync",
                f"{len(found)} host sync(s) in one call; the first at:\n{found[0]}",
            ))
        taken = checked_census(fn, args, kwargs)
        cen = taken["census"]
        report["census"] = cen
        report["census_hand_kernels"] = taken["hand_kernels"]
        report["census_attempts"] = taken["attempts"]
        if not taken["complete"]:
            out.append(Violation(
                program, "census-incomplete",
                f"the profiler's capture lost device events in each of "
                f"{taken['attempts']} takes: hand-kernel (events, launches) "
                f"{taken['hand_kernels']}",
            ))
        scat = hlo_parser.scatter_kernels(cen)
        report["scatter_kernels"] = scat
        n_scatter = sum(scat.values())
        if contract.max_hlo_scatter is not None and n_scatter > contract.max_hlo_scatter:
            out.append(Violation(
                program, "hlo-scatter",
                f"{n_scatter} scatter/atomic kernel launch(es) in one call "
                f"(allowed {contract.max_hlo_scatter}): {scat}",
            ))
    report["temp_bytes"] = temp
    if contract.max_temp_bytes is not None and temp > contract.max_temp_bytes:
        out.append(Violation(
            program, "temp-bytes",
            f"one call allocates {temp} B at its peak beyond its inputs, over "
            f"the contract ceiling {contract.max_temp_bytes} B",
        ))
    if record.unknown_dtypes:
        out.append(Violation(
            program, "unknown-dtype",
            f"the program makes dtypes the byte model does not know: "
            f"{sorted(record.unknown_dtypes)}",
        ))

    # -- donated build: did the call hand the donated buffers back? --------
    if contract.donate_argnums:
        floor: Optional[int] = contract.min_aliased_buffers
        # the donated positions are copied (the call may write them); the
        # rest, the topology arrays among them, are the program's own
        dargs = tuple(_copy(a) if i in contract.donate_argnums else a
                      for i, a in enumerate(args))
        donated = _donated_leaves(dargs, contract.donate_argnums)
        if floor is None:
            floor = len(donated)
        result = prog.make(contract.donate_argnums)(*dargs, **kwargs)
        pairs = hlo_parser.alias_pairs(_tensors(dargs), _tensors(result))
        ids = {id(t) for t in donated}
        flat = _tensors(dargs)
        n_alias = len({p for _, p in pairs if id(flat[p]) in ids})
        report["alias_pairs"] = pairs
        if n_alias < floor:
            out.append(Violation(
                program, "donation-aliasing",
                f"donated build handed back {n_alias} buffer(s), contract "
                f"requires >= {floor} (donate_argnums="
                f"{contract.donate_argnums}) — donation was dropped",
            ))
    return out
