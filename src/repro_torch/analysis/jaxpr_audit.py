"""Record-level contract checks: record every aten op one call of a
program dispatches, forward and backward, and verify the registered
contract. Twin of ``repro.analysis.jaxpr_audit``.

The reference walks the jaxpr of its jitted program. PyTorch runs eagerly,
so the port's twin of the trace is the record of one call under a
``TorchDispatchMode``: every aten op, with its inputs' and outputs' type
strings (``hlo_parser.type_str``) and devices. Autograd's backward and
``torch.utils.checkpoint``'s recompute dispatch through the mode too (the
mode follows the call into autograd's device threads), so the record
holds the whole step, as the jaxpr holds the scan body and the custom-VJP
backward. The hand kernels launch through ``ctypes``
(``kernels/build.py``) and leave no op in the record: on the card their
launch counters and the profiler's census stand in for them
(``hlo_audit``); on the CPU the record holds their plain versions.

The checks, with the reference's ids:

* ``forbidden-primitive`` — no forbidden op (the host-sync ops by default,
  ``registry.HOST_SYNC_OPS``), each reported with the program line it
  came from;
* ``unsorted-scatter`` / ``unsorted-scatter-size`` — accumulating
  scatters (``index_add``, ``index_put(accumulate=True)``,
  ``scatter_add``, ``scatter_reduce``, ``index_reduce``) whose index is not
  non-decreasing, at most the declared count per call, and none whose
  result outgrows the per-op bound. The order is read from copies of the
  index tensors AFTER the call, so the check adds no sync inside it;
* ``dense-materialization`` — the largest tensor an op newly allocates
  (an output that shares no input's storage: views and in-place results
  allocate nothing) against the element budget;
* ``f64-drift`` — no float64/complex128 output unless the contract
  allows it.

On the card the program is called once before it is recorded: that call
builds the kernels and makes the one-time checks of a new topology (the
port's compile), which the reference's trace never sees either.
"""
from __future__ import annotations

import dataclasses
import os
import traceback
import weakref
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import hlo_parser
from repro_torch.analysis.registry import DEVICE_TO_HOST, Contract

__all__ = ["Violation", "iter_eqns", "audit_jaxpr", "trace_and_audit"]

# accumulating scatters: several slots may add into one output element
SCATTER_OPS = frozenset({
    "aten.index_add", "aten.index_add_", "aten.index_put", "aten.index_put_",
    "aten._index_put_impl_", "aten._unsafe_index_put", "aten.scatter_add",
    "aten.scatter_add_", "aten.scatter_reduce", "aten.scatter_reduce_",
    "aten.index_reduce", "aten.index_reduce_",
})
_INDEX_PUT = frozenset({"aten.index_put", "aten.index_put_", "aten._index_put_impl_",
                        "aten._unsafe_index_put"})
_HERE = os.path.dirname(os.path.abspath(__file__))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


@dataclasses.dataclass(frozen=True)
class Violation:
    program: str
    check: str       # stable id suffix: "<program>:<check>" keys waivers
    message: str

    @property
    def waiver_id(self) -> str:
        return f"{self.program}:{self.check}"

    def __str__(self) -> str:
        return f"[{self.waiver_id}] {self.message}"


@dataclasses.dataclass
class OpRecord:
    """One dispatched aten op. ``name`` is its overload packet
    (``"aten.index_add"``); ``fresh`` marks the outputs that own new
    storage; ``scatter`` holds, for an accumulating scatter, copies of its
    index tensors and what is needed to read their order; ``site`` is the
    innermost program frame outside torch, kept for forbidden ops."""

    name: str
    inputs: Tuple[str, ...]
    outputs: Tuple[str, ...]
    in_devices: Tuple[str, ...]
    out_devices: Tuple[str, ...]
    fresh: Tuple[bool, ...]
    out_elems: Tuple[int, ...]
    scatter: Optional[Tuple] = None
    site: str = ""
    view: bool = False  # its results alias its inputs (no bytes move)
    attrs: Tuple[str, ...] = ()  # its string arguments (an einsum's equation)

    @property
    def to_host(self) -> bool:
        """A copy of a device tensor to the CPU."""
        return (any(d != "cpu" for d in self.in_devices)
                and any(d == "cpu" for d in self.out_devices))


@dataclasses.dataclass
class ProgramRecord:
    """The record of one call: its ops in dispatch order and, where memory
    was tracked, the peak bytes of the storages the call allocated and
    held at once (inputs excluded)."""

    ops: List[OpRecord]
    peak_bytes: int = 0
    unknown_dtypes: Tuple[str, ...] = ()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts, in order. (No nested
    recursive closure: its reference cycle would keep the tensors alive
    until the garbage collector ran, and the record would count them as
    live.)"""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _storage_key(t: torch.Tensor) -> int:
    if is_fake(t):  # a fake tensor has no storage to tell apart
        return 0
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def _site() -> str:
    """The innermost frame of the program (outside torch and this
    package), as ``path:line in function``."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        path = os.path.abspath(fr.filename)
        if not (path.startswith(_TORCH) or path.startswith(_HERE)):
            return f"{os.path.relpath(path)}:{fr.lineno} in {fr.name}"
    return "?"


def _scatter_info(name: str, args, kwargs, out: torch.Tensor):
    """``(kind, dim, index copies, result shape)`` of an accumulating
    scatter, or None for an ``index_put`` that overwrites."""
    if name in _INDEX_PUT:
        acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
        if not acc:
            return None
        idx = [(d, i.detach().clone()) for d, i in enumerate(args[1]) if i is not None]
        return ("put", None, idx, tuple(out.shape))
    dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
    index = kwargs.get("index", args[2] if len(args) > 2 else None)
    kind = "add" if name.startswith("aten.index_") else "scatter"
    return (kind, dim, [(dim, index.detach().clone())], tuple(out.shape))


def _sorted(info) -> bool:
    """Whether a scatter writes in non-decreasing address order: an
    ``index_add`` whose index is non-decreasing; a ``scatter_add`` whose
    target offsets (the index along ``dim``, the position elsewhere) are
    non-decreasing in the index's row-major order; an accumulating
    ``index_put`` whose broadcast indices' offsets are."""
    kind, dim, idx, shape = info
    if kind == "add":
        flat = idx[0][1].reshape(-1)
        return flat.numel() < 2 or bool((flat[1:] >= flat[:-1]).all())
    strides = torch.ones(len(shape), dtype=torch.int64)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    if kind == "scatter":
        index = idx[0][1].long()
        dim = dim % index.dim()
        off = torch.zeros(index.shape, dtype=torch.int64, device=index.device)
        for d in range(index.dim()):
            coord = index if d == dim else torch.arange(
                index.shape[d], device=index.device).reshape(
                    [-1 if k == d else 1 for k in range(index.dim())])
            off = off + coord * int(strides[d])
    else:
        idx = [(d, i.long()) for d, i in idx]
        parts = torch.broadcast_tensors(*[i for _, i in idx])
        off = sum(p * int(strides[d]) for (d, _), p in zip(idx, parts))
    flat = off.reshape(-1)
    return flat.numel() < 2 or bool((flat[1:] >= flat[:-1]).all())


class _Recorder(TorchDispatchMode):
    """Records every aten op of the region (the program line of those in
    ``forbid``); with ``track_memory`` also the bytes of the storages
    allocated in it and alive at once."""

    def __init__(self, inputs: Sequence[torch.Tensor] = (), track_memory: bool = False,
                 forbid: Sequence[str] = ()):
        super().__init__()
        self.forbid = set(forbid)
        self.ops: List[OpRecord] = []
        self.track_memory = track_memory
        self._inputs = {_storage_key(t) for t in inputs}
        self._live: Dict[int, List[int]] = {}  # storage -> [bytes, live tensors]
        self.cur = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.cur -= entry[0]
            del self._live[key]

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        key = _storage_key(t)
        if not key or key in self._inputs:
            return
        entry = self._live.get(key)
        if entry is None:
            if not fresh:
                return
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.cur += entry[0]
            self.peak = max(self.peak, self.cur)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage_key(t) for t in ins}
        fresh = tuple(_storage_key(t) not in in_keys for t in outs)
        name = str(func.overloadpacket)
        scatter = None
        if name in SCATTER_OPS and outs:
            scatter = _scatter_info(name, args, kwargs, outs[0])
        rec = OpRecord(
            name=name,
            inputs=tuple(hlo_parser.type_str(t) for t in ins),
            outputs=tuple(hlo_parser.type_str(t) for t in outs),
            in_devices=tuple(t.device.type for t in ins),
            out_devices=tuple(t.device.type for t in outs),
            fresh=fresh,
            out_elems=tuple(t.numel() for t in outs),
            scatter=scatter,
            view=bool(getattr(func, "is_view", False)),
            attrs=tuple(a for a in args if isinstance(a, str)),
        )
        if name in self.forbid or (DEVICE_TO_HOST in self.forbid and rec.to_host):
            rec.site = _site()
        self.ops.append(rec)
        if self.track_memory:
            for t, f in zip(outs, fresh):
                self._track(t, f)
        return out


def record_call(fn, args, kwargs=None, *, track_memory: bool = False,
                forbidden: Sequence[str] = ()):
    """``(result, ProgramRecord)`` of one call ``fn(*args, **kwargs)``.
    The ops named in ``forbidden`` get their program line
    (``OpRecord.site``); ``track_memory`` measures ``peak_bytes``."""
    kwargs = kwargs or {}
    rec = _Recorder(_tensors((args, kwargs)), track_memory, forbidden)
    with rec:
        out = fn(*args, **kwargs)
    unknown: set = set()
    for op in rec.ops:
        for s in op.outputs:
            hlo_parser.shape_bytes(s, unknown=unknown)
    return out, ProgramRecord(rec.ops, rec.peak, tuple(sorted(unknown)))


def on_card(tree) -> bool:
    """Whether any tensor of ``tree`` lies on a CUDA device."""
    return any(t.is_cuda for t in _tensors(tree))


def iter_eqns(record: ProgramRecord) -> Iterator[OpRecord]:
    """Every recorded op of the call, in dispatch order (forward, then
    backward, then the update): the record is flat, as the jaxpr is once
    its sub-jaxprs are walked."""
    yield from record.ops


def audit_jaxpr(record: ProgramRecord, contract: Contract, program: str) -> List[Violation]:
    out: List[Violation] = []
    forbidden_hits: Dict[str, List[str]] = {}
    unsorted: List[Tuple[str, int]] = []   # (op, result elems)
    max_inter = 0
    max_inter_op = ""
    f64_hits = []
    forbidden = set(contract.forbidden_primitives)
    for op in iter_eqns(record):
        name = op.name
        hit = name if name in forbidden else (
            DEVICE_TO_HOST if DEVICE_TO_HOST in forbidden and op.to_host else None)
        if hit is not None:
            forbidden_hits.setdefault(hit, []).append(op.site)
        if op.scatter is not None and not _sorted(op.scatter):
            unsorted.append((name, op.out_elems[0] if op.out_elems else 0))
        for elems, fresh in zip(op.out_elems, op.fresh):
            if fresh and elems > max_inter:
                max_inter, max_inter_op = elems, name
        if not contract.allow_f64:
            for s in op.outputs:
                dt = s.split("[", 1)[0]
                if dt in ("float64", "complex128"):
                    f64_hits.append((name, dt))

    if forbidden_hits:
        out.append(Violation(
            program, "forbidden-primitive",
            "forbidden primitive(s) in trace: " + ", ".join(
                f"{k} x{len(v)} (first at {v[0] or '?'})"
                for k, v in sorted(forbidden_hits.items())),
        ))
    if len(unsorted) > contract.max_unsorted_scatter:
        out.append(Violation(
            program, "unsorted-scatter",
            f"{len(unsorted)} unsorted scatter(s) "
            f"(allowed {contract.max_unsorted_scatter}): "
            + ", ".join(f"{p}->{e} elems" for p, e in unsorted),
        ))
    else:
        for op_name, elems in unsorted:
            if elems > contract.max_unsorted_scatter_elems:
                out.append(Violation(
                    program, "unsorted-scatter-size",
                    f"allowed unsorted {op_name} writes {elems} elems "
                    f"(bound {contract.max_unsorted_scatter_elems}) — "
                    "nnz-scale dense scatter in a truly-sparse hot path",
                ))
    if (
        contract.max_intermediate_elems is not None
        and max_inter > contract.max_intermediate_elems
    ):
        out.append(Violation(
            program, "dense-materialization",
            f"intermediate of {max_inter} elems (from {max_inter_op}) "
            f"exceeds the {contract.max_intermediate_elems}-elem budget — "
            "a sparse operand is being materialized densely",
        ))
    if f64_hits:
        ops = sorted({p for p, _ in f64_hits})
        out.append(Violation(
            program, "f64-drift",
            f"f64/c128 values produced by {ops} ({len(f64_hits)} sites) "
            "in an f32 hot path",
        ))
    return out


def trace_and_audit(
    fn, args, contract: Contract, program: str, kwargs: Optional[dict] = None
) -> List[Violation]:
    """Record one call of ``fn`` (after one unrecorded call on the card)
    and audit the record against ``contract``."""
    kwargs = kwargs or {}
    if on_card((args, kwargs)):
        fn(*args, **kwargs)
    _, record = record_call(fn, args, kwargs, forbidden=contract.forbidden_primitives)
    return audit_jaxpr(record, contract, program)
