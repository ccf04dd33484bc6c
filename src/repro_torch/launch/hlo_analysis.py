"""The cost model of one eager call. Twin of ``repro.launch.hlo_analysis``.

The reference re-derives per-chip FLOPs and HBM traffic from a compiled
HLO module, with while-loop bodies multiplied by their trip counts
(``compiled.cost_analysis()`` counts a body once). The port compiles no
HLO: its twin of a module is :class:`HloModule`, the record of every aten
op that one call dispatches, taken by the contract auditor's recorder
(``analysis.jaxpr_audit.record_call``), so the backward and the
recomputation of checkpointed blocks are in it. An eager record holds
every iteration of a Python loop, so the reference's trip-count
correction is built in. The cost model is the reference's:

  * FLOPs: every ``mm``/``bmm``/``addmm``/``baddbmm``/``mv``/``dot``,
    ``matmul``/``einsum``/``linear`` (dispatched whole under
    ``inference_mode``) and convolution is 2 * prod(lhs dims) * prod(rhs
    free dims) (the rhs dims that are neither contracted nor batch; a
    convolution's weight keeps its output channels).
  * HBM bytes: every op's operands plus its result. Views move no bytes
    and are skipped.
  * Collective bytes: every ``c10d`` op (functional or not; ``wait_tensor``
    skipped), max(in, out), twice for an all-reduce.

Unknown dtypes are never silently costed: they come back under
``unknown_dtypes``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis import hlo_parser
from repro_torch.analysis.jaxpr_audit import ProgramRecord, record_call

__all__ = ["HloModule", "analyze_hlo", "analyze_module"]

#: the op record of one call (``analysis.jaxpr_audit.ProgramRecord``)
HloModule = ProgramRecord

# aten op -> (lhs operand, rhs operand, rhs batch dims, rhs contracting dims)
_DOTS = {
    "aten.mm": (0, 1, (), (0,)),
    "aten.addmm": (1, 2, (), (0,)),
    "aten.bmm": (0, 1, (0,), (1,)),
    "aten.baddbmm": (1, 2, (0,), (1,)),
    "aten.mv": (0, 1, (), (0,)),
    "aten.dot": (0, 1, (), (0,)),
}
_CONV = ("aten.convolution", "aten.convolution_backward", "aten._convolution")
_COLLECTIVE = ("c10d.", "_c10d_functional.", "c10d_functional.")


def _dims(type_str: str) -> List[int]:
    parts = hlo_parser.shape_dims(type_str)
    return parts[0][1] if parts else []


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _einsum_flops(equation: str, inputs) -> float:
    """2 x the product of every index's size (two operands: the lhs dims
    times the rhs free dims)."""
    sizes = {}
    for spec, t in zip(equation.split("->")[0].split(","), inputs):
        for ch, n in zip(spec.strip(), _dims(t)):
            sizes[ch] = n
    return 2.0 * _prod(sizes.values()) if len(inputs) >= 2 else 0.0


def _dot_flops(name: str, inputs, attrs=()) -> float:
    if name == "aten.einsum" and attrs:
        return _einsum_flops(attrs[0], inputs)
    if name in ("aten.matmul", "aten.linear") and len(inputs) >= 2:
        lhs, rhs = _dims(inputs[0]), _dims(inputs[1])
        if name == "aten.linear":  # x @ W.T, W (out, in)
            return 2.0 * _prod(lhs) * (rhs[0] if len(rhs) == 2 else 1)
        return 2.0 * _prod(lhs) * (rhs[-1] if len(rhs) >= 2 else 1)
    if name in _DOTS:
        li, ri, batch, contract = _DOTS[name]
        if len(inputs) <= ri:
            return 0.0
        lhs, rhs = _dims(inputs[li]), _dims(inputs[ri])
        free = [d for i, d in enumerate(rhs) if i not in batch and i not in contract]
        return 2.0 * _prod(lhs) * _prod(free)
    if name in _CONV and not name.endswith("_backward") and len(inputs) >= 2:
        lhs, rhs = _dims(inputs[0]), _dims(inputs[1])
        return 2.0 * _prod(lhs) * (rhs[0] if rhs else 1)
    return 0.0


def analyze_module(module: HloModule) -> Dict[str, object]:
    flops = 0.0
    hbm_bytes = 0.0
    coll_bytes = 0.0
    unknown = set(module.unknown_dtypes)
    for op in module.ops:
        flops += _dot_flops(op.name, op.inputs, op.attrs)
        if op.name.startswith(_COLLECTIVE):
            if op.name.endswith("wait_tensor"):
                continue
            out_b = sum(hlo_parser.shape_bytes(s, unknown) for s in op.outputs)
            in_b = sum(hlo_parser.shape_bytes(s, unknown) for s in op.inputs)
            c = max(out_b, in_b)
            if "allreduce" in op.name or "all_reduce" in op.name:
                c *= 2
            coll_bytes += c
            continue
        if op.view:
            continue
        hbm_bytes += sum(hlo_parser.shape_bytes(s, unknown)
                         for s in op.inputs + op.outputs)
    result: Dict[str, object] = {
        "flops": flops,
        "hbm_bytes": hbm_bytes,
        "collective_bytes": coll_bytes,
    }
    if unknown:
        result["unknown_dtypes"] = sorted(unknown)
    return result


def analyze_hlo(fn, *args, **kwargs) -> Dict[str, object]:
    """Record one call ``fn(*args, **kwargs)`` and analyze it."""
    _, record = record_call(fn, args, kwargs)
    return analyze_module(record)
