"""Hot-path program registry: every headline performance invariant of the
port, declared as a machine-checkable contract next to the code it audits.
Twin of ``repro.analysis.registry``.

Each hot-path subsystem (``train.trainer``, ``core.wasap``, ``xl.stream``,
``serve.engine``, ``launch.steps``) exposes an ``analysis_programs()`` hook
returning :class:`ProgramSpec` entries. A spec names a device program, knows
how to build it at a representative-but-CI-sized scale on a given device,
and declares a :class:`Contract`: which aten ops its record may hold, what
one call may allocate and alias, and how many builds it may ever own.

PyTorch has no jit trace. The port's device program is the code a CUDA
graph capture would record: one call of the builder's callable, forward
and backward. ``python -m repro_torch.analysis`` records it (``jaxpr_audit``,
the aten-op record) and runs it (``hlo_audit``, the run-level checks), and
``analysis.compilecheck`` lets tests assert against the registry's
expected-compile-count contracts (DESIGN.md §10).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, List, Optional, Tuple

# aten ops that make the host wait for the device inside a program — never
# acceptable in a registered hot path. They are the port's twins of the
# reference's HOST_CALLBACK_PRIMITIVES: a jax host callback stops the device
# program to run Python on the host's copy of a value, and each of these
# stops the host until the device has produced a value it then reads:
#
# * ``aten._local_scalar_dense`` — ``.item()``, ``float(t)``, ``int(t)``,
#   ``bool(t)``: one scalar copied to the host;
# * ``aten.nonzero`` and ``aten.masked_select`` — outputs whose size is
#   data-dependent, so the host reads a count before it can allocate them;
# * ``aten.is_nonzero`` — a tensor's truth value in a Python branch;
# * ``DEVICE_TO_HOST`` — any op that copies a device tensor to the CPU
#   (``.cpu()``, ``.to("cpu")``, ``.tolist()``, ``.numpy()`` after them).
DEVICE_TO_HOST = "device-to-host-copy"
HOST_SYNC_OPS: Tuple[str, ...] = (
    "aten._local_scalar_dense",
    "aten.nonzero",
    "aten.masked_select",
    "aten.is_nonzero",
    DEVICE_TO_HOST,
)

# modules whose ``analysis_programs()`` hook feeds the registry; order is
# the report order
HOOK_MODULES: Tuple[str, ...] = (
    "repro_torch.train.trainer",
    "repro_torch.core.wasap",
    "repro_torch.xl.stream",
    "repro_torch.serve.engine",
    "repro_torch.launch.steps",
)


@dataclasses.dataclass(frozen=True)
class Contract:
    """The declared invariants of one hot-path program, with the
    reference's fields and defaults.

    Record level (checked by ``jaxpr_audit`` on the aten-op record of one
    call, forward and backward):

    * ``forbidden_primitives`` — aten ops (overload packets such as
      ``"aten.nonzero"``) that must not appear; the host-sync ops by
      default (:data:`HOST_SYNC_OPS`).
    * ``max_unsorted_scatter`` / ``max_unsorted_scatter_elems`` — an
      accumulating scatter (``index_add``, ``index_put(accumulate=True)``,
      ``scatter_add``, ``scatter_reduce``) whose index is not
      non-decreasing is the dense-scatter hazard (on the card: atomics)
      that the truly sparse passes avoid. The few allowed ones are bounded
      in count (per call) AND in result size.
    * ``max_intermediate_elems`` — the largest tensor an op of the call
      newly allocates, in elements.
    * ``allow_f64`` — f64/c128 outputs are dtype drift unless declared.

    Run level (checked by ``hlo_audit``):

    * ``donate_argnums`` / ``min_aliased_buffers`` — the audit builds the
      program with these positions donated, calls it, and requires at
      least this many donated input leaves to be output leaves (the same
      ``data_ptr``). ``None`` derives the floor from the number of tensor
      leaves in the donated arguments.
    * ``max_temp_bytes`` — ceiling on the bytes one call allocates beyond
      its inputs, at its peak (the allocator's peak on the card, the
      record's live storages on the CPU).
    * ``max_hlo_scatter`` — ceiling on the scatter, index-put and atomic
      kernels in the profiler's census of one call on the card (``None``
      reports the census and checks nothing).

    Lifecycle:

    * ``expected_compiles`` — builds this program may own after a
      double-call warm-up (consumed by ``compilecheck``).
    """

    forbidden_primitives: Tuple[str, ...] = HOST_SYNC_OPS
    max_unsorted_scatter: int = 0
    max_unsorted_scatter_elems: int = 0
    max_intermediate_elems: Optional[int] = None
    allow_f64: bool = False
    donate_argnums: Tuple[int, ...] = ()
    min_aliased_buffers: Optional[int] = None
    max_temp_bytes: Optional[int] = None
    max_hlo_scatter: Optional[int] = None
    expected_compiles: int = 1
    notes: str = ""


@dataclasses.dataclass
class AuditProgram:
    """A concrete, callable instance of a registered program.

    ``make(donate)`` returns a FRESH callable. Under the port's donation
    policy (``runtime.donation``) ``donate=()`` means "returns new
    tensors": the call leaves its inputs as they were, so it is safe to
    call twice on the same inputs (the record, the run-level checks);
    ``donate=contract.donate_argnums`` builds the donating variant, which
    may write those inputs in place and return them (the aliasing check
    calls it on copies). ``args`` are example inputs at the spec's audit
    scale; ``kwargs`` carries keyword arguments; ``meta`` carries the
    shape facts (batch, nnz, chunk, ...) the report prints next to the
    contract bounds.
    """

    make: Callable[[Tuple[int, ...]], Callable]
    args: Tuple
    kwargs: Dict[str, object] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ProgramSpec:
    name: str           # e.g. "train.segment" — stable waiver/report id
    subsystem: str      # registering module (dotted)
    contract: Contract
    # lazy: builds models; ``build(device)`` puts them on ``device`` (None:
    # the card, as every entry point of the port)
    build: Callable[..., AuditProgram]
    notes: str = ""
    # the hand kernels one call launches on the card, by the counter names
    # of ``hlo_audit.launch_counts`` (a call that launches none of one ran a
    # plain version there)
    kernels: Tuple[str, ...] = ()


@functools.lru_cache(maxsize=1)
def collect() -> Tuple[ProgramSpec, ...]:
    """Import every hook module and gather its registered programs. Hooks
    must be cheap: model construction belongs in ``ProgramSpec.build``, not
    in the hook."""
    specs: List[ProgramSpec] = []
    seen: Dict[str, str] = {}
    for mod_name in HOOK_MODULES:
        mod = importlib.import_module(mod_name)
        hook = getattr(mod, "analysis_programs", None)
        if hook is None:
            raise RuntimeError(
                f"hot-path module {mod_name} lost its analysis_programs() "
                "registration hook"
            )
        for spec in hook():
            if spec.name in seen:
                raise RuntimeError(
                    f"duplicate program name {spec.name!r} "
                    f"({seen[spec.name]} and {mod_name})"
                )
            seen[spec.name] = mod_name
            specs.append(spec)
    return tuple(specs)


def get(name: str) -> ProgramSpec:
    for spec in collect():
        if spec.name == name:
            return spec
    raise KeyError(
        f"no registered hot-path program {name!r}; known: "
        f"{[s.name for s in collect()]}"
    )


def expected_compiles(name: str) -> int:
    """The registry's compile-count contract for ``name`` — the one source
    of truth the shared test helper (``compilecheck``) asserts against."""
    return get(name).contract.expected_compiles
