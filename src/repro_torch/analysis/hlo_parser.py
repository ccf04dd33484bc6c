"""What the run-level checks read, in the card's terms. Twin of
``repro.analysis.hlo_parser``.

The reference parses the compiled HLO text. The port has no HLO: its
programs run eagerly, op by op, and their kernels launch on the card. So
this module holds the three facts the checks need, taken from the run:

* **shapes and bytes** — a tensor's type string ``"<dtype>[d0,d1,...]"``
  (:func:`type_str`, torch dtype names: ``float32[8,4]``) and its bytes
  (:func:`shape_bytes`), with the reference's unknown-dtype rule: a dtype
  the byte model does not know is recorded and warned about once, and
  costs the documented 4-byte fallback;
* **aliasing** — the ``[(output_index, param_index)]`` pairs of a call:
  the output leaves that ARE input leaves (the same ``data_ptr``), what
  the reference reads from the module header's ``input_output_alias``
  (:func:`alias_pairs`);
* **the kernel census** — the device kernels of a ``torch.profiler``
  capture by name (:func:`kernel_census`), and the scatter, index-put and
  atomic kernels among them (:func:`scatter_kernels`), the twin of the
  reference's scatter opcode census; and the hand kernels' events beside
  their wrappers' launch counters (:func:`hand_kernel_match`), which
  tells a whole capture from one that lost device events.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int64": 8, "uint64": 8, "int32": 4, "uint32": 4, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1, "complex64": 8, "complex128": 16,
}
# the fallback element size used when a dtype is unknown; every use is
# recorded (and warned once per dtype) instead of silently miscounting bytes
_UNKNOWN_DTYPE_FALLBACK = 4
_warned_dtypes: Set[str] = set()

_SHAPE_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")

# device kernels that scatter or add atomically: what the truly sparse
# passes exist to avoid (``index_add_`` on the card sums with atomics, in
# ``indexFunc*Index``); the KV-cache inserts are index-put kernels, as they
# are scatters in the reference's HLO
SCATTER_KERNEL_RE = re.compile(
    r"scatter|index_put|indexing_backward|index_add|indexFunc|index_reduce|atomic", re.I
)
# PyTorch's gather runs the shared scatter/gather kernel with is_scatter_like
# false: not a scatter
_GATHER_KERNEL = "_cuda_scatter_gather_internal_kernel<false"
DTOH_COPY_RE = re.compile(r"memcpy dtoh|device -> (pinned|pageable)", re.I)

# torch.cuda._sleep's kernel: the no-op burst that opens each census
# capture (hlo_audit.census), not a kernel of the call
SPIN_KERNEL_RE = re.compile(r"(?<![A-Za-z_])spin_kernel")

# the hand kernels (src/repro_torch/csrc) by launch counter: the kernels one
# counted launch runs, named as the profiler shows them (demangled or
# mangled); helper passes such as bsmm_fwd's split-sum are not counted
HAND_KERNEL_RE: Dict[str, "re.Pattern[str]"] = {
    "coo_matmul_T": re.compile(r"(?<![A-Za-z_])coo_matmul_T_(kernel|staged)"),
    "coo_dw": re.compile(r"(?<![A-Za-z_])coo_dw_kernel"),
    "bias_all_relu": re.compile(r"(?<![A-Za-z_])bias_(all_relu|act_T)_"),
    "bsmm_fwd": re.compile(r"(?<![A-Za-z_])bsmm_fwd_(kernel|bf16_kernel|bf16_decode|bf16_rows)"),
    "bsmm_dx": re.compile(r"(?<![A-Za-z_])bsmm_dx_(bf16_)?kernel"),
    "bsmm_dw": re.compile(r"(?<![A-Za-z_])bsmm_dw_(bf16_)?kernel"),
}
# the launch counters whose launches run each kernel family: K8's shard
# product launches kernel A through its counted launcher and its shard dW
# counts on coo_dw; kernel G's standalone pass is kernel F's
HAND_KERNEL_COUNTERS: Dict[str, Tuple[str, ...]] = {
    "coo_matmul_T": ("coo_matmul_T",),
    "coo_dw": ("coo_dw", "all_relu_bwd"),
    "bias_all_relu": ("bias_all_relu",),
    "bsmm_fwd": ("bsmm_fwd",),
    "bsmm_dx": ("bsmm_dx",),
    "bsmm_dw": ("bsmm_dw",),
}


def type_str(t) -> str:
    """``"<dtype>[d0,d1,...]"`` of a tensor, with torch's dtype name."""
    return f"{str(t.dtype).rsplit('.', 1)[-1]}[{','.join(str(d) for d in t.shape)}]"


def shape_dims(type_str: str) -> List[Tuple[str, List[int]]]:
    """All (dtype, dims) pairs in a type string (several for a tuple)."""
    out = []
    for dt, dims in _SHAPE_RE.findall(type_str):
        out.append((dt, [int(d) for d in dims.split(",") if d]))
    return out


def shape_bytes(type_str: str, unknown: Optional[Set[str]] = None) -> int:
    """Total bytes of a type string. Unknown dtypes fall back to 4 bytes
    but are recorded in ``unknown`` (if given) and warned once per dtype —
    never silently miscounted."""
    total = 0
    for dt, dims in shape_dims(type_str):
        n = 1
        for d in dims:
            n *= d
        if dt in _DTYPE_BYTES:
            total += n * _DTYPE_BYTES[dt]
        else:
            if unknown is not None:
                unknown.add(dt)
            if dt not in _warned_dtypes:
                _warned_dtypes.add(dt)
                warnings.warn(
                    f"hlo_parser: unknown dtype {dt!r} — assuming "
                    f"{_UNKNOWN_DTYPE_FALLBACK} bytes/element; byte counts "
                    "involving it are approximate",
                    stacklevel=2,
                )
            total += n * _UNKNOWN_DTYPE_FALLBACK
    return total


def alias_pairs(params: Sequence, outputs: Sequence) -> List[Tuple[int, int]]:
    """``(output_index, param_index)`` for every output leaf that is a
    parameter leaf's storage (the same ``data_ptr``, both non-empty): the
    buffers a donated call updated in place and handed back."""
    where: Dict[int, int] = {}
    for i, p in enumerate(params):
        if p.numel():
            where.setdefault(p.data_ptr(), i)
    return [(o, where[t.data_ptr()]) for o, t in enumerate(outputs)
            if t.numel() and t.data_ptr() in where]


def _is_device_event(evt) -> bool:
    kind = getattr(evt, "device_type", None)
    return kind is not None and str(kind).rsplit(".", 1)[-1] == "CUDA"


def kernel_census(events: Iterable) -> Dict[str, int]:
    """Launch count by name of the device events (kernels, copies,
    memsets) of a ``torch.profiler`` capture's ``events()``."""
    census: Dict[str, int] = {}
    for evt in events:
        if _is_device_event(evt):
            census[evt.name] = census.get(evt.name, 0) + 1
    return census


def scatter_kernels(census: Dict[str, int]) -> Dict[str, int]:
    """The census's scatter, index-put and atomic kernels."""
    return {k: n for k, n in census.items()
            if SCATTER_KERNEL_RE.search(k) and _GATHER_KERNEL not in k}


def dtoh_copies(census: Dict[str, int]) -> Dict[str, int]:
    """The census's device-to-host copies."""
    return {k: n for k, n in census.items() if DTOH_COPY_RE.search(k)}


def hand_kernel_match(census: Dict[str, int],
                      launches: Dict[str, int]) -> Dict[str, Tuple[int, int]]:
    """``{family: (events, launches)}`` for each hand-kernel family that
    the census saw or the launch counters counted over the same calls
    (``launches`` by counter name, as ``hlo_audit.launch_counts`` gives
    them). A whole capture holds as many events as launches in each."""
    out: Dict[str, Tuple[int, int]] = {}
    for family, pattern in HAND_KERNEL_RE.items():
        seen = sum(n for k, n in census.items() if pattern.search(k))
        counted = sum(launches.get(c, 0) for c in HAND_KERNEL_COUNTERS[family])
        if seen or counted:
            out[family] = (seen, counted)
    return out
