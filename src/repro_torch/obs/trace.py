"""Span tracing (twin of ``repro.obs.trace``): context-manager spans forming a tree, emitted as JSONL
events with monotonic timestamps (DESIGN.md §11).

The span taxonomy mirrors the repo's execution structure — training:
``run → epoch → prepare/feed/segment/topology/wait/evaluate/hook``;
serving: ``request → queue → prefill → decode steps``. Every event carries
``time.perf_counter()`` timestamps (monotonic, high resolution, process
local) — never wall clock, so spans order correctly across clock steps.

**The timing lesson**: CUDA launches are asynchronous, so a span that
closes right after a launch has measured *dispatch*, not *work*. Where the
process has initialised CUDA, a span therefore records a timing
``torch.cuda.Event`` on the current stream when it opens and when it
closes, and ``block_on(x)`` adds one on the stream of each device the CUDA
tensors in ``x`` lie on. The close never synchronises: a traced run
queues the same work as an untraced one. The events are put on the spans'
clock by one anchor a device, taken the first time the tracer records
there (synchronise, record an event, wait for it, read the clock): the
only synchronise the tracer makes. Each span event then gets ``dev_t0``
and ``dev_t1``, the times its open and close events ran on the device; a
span that ``block_on``-ed a value ends at the later of its host close and
``dev_t1``, so it times the device's work it claims. The fields are filled
in on the event dicts themselves, at a later span's close where the
events have run, at the latest in ``flush()``. Without a card (or before
CUDA is initialised) nothing is recorded and no CUDA call is made.

When no tracer is installed — or inside ``obs.disabled()`` — ``span()``
and ``point()`` return/are singleton no-ops: no ``Span`` object, no event
dict, no sample is allocated (asserted by the ``_state.debug_allocs``
counter in tests). Instrumentation can therefore stay permanently in the
hot loops.

Event schema (one JSON object per line; ``ev`` discriminates):

* ``{"ev":"meta","schema":1,"clock":"perf_counter","pid":...,"t":...,
  "attrs":{...}}`` — first line; ``clock`` names the clock of every time.
* ``{"ev":"span","name":...,"id":n,"parent":m|null,"t0":...,"t1":...,
  "dur_s":...,"attrs":{...}}`` — emitted at span *close*, so children
  precede parents in the file; readers rebuild the tree from id/parent.
  On a card, also ``"dev_t0"`` and ``"dev_t1"`` (optional fields: the
  schema stays 1).
* ``{"ev":"point","name":...,"t":...,"attrs":{...}}`` — instant events
  (restore/retry/compile/heartbeat).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple, Union

from repro_torch.obs import _state

__all__ = [
    "SCHEMA_VERSION",
    "Span",
    "Tracer",
    "span",
    "point",
    "event_span",
    "configure",
    "shutdown",
    "trace_to",
    "current_tracer",
    "current_span_name",
]

SCHEMA_VERSION = 1

# (span_id, name) stack of the innermost open span, per context
_span_stack: contextvars.ContextVar[Tuple[Tuple[int, str], ...]] = (
    contextvars.ContextVar("obs_span_stack", default=())
)

_tracer: Optional["Tracer"] = None
_tracer_lock = threading.Lock()


def _cuda_devices(obj: Any, found: set) -> None:
    """Collect the CUDA devices of the tensors in ``obj`` (tensors, and
    lists, tuples, dicts and dataclasses of them)."""
    import torch

    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), found)


class Span:
    """One open span; use via ``with obs.span(name, **attrs) as sp:``."""

    __slots__ = ("_tracer", "name", "id", "parent", "t0", "attrs",
                 "_block", "_token", "_opened")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional[int],
                 span_id: int, attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.id = span_id
        self.parent = parent
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.t0 = 0.0
        self._block: List[Any] = []
        self._token = None
        self._opened: Optional[Dict[int, Any]] = None

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes discovered mid-span (loss, token counts...)."""
        self.attrs.update(attrs)
        return self

    def block_on(self, obj: Any) -> Any:
        """Register a device value whose making the span times: its close
        records an event on the stream of each device the value's CUDA
        tensors lie on, and the span ends no earlier than those events run
        (it does not wait for them). Returns the object unchanged so call
        sites can wrap expressions."""
        self._block.append(obj)
        return obj

    def __enter__(self) -> "Span":
        self._opened = self._tracer._device_marks()
        self.t0 = self._tracer.clock()
        self._token = _span_stack.set(
            _span_stack.get() + ((self.id, self.name),)
        )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = self._tracer.clock()
        if self._token is not None:
            _span_stack.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        event = {
            "ev": "span", "name": self.name, "id": self.id,
            "parent": self.parent, "t0": self.t0, "t1": t1,
            "dur_s": t1 - self.t0, "attrs": self.attrs,
        }
        self._tracer._emit(event)
        if self._opened is not None:
            found: set = set()
            for o in self._block:
                _cuda_devices(o, found)
            closed = self._tracer._device_marks(found)
            self._tracer._time_on_device(event, self._opened, closed, bool(self._block))


class _NoopSpan:
    """Singleton returned when tracing is off: every method is a no-op and
    allocates nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def block_on(self, obj: Any) -> Any:
        return obj

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Serializes span/point events to a JSONL sink (path or file-like).

    Serialization is **deferred**: ``_emit`` only appends the event dict to
    an in-memory buffer (sub-microsecond), and ``flush()``/``close()`` do
    the ``json.dumps`` + I/O. JSON encoding costs ~6us per event — two
    orders of magnitude more than the append — and paying it per event
    inside a sub-millisecond decode step is exactly the overhead the <2%
    budget (``benchmarks/obs_bench.py``) forbids. The trade is the usual
    tracer one (Chrome tracing, JFR do the same): a hard crash loses
    unflushed events; the supervisor's progress file, not the trace, is the
    crash-forensics surface."""

    def __init__(
        self,
        sink: Union[str, os.PathLike, IO[str]],
        clock=time.perf_counter,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.clock = clock
        self._lock = threading.Lock()
        # itertools.count / deque.append are atomic under the GIL — the
        # hot path (_emit, span-id allocation) takes no lock at all
        self._ids = itertools.count(1)
        self._owns_file = isinstance(sink, (str, os.PathLike))
        self._fh: IO[str] = (
            open(sink, "w", encoding="utf-8") if self._owns_file else sink
        )
        self._buf: collections.deque = collections.deque()
        self._flushed = 0
        # device index -> (anchor event, its time on self.clock)
        self._anchors: Dict[int, Tuple[Any, float]] = {}
        # span events whose device times are not filled in yet, in close order
        self._unresolved: collections.deque = collections.deque()
        self._device_lock = threading.Lock()
        self._emit({
            "ev": "meta", "schema": SCHEMA_VERSION,
            "clock": getattr(clock, "__name__", type(clock).__name__),
            "pid": os.getpid(), "t": self.clock(), "attrs": dict(meta or {}),
        })

    def _emit(self, event: Dict[str, Any]) -> None:
        _state.note_alloc()
        self._buf.append(event)

    # -- device times (see the module docstring) ------------------------------

    def _device_marks(self, devices=()) -> Optional[Dict[int, Any]]:
        """A timing event recorded now on the current stream of the current
        device and of each of ``devices``, by device index; None, with no
        CUDA call made, where the process has not initialised CUDA."""
        import torch

        if not torch.cuda.is_initialized():
            return None
        marks = {}
        for d in {torch.cuda.current_device(), *(dev.index for dev in devices)}:
            if d not in self._anchors:
                with self._device_lock:
                    if d not in self._anchors:
                        self._anchors[d] = self._anchor(torch, d)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(d))
            marks[d] = ev
        return marks

    def _anchor(self, torch, d: int) -> Tuple[Any, float]:
        """The one synchronise: an event that has run on device ``d``, and
        the clock's reading just after, to put its other events on the
        clock."""
        torch.cuda.synchronize(d)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(d))
        ev.synchronize()
        return ev, self.clock()

    def _on_clock(self, d: int, ev: Any) -> float:
        anchor, t = self._anchors[d]
        return t + 1e-3 * anchor.elapsed_time(ev)

    def _time_on_device(self, event: Dict[str, Any], opened: Dict[int, Any],
                        closed: Dict[int, Any], blocked: bool) -> None:
        self._unresolved.append((event, opened, closed, blocked))
        self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Fill in ``dev_t0``/``dev_t1`` (and a ``block_on`` span's ``t1``
        and ``dur_s``) on the span events whose device events have run, in
        close order; with ``wait``, on all of them, waiting for their events."""
        with self._device_lock:
            while self._unresolved:
                event, opened, closed, blocked = self._unresolved[0]
                marks = [*opened.values(), *closed.values()]
                if wait:
                    for ev in marks:
                        ev.synchronize()
                elif not all(ev.query() for ev in marks):
                    return
                self._unresolved.popleft()
                event["dev_t0"] = min(self._on_clock(d, ev) for d, ev in opened.items())
                event["dev_t1"] = max(self._on_clock(d, ev) for d, ev in closed.items())
                if blocked and event["dev_t1"] > event["t1"]:
                    event["t1"] = event["dev_t1"]
                    event["dur_s"] = event["t1"] - event["t0"]

    @property
    def events_written(self) -> int:
        return self._flushed + len(self._buf)

    def span(self, name: str, attrs: Optional[Dict[str, Any]] = None) -> Span:
        sid = next(self._ids)
        stack = _span_stack.get()
        parent = stack[-1][0] if stack else None
        _state.note_alloc()
        return Span(self, name, parent, sid, attrs)

    def point(self, name: str, attrs: Optional[Dict[str, Any]] = None) -> None:
        self._emit({
            "ev": "point", "name": name, "t": self.clock(),
            "attrs": dict(attrs) if attrs else {},
        })

    def event_span(
        self, name: str, t0: float, t1: float,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Emit a span with explicit endpoints — for lifecycles that cross
        loop iterations (a request's queue wait) where a context manager
        can't bracket the interval."""
        sid = next(self._ids)
        stack = _span_stack.get()
        parent = stack[-1][0] if stack else None
        self._emit({
            "ev": "span", "name": name, "id": sid, "parent": parent,
            "t0": t0, "t1": t1, "dur_s": t1 - t0,
            "attrs": dict(attrs) if attrs else {},
        })

    def flush(self) -> None:
        """Serialize and write everything buffered so far (see class
        docstring — this is where the JSON encoding cost lives), after
        filling in the device times still missing."""
        with self._lock:
            self._resolve(wait=True)
            events = []
            while True:  # popleft is atomic; emitters may append meanwhile
                try:
                    events.append(self._buf.popleft())
                except IndexError:
                    break
            if events:
                self._fh.write("\n".join(
                    json.dumps(e, separators=(",", ":"), default=str)
                    for e in events
                ) + "\n")
                self._flushed += len(events)
            self._fh.flush()

    def close(self) -> None:
        self.flush()
        if self._owns_file:
            self._fh.close()


# ---------------------------------------------------------------------------
# module-level API — what instrumentation sites call
# ---------------------------------------------------------------------------


def current_tracer() -> Optional[Tracer]:
    return _tracer


def span(name: str, **attrs: Any):
    """Open a span under the current one. No tracer / disabled → no-op
    singleton (zero allocations)."""
    t = _tracer
    if t is None or not _state.is_enabled():
        return NOOP_SPAN
    return t.span(name, attrs if attrs else None)


def point(name: str, **attrs: Any) -> None:
    """Emit an instant event (restore/retry/compile/heartbeat...)."""
    t = _tracer
    if t is None or not _state.is_enabled():
        return
    t.point(name, attrs if attrs else None)


def event_span(name: str, t0: float, t1: float, **attrs: Any) -> None:
    """Emit a span with explicit monotonic endpoints (see Tracer.event_span)."""
    t = _tracer
    if t is None or not _state.is_enabled():
        return
    t.event_span(name, t0, t1, attrs if attrs else None)


def current_span_name(default: str = "-") -> str:
    """Name of the innermost open span — supervisor progress files carry it
    so external watchers can tell *where* a run last was."""
    stack = _span_stack.get()
    return stack[-1][1] if stack else default


def configure(
    trace_path: Union[str, os.PathLike, IO[str], None] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Optional[Tracer]:
    """Install (or, with ``None``, remove) the process-global tracer."""
    global _tracer
    with _tracer_lock:
        old, _tracer = _tracer, None
        if old is not None:
            old.close()
        if trace_path is not None:
            _tracer = Tracer(trace_path, meta=meta)
        return _tracer


def shutdown() -> None:
    """Close and remove the global tracer (flushes the JSONL sink)."""
    configure(None)


@contextlib.contextmanager
def trace_to(
    trace_path: Union[str, os.PathLike, IO[str]],
    meta: Optional[Dict[str, Any]] = None,
):
    """Scoped tracer: install for the block, close (and restore the
    previous tracer) after."""
    global _tracer
    with _tracer_lock:
        prev = _tracer
        _tracer = Tracer(trace_path, meta=meta)
        t = _tracer
    try:
        yield t
    finally:
        with _tracer_lock:
            _tracer = prev
        t.close()
