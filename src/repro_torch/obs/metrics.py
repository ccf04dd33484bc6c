"""Metrics primitives and the process-wide registry (DESIGN.md §11).

Twin of ``repro.obs.metrics``, a copy (it needs no framework).

Four series types, all cheap enough for host-side hot loops:

* :class:`Counter` — monotone accumulator (events, tokens, retries).
* :class:`Gauge` — last-write-wins level (queue depth, bytes in use).
* :class:`Histogram` — fixed upper-bound buckets with total/count;
  percentile reads interpolate within a bucket, so accuracy is bounded by
  bucket width and memory is O(#buckets) forever.
* :class:`RollingWindow` — exact samples over a sliding time horizon
  (absorbed from ``serve/metrics``, which re-exports it). Percentile reads
  are served from a **sorted view cached per mutation generation**: the
  window only re-sorts when a read follows a write/trim, so a snapshot
  taking p50/p95/p99 sorts once, and per-observe cost stays O(1) amortized.
  Empty windows read NaN — "no data" must never masquerade as
  "infinitely fast".

:class:`MetricsRegistry` interns series by ``(name, labels)`` so
instrumentation sites can re-resolve series cheaply and snapshots see one
consistent set. Registries come in two flavours: **telemetry** (default)
registries honour the global ``obs.disabled()`` switch; **control**
registries (``control=True``) do not, because their readings steer
behaviour (the serving gateway's admission and brownout decisions) and
must not change when telemetry is switched off.
"""
from __future__ import annotations

import bisect
import collections
import math
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import _state

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "RollingWindow",
    "MetricsRegistry",
    "default_registry",
    "DEFAULT_BUCKETS",
]

# generic latency-style buckets (unit-agnostic; callers pick their own for
# tighter resolution). +Inf is implicit.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)

LabelsKey = Tuple[Tuple[str, str], ...]


class _Series:
    """Common base: name, labels, and the enabled-check used by writers."""

    kind = "series"

    def __init__(self, name: str, labels: LabelsKey, control: bool):
        self.name = name
        self.labels = labels
        self._control = control

    def _on(self) -> bool:
        return self._control or _state.is_enabled()

    @property
    def label_str(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in self.labels)
        return "{" + inner + "}"


class Counter(_Series):
    kind = "counter"

    def __init__(self, name: str, labels: LabelsKey, control: bool):
        super().__init__(name, labels, control)
        self.value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._on():
            return
        self.value += n


class Gauge(_Series):
    kind = "gauge"

    def __init__(self, name: str, labels: LabelsKey, control: bool):
        super().__init__(name, labels, control)
        self.value: float = float("nan")

    def set(self, v: float) -> None:
        if not self._on():
            return
        self.value = float(v)


class Histogram(_Series):
    """Fixed-bucket histogram: ``bounds`` are inclusive upper edges; an
    implicit +Inf bucket catches the tail. ``percentile`` interpolates
    linearly inside the bucket the rank lands in (the +Inf bucket reads as
    its lower edge — a deliberate under-estimate rather than a fabricated
    tail)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        labels: LabelsKey,
        control: bool,
        bounds: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, labels, control)
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        if not self._on():
            return
        _state.note_alloc()
        i = bisect.bisect_left(self.bounds, v)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return float("nan")
        rank = (p / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else 0.0
            hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
            if cum + c >= rank:
                frac = (rank - cum) / c if c else 0.0
                return float(lo + (hi - lo) * min(1.0, max(0.0, frac)))
            cum += c
        return float(self.bounds[-1])

    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


class RollingWindow(_Series):
    """Fixed-horizon sample window: (time, value) pairs no older than
    ``window_s`` (and at most ``maxlen``, so a burst can't grow memory).

    All reads trim expired samples first; an empty window reads NaN.
    Percentile reads use a sorted view cached per mutation generation —
    repeated reads between writes cost O(1) after the first.
    """

    kind = "window"

    def __init__(
        self,
        window_s: float = 5.0,
        maxlen: int = 4096,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
        labels: LabelsKey = (),
        control: bool = True,
    ):
        # control=True by default: standalone windows predate obs and are
        # used as measurement inputs to control loops (gateway admission).
        super().__init__(name, labels, control)
        self.window_s = window_s
        self.clock = clock
        self._q: Deque[Tuple[float, float]] = collections.deque(maxlen=maxlen)
        self._sorted: Optional[List[float]] = None

    def observe(self, value: float, t: Optional[float] = None) -> None:
        if not self._on():
            return
        _state.note_alloc()
        self._q.append((self.clock() if t is None else t, float(value)))
        self._sorted = None  # O(1) append; reads re-sort once per generation

    def _trim(self) -> None:
        cutoff = self.clock() - self.window_s
        while self._q and self._q[0][0] < cutoff:
            self._q.popleft()
            self._sorted = None

    def values(self) -> List[float]:
        self._trim()
        return [v for _, v in self._q]

    def count(self) -> int:
        self._trim()
        return len(self._q)

    def _sorted_view(self) -> List[float]:
        self._trim()
        if self._sorted is None:
            self._sorted = sorted(v for _, v in self._q)
        return self._sorted

    def percentile(self, p: float) -> float:
        vals = self._sorted_view()
        if not vals:
            return float("nan")
        # numpy 'linear' interpolation on the pre-sorted view
        rank = (p / 100.0) * (len(vals) - 1)
        lo = int(math.floor(rank))
        hi = int(math.ceil(rank))
        if lo == hi:
            return float(vals[lo])
        frac = rank - lo
        return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)

    def mean(self) -> float:
        self._trim()
        if not self._q:
            return float("nan")
        return float(np.mean([v for _, v in self._q]))

    def rate_per_s(self) -> float:
        """Sum of values per second of observed span — e.g. tokens/s when
        each decode step observes its token count. NaN until two samples
        span a measurable interval (no data must not read as rate 0, which
        would shed everything, nor as +inf, which would admit everything)."""
        self._trim()
        if len(self._q) < 2:
            return float("nan")
        span = self._q[-1][0] - self._q[0][0]
        if span <= 0:
            return float("nan")
        return sum(v for _, v in self._q) / span


class MetricsRegistry:
    """Interned, labeled series with a cheap consistent snapshot.

    ``control=True`` marks every series created here as control-plane:
    their writes ignore ``obs.disabled()`` (see module docstring).
    """

    def __init__(
        self,
        control: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.control = control
        self.clock = clock
        self._series: Dict[Tuple[str, LabelsKey], _Series] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> Tuple[str, LabelsKey]:
        return name, tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _intern(self, key, factory):
        with self._lock:
            s = self._series.get(key)
            if s is None:
                _state.note_alloc()
                s = self._series[key] = factory()
            return s

    def counter(self, name: str, **labels: str) -> Counter:
        key = self._key(name, labels)
        s = self._intern(key, lambda: Counter(name, key[1], self.control))
        if not isinstance(s, Counter):
            raise TypeError(f"{name}{key[1]} already registered as {s.kind}")
        return s

    def gauge(self, name: str, **labels: str) -> Gauge:
        key = self._key(name, labels)
        s = self._intern(key, lambda: Gauge(name, key[1], self.control))
        if not isinstance(s, Gauge):
            raise TypeError(f"{name}{key[1]} already registered as {s.kind}")
        return s

    def histogram(
        self,
        name: str,
        bounds: Sequence[float] = DEFAULT_BUCKETS,
        **labels: str,
    ) -> Histogram:
        key = self._key(name, labels)
        s = self._intern(
            key, lambda: Histogram(name, key[1], self.control, bounds)
        )
        if not isinstance(s, Histogram):
            raise TypeError(f"{name}{key[1]} already registered as {s.kind}")
        return s

    def window(
        self,
        name: str,
        window_s: float = 5.0,
        maxlen: int = 4096,
        **labels: str,
    ) -> RollingWindow:
        key = self._key(name, labels)
        s = self._intern(
            key,
            lambda: RollingWindow(
                window_s, maxlen, clock=self.clock, name=name,
                labels=key[1], control=self.control,
            ),
        )
        if not isinstance(s, RollingWindow):
            raise TypeError(f"{name}{key[1]} already registered as {s.kind}")
        return s

    def series(self) -> List[_Series]:
        with self._lock:
            return sorted(
                self._series.values(), key=lambda s: (s.name, s.labels)
            )

    def snapshot(self) -> Dict[str, float]:
        """Flat ``name{labels} -> value`` view. Counters/gauges read their
        value; histograms and windows contribute ``_p50/_p95/_p99`` plus
        count/mean — cheap because window sorts are cached."""
        out: Dict[str, float] = {}
        for s in self.series():
            key = s.name + s.label_str
            if isinstance(s, (Counter, Gauge)):
                out[key] = s.value
            elif isinstance(s, Histogram):
                out[key + "_count"] = float(s.count)
                out[key + "_mean"] = s.mean()
                for p in (50, 95, 99):
                    out[f"{key}_p{p}"] = s.percentile(p)
            elif isinstance(s, RollingWindow):
                out[key + "_count"] = float(s.count())
                out[key + "_mean"] = s.mean()
                for p in (50, 95, 99):
                    out[f"{key}_p{p}"] = s.percentile(p)
        return out


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide telemetry registry (honours ``obs.disabled()``)."""
    return _DEFAULT
