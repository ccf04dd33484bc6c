"""Rolling-window serving metrics and the health state machine (DESIGN.md §9).
Twin of ``repro.serve.metrics``: pure host logic, the reference's.

The gateway's overload decisions — deadline-feasibility admission, brownout,
shedding — are all *measured* decisions: they read a short rolling window of
what the engine actually did (decode rate, step time, latency percentiles,
queue depth), never a hard-coded capacity constant.

Since the obs layer landed (DESIGN.md §11), the measurement primitives live
in ``repro_torch.obs``: :class:`RollingWindow` is a **thin re-export** of
``repro_torch.obs.metrics.RollingWindow`` (same NaN-on-empty contract, now with a
sorted view cached per mutation generation so percentile reads stop
re-sorting the full window), and :class:`ServeMetrics` is a thin instrument
panel over two ``obs.MetricsRegistry`` instances:

* a **control** registry (ignores ``obs.disabled()``) holds the windows the
  gateway *steers by* — latency/TTFT/decode windows. Disabling telemetry
  must not change admission or brownout behaviour.
* a **telemetry** registry holds the sampled queue-depth / slot-occupancy
  gauges and windows (observability only; honours ``obs.disabled()``).

``ServeMetrics.prometheus_text()`` renders both registries plus the event
counters in Prometheus text exposition format — the gateway exposes it via
its health surface (``ServingGateway.health_snapshot``).

:class:`HealthMonitor` — ``healthy → degraded → browned_out`` readiness.
Escalation is immediate (one bad signal is enough: overload compounds in
queue time), recovery is hysteretic (``recovery_ticks`` consecutive calm
observations per level, stepping down one level at a time) so the state
doesn't flap at the threshold and brownout relief doesn't instantly
re-admit the load that caused it.

Everything takes an injectable ``clock`` so tests drive the windows and
hysteresis deterministically.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.export import prometheus_text as _prometheus_text
from repro_torch.obs.metrics import MetricsRegistry, RollingWindow

__all__ = [
    "HEALTHY",
    "DEGRADED",
    "BROWNED_OUT",
    "HealthMonitor",
    "HealthThresholds",
    "RollingWindow",
    "ServeMetrics",
]


class ServeMetrics:
    """The gateway's instrument panel (windows + gauges + counters), backed
    by obs registries (see module docstring for the control/telemetry
    split)."""

    def __init__(
        self,
        window_s: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.clock = clock
        self._control = MetricsRegistry(control=True, clock=clock)
        self._telemetry = MetricsRegistry(control=False, clock=clock)
        ctl = self._control
        self.latency_ms = ctl.window("serve_latency_ms", window_s=window_s)
        self.ttft_ms = ctl.window("serve_ttft_ms", window_s=window_s)
        # one observation per decode step, value = tokens produced that step
        self.decode_tokens = ctl.window("serve_decode_tokens",
                                        window_s=window_s)
        self.decode_step_ms = ctl.window("serve_decode_step_ms",
                                         window_s=window_s)
        # sampled observability series (telemetry: off under obs.disabled()).
        # Long horizon: a whole bench sweep point must fit the window so the
        # queue-depth-vs-QPS curve summarizes the full run, not its tail.
        tel = self._telemetry
        self._queue_depth = 0
        self._queue_depth_gauge = tel.gauge("serve_queue_depth")
        self.queue_depth_samples = tel.window(
            "serve_queue_depth_sampled", window_s=300.0
        )
        self._slot_gauge = tel.gauge("serve_slot_occupancy")
        self.slot_occupancy_samples = tel.window(
            "serve_slot_occupancy_sampled", window_s=300.0
        )
        self.counters: Dict[str, int] = collections.Counter()
        self.shed: Dict[str, int] = collections.Counter()

    # -- write side ---------------------------------------------------------

    def observe_completion(self, latency_ms: float, ttft_ms: float) -> None:
        self.latency_ms.observe(latency_ms)
        if math.isfinite(ttft_ms):
            self.ttft_ms.observe(ttft_ms)
        self.counters["completed"] += 1

    def observe_decode(self, tokens: int, step_ms: float) -> None:
        self.decode_tokens.observe(tokens)
        self.decode_step_ms.observe(step_ms)

    def observe_slots(self, active: int, total: int) -> None:
        """Sampled slot occupancy (fraction of decode slots busy)."""
        frac = active / total if total else 0.0
        self._slot_gauge.set(frac)
        self.slot_occupancy_samples.observe(frac)

    @property
    def queue_depth(self) -> int:
        return self._queue_depth

    @queue_depth.setter
    def queue_depth(self, v: int) -> None:
        # the gateway assigns this on admissions and on every strided
        # scheduling tick (batcher.TELEMETRY_SAMPLE_STRIDE) — each
        # assignment is one sample of the queue-depth series
        self._queue_depth = int(v)
        self._queue_depth_gauge.set(v)
        self.queue_depth_samples.observe(v)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def count_shed(self, reason: str) -> None:
        self.shed[reason] += 1
        self.counters["shed_total"] += 1

    # -- read side ----------------------------------------------------------

    def decode_rate_tok_s(self) -> float:
        return self.decode_tokens.rate_per_s()

    def snapshot(self) -> Dict[str, float]:
        return {
            "latency_p50_ms": self.latency_ms.percentile(50),
            "latency_p95_ms": self.latency_ms.percentile(95),
            "latency_p99_ms": self.latency_ms.percentile(99),
            "ttft_p50_ms": self.ttft_ms.percentile(50),
            "decode_rate_tok_s": self.decode_rate_tok_s(),
            "decode_step_p50_ms": self.decode_step_ms.percentile(50),
            "queue_depth": float(self.queue_depth),
            "queue_depth_mean": self.queue_depth_samples.mean(),
            "queue_depth_p95": self.queue_depth_samples.percentile(95),
            "slot_occupancy_mean": self.slot_occupancy_samples.mean(),
            **{k: float(v) for k, v in self.counters.items()},
            **{f"shed_{k}": float(v) for k, v in self.shed.items()},
        }

    def prometheus_text(self) -> str:
        """Both registries plus the event/shed counters, in Prometheus text
        exposition format (deterministically ordered)."""
        lines = [
            _prometheus_text(self._control).rstrip("\n"),
            _prometheus_text(self._telemetry).rstrip("\n"),
        ]
        if self.counters:
            lines.append("# TYPE serve_events_total counter")
            for k in sorted(self.counters):
                lines.append(
                    'serve_events_total{event="%s"} %d' % (k, self.counters[k])
                )
        if self.shed:
            lines.append("# TYPE serve_shed_total counter")
            for k in sorted(self.shed):
                lines.append(
                    'serve_shed_total{reason="%s"} %d' % (k, self.shed[k])
                )
        return "\n".join(line for line in lines if line) + "\n"


# ---------------------------------------------------------------------------
# health / readiness
# ---------------------------------------------------------------------------

HEALTHY = "healthy"
DEGRADED = "degraded"
BROWNED_OUT = "browned_out"
_LEVELS = {HEALTHY: 0, DEGRADED: 1, BROWNED_OUT: 2}
_BY_LEVEL = [HEALTHY, DEGRADED, BROWNED_OUT]


@dataclasses.dataclass(frozen=True)
class HealthThresholds:
    """When to degrade/brownout, and how sticky recovery is.

    Queue fractions are of the gateway's queue capacity; ``degrade_p95_ms``
    optionally adds a latency-SLO signal (NaN p95 — empty window — never
    trips it). ``recovery_ticks`` is the hysteresis: that many consecutive
    calm ticks step the state DOWN one level; any hot tick resets the
    count and escalation is immediate."""

    degrade_queue_frac: float = 0.5
    brownout_queue_frac: float = 0.875
    degrade_p95_ms: Optional[float] = None
    recovery_ticks: int = 4


class HealthMonitor:
    """The ``healthy → degraded → browned_out`` readiness state machine."""

    def __init__(
        self,
        thresholds: HealthThresholds = HealthThresholds(),
        clock: Callable[[], float] = time.monotonic,
    ):
        self.thresholds = thresholds
        self.clock = clock
        self.state = HEALTHY
        self._calm = 0
        self.transitions: List[Tuple[float, str, str]] = []
        self.states_seen = {HEALTHY}

    def _target(
        self, queue_frac: float, breaker_open: bool, p95_ms: float
    ) -> str:
        th = self.thresholds
        if breaker_open or queue_frac >= th.brownout_queue_frac:
            return BROWNED_OUT
        slow = (
            th.degrade_p95_ms is not None
            and math.isfinite(p95_ms)
            and p95_ms > th.degrade_p95_ms
        )
        if queue_frac >= th.degrade_queue_frac or slow:
            return DEGRADED
        return HEALTHY

    def _move(self, to: str) -> None:
        self.transitions.append((self.clock(), self.state, to))
        self.state = to
        self.states_seen.add(to)

    def tick(
        self,
        *,
        queue_frac: float,
        breaker_open: bool = False,
        p95_ms: float = float("nan"),
    ) -> str:
        """One observation. Escalation jumps straight to the target level;
        recovery steps down one level per ``recovery_ticks`` calm ticks."""
        target = self._target(queue_frac, breaker_open, p95_ms)
        cur, tgt = _LEVELS[self.state], _LEVELS[target]
        if tgt > cur:
            self._calm = 0
            self._move(target)
        elif tgt < cur:
            self._calm += 1
            if self._calm >= self.thresholds.recovery_ticks:
                self._calm = 0
                self._move(_BY_LEVEL[cur - 1])
        else:
            self._calm = 0
        return self.state

    @property
    def ready(self) -> bool:
        """Readiness-probe view: browned_out is not ready for new load."""
        return self.state != BROWNED_OUT
