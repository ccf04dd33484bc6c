"""Overload-safe serving: the SLO gateway over the sparse engine
(DESIGN.md §9). Twin of ``repro.serve.gateway``: pure control logic over the
batcher's two engine-call seams (``_call_prefill``, ``_call_decode``), the
reference's, so that the same trace, clock and engine give the same
dispositions, counters and health states.

``ContinuousBatcher`` (§6) keeps the engine busy; it has only *static*
admission (bucket fit, KV budget, queue bound) and no failure policy — past
saturation it queues work that can no longer meet any latency target, and
an engine fault propagates to the caller. :class:`ServingGateway` wraps the
same batching loop with the serving-side robustness control plane:

* **Deadlines** — every request carries (or is stamped with) an absolute
  deadline; goodput is deadline-met tokens/s, the number overload policy
  optimizes. Tokens delivered late count for nothing, so queueing work that
  will miss is strictly worse than rejecting it now.
* **Deadline-aware admission / load shedding** — admission predicts each
  request's completion from the *measured* decode rate and the current
  backlog (``serve.metrics``); work predicted to miss is shed immediately
  ("shed: predicted deadline miss") instead of dying in queue. Queued work
  whose deadline passes is swept out, and running work past its deadline is
  evicted to free the slot for requests that can still win.
* **Bounded retries** — engine calls run under ``retry_limit`` retries with
  jittered exponential backoff (seeded RNG: replayable), absorbing
  transient faults (``faultinject.TransientFault``) at the cost of a retry.
* **Circuit breaker** — ``breaker_threshold`` *consecutive* exhausted-retry
  failures open the breaker: engine calls stop (active work parks, new
  work is browned out) for ``breaker_cooldown_s``, then ONE probe call
  half-opens it — success re-closes, failure re-opens. A sick engine gets
  recovery room instead of a retry storm.
* **Health state machine** — ``healthy → degraded → browned_out``
  (``serve.metrics.HealthMonitor``), driven by queue pressure, breaker
  state and (optionally) p95 latency. Degradation *brownouts before it
  sheds*: degraded mode clamps ``max_new_tokens`` and shrinks the
  admission queue; browned-out mode admits only a trickle; hard shedding
  is the last resort. Recovery is hysteretic so relief doesn't re-admit
  the stampede that caused the brownout.

The gateway's contract: :meth:`run` **never raises to the caller**. Every
request ends in exactly one disposition — completed, rejected (shed with a
reason), or failed (engine unavailable / deadline expired) — and the
engine's failures are absorbed by retry, breaker and shed policy. Chaos
tests (``tests/test_torch_gateway.py``, the card's ``gateway`` smoke phase)
drive a 2× saturation Poisson trace with injected engine faults through
exactly this surface.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serve.batcher import (
    TELEMETRY_SAMPLE_STRIDE,
    ContinuousBatcher,
    Request,
    ServeStats,
    _finalize,
)
from repro_torch.serve.metrics import (
    BROWNED_OUT,
    DEGRADED,
    HEALTHY,
    HealthMonitor,
    HealthThresholds,
    ServeMetrics,
)

__all__ = [
    "CircuitBreaker",
    "GatewayConfig",
    "GatewayStats",
    "ServingGateway",
]


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Overload policy knobs (thresholds are explained in DESIGN.md §9).

    ``default_deadline_s`` stamps requests that arrive without an SLO; it
    must stay finite unless the deployment accepts that a permanently dead
    engine can park deadline-less work forever (deadlines are also the
    gateway's liveness backstop).
    """

    # deadlines / admission
    default_deadline_s: Optional[float] = 2.0
    admission_safety: float = 1.25     # predicted ETA margin before shedding
    # retries
    retry_limit: int = 2
    retry_backoff_s: float = 0.02
    retry_jitter: float = 0.5          # uniform [0, jitter) fraction on top
    retry_seed: int = 0
    # circuit breaker
    breaker_threshold: int = 3         # consecutive failures to trip
    breaker_cooldown_s: float = 0.25   # open -> half-open probe delay
    # brownout ladder (degraded/browned_out behavior before hard shedding)
    degraded_max_new_tokens: Optional[int] = None  # clamp when not healthy
    degraded_queue_frac: float = 0.5   # degraded: admission queue shrinks to
    brownout_queue_len: int = 2        # browned_out: admit only this backlog
    # health / metrics
    health: HealthThresholds = HealthThresholds()
    metrics_window_s: float = 5.0


class CircuitBreaker:
    """closed → open (on ``threshold`` consecutive failures) → half-open
    (after ``cooldown_s``) → closed (probe success) / open (probe failure).

    Failures are *guarded-call* failures, i.e. retries already exhausted —
    the breaker reacts to a persistently sick engine, not to one blip.
    Timestamps are supplied by the caller so the breaker shares the
    gateway's trace clock.
    """

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0      # consecutive
        self.opened_at = -math.inf
        self.trips = 0         # closed -> open transitions
        self.reopens = 0       # half_open probe failures
        self.closes = 0        # recoveries

    def allow(self, now: float) -> bool:
        """May an engine call run now? Transitions open→half_open once the
        cooldown elapses, permitting exactly the probe call."""
        if self.state == "open":
            if now - self.opened_at >= self.cooldown_s:
                self.state = "half_open"
                return True
            return False
        return True  # closed, or half_open probe already permitted

    def record_success(self) -> None:
        # only the half-open PROBE may close the breaker — an open breaker
        # waits out its cooldown even if a stray success were recorded
        if self.state == "half_open":
            self.state = "closed"
            self.closes += 1
        self.failures = 0

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open":
            self.state = "open"
            self.opened_at = now
            self.reopens += 1
        elif self.state == "closed" and self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = now
            self.trips += 1


@dataclasses.dataclass
class GatewayStats:
    """`ServeStats` (per-request accounting incl. goodput) + the gateway's
    own control-plane accounting."""

    serve: ServeStats
    shed: Dict[str, int]
    retries: int
    engine_call_failures: int
    breaker_trips: int
    breaker_reopens: int
    breaker_closes: int
    breaker_final_state: str
    health_final: str
    health_states_seen: List[str]
    health_transitions: int
    brownout_clamped: int
    max_queue_depth: int
    last_errors: List[str]
    metrics: Dict[str, float]

    def asdict(self) -> Dict:
        return dataclasses.asdict(self)


class ServingGateway(ContinuousBatcher):
    def __init__(
        self,
        engine,
        *,
        gateway: GatewayConfig = GatewayConfig(),
        queue_capacity: int = 64,
    ):
        super().__init__(engine, queue_capacity=queue_capacity)
        self.gc = gateway
        self.metrics = ServeMetrics(gateway.metrics_window_s)
        self.health = HealthMonitor(gateway.health)
        self.breaker = CircuitBreaker(
            gateway.breaker_threshold, gateway.breaker_cooldown_s
        )
        self._rng = np.random.default_rng(gateway.retry_seed)
        self._errors: collections.deque = collections.deque(maxlen=8)
        self.max_queue_depth = 0
        self._t0 = time.perf_counter()  # standalone submit() support

    # -- admission ----------------------------------------------------------

    def _predicted_miss(self, req: Request, now: float) -> bool:
        """Will this request miss its deadline given the measured decode
        rate and everything already ahead of it? Unknown rate (cold window)
        admits — the gateway sheds on evidence, not on priors."""
        if req.deadline_s is None:
            return False
        rate = self.metrics.decode_rate_tok_s()
        if not math.isfinite(rate) or rate <= 0:
            return False
        backlog = sum(
            r.max_new_tokens - len(r.tokens) for r in self.queue
        ) + sum(
            r.max_new_tokens - len(r.tokens)
            for r in self.slot_req
            if r is not None
        )
        eta = (backlog + req.max_new_tokens) / rate
        return now + self.gc.admission_safety * eta > req.deadline_s

    def _shed(self, req: Request, reason: str, counter: str) -> bool:
        req.rejected = reason
        self.metrics.count_shed(counter)
        obs.point("serve.shed", rid=req.rid, reason=counter)
        return False

    def submit(self, req: Request) -> bool:
        """The §9 admission ladder: stamp deadline → brownout (clamp
        ``max_new_tokens``, shrink admission) → deadline feasibility → the
        batcher's static checks. Every rejection is immediate and counted."""
        gc = self.gc
        now = self._now()
        if req.deadline_s is None and gc.default_deadline_s is not None:
            req.deadline_s = req.arrival + gc.default_deadline_s
        state = self.health.state
        # brownout before shedding: shorten the answer first
        if state != HEALTHY and gc.degraded_max_new_tokens is not None:
            if req.max_new_tokens > gc.degraded_max_new_tokens:
                req.max_new_tokens = gc.degraded_max_new_tokens
                self.metrics.count("brownout_clamped")
        # ...then shrink how much backlog we are willing to hold
        if state == BROWNED_OUT:
            eff_cap = min(self.queue_capacity, gc.brownout_queue_len)
        elif state == DEGRADED:
            eff_cap = max(1, int(self.queue_capacity * gc.degraded_queue_frac))
        else:
            eff_cap = self.queue_capacity
        if len(self.queue) >= eff_cap:
            reason = (
                "queue full"
                if state == HEALTHY
                else f"shed: {state} admission limit"
            )
            return self._shed(
                req, reason,
                "queue_full" if state == HEALTHY else "admission_limit",
            )
        # ...and only shed outright what measurement says cannot win
        if self._predicted_miss(req, now):
            return self._shed(
                req, "shed: predicted deadline miss", "predicted_deadline_miss"
            )
        ok = super().submit(req)
        if ok:
            self.metrics.queue_depth = len(self.queue)
            self.max_queue_depth = max(self.max_queue_depth, len(self.queue))
        else:  # static admission (bucket fit / KV budget)
            self.metrics.count_shed("static_admission")
        return ok

    # -- deadline enforcement ----------------------------------------------

    def _expire(self, now: float) -> None:
        """Sweep work whose deadline has passed: queued requests are shed
        (they would die in queue), running ones are evicted (their remaining
        tokens can no longer count — free the slot for work that can win)."""
        if self.queue and any(
            r.deadline_s is not None and now > r.deadline_s for r in self.queue
        ):
            keep: collections.deque = collections.deque()
            for r in self.queue:
                if r.deadline_s is not None and now > r.deadline_s:
                    r.rejected = "shed: expired in queue"
                    self.metrics.count_shed("expired_in_queue")
                else:
                    keep.append(r)
            self.queue = keep
        for s, r in enumerate(self.slot_req):
            if r is not None and r.deadline_s is not None and now > r.deadline_s:
                r.failed = "deadline_expired"
                self.metrics.count_shed("deadline_expired")
                self.slot_req[s] = None
                self.slot_pos[s] = self.engine.cfg.max_len - 1
                self.slot_tok[s] = 0

    # -- guarded engine calls ----------------------------------------------

    def _guarded(self, fn: Callable):
        """Run one engine call under bounded jittered-backoff retries and
        breaker accounting. Returns None (never raises) when the engine is
        unavailable — retries exhausted."""
        gc = self.gc
        for attempt in range(gc.retry_limit + 1):
            try:
                out = fn()
            except Exception as e:  # noqa: BLE001 — the gateway absorbs
                self._errors.append(repr(e))
                if attempt < gc.retry_limit:
                    self.metrics.count("retries")
                    obs.point("serve.retry", attempt=attempt,
                              error=type(e).__name__)
                    delay = gc.retry_backoff_s * (2.0 ** attempt)
                    delay *= 1.0 + gc.retry_jitter * float(self._rng.random())
                    time.sleep(delay)
                    continue
                before = self.breaker.state
                self.breaker.record_failure(self._now())
                if self.breaker.state != before:
                    obs.point("serve.breaker", state=self.breaker.state)
                self.metrics.count("engine_call_failures")
                obs.point("serve.engine_failure", error=type(e).__name__)
                return None
            self.breaker.record_success()
            return out

    def _call_prefill(self, group: List[Request], slots: List[int]):
        # the breaker can trip mid-iteration (an earlier group this _join):
        # re-check before every call. A blocked group is PARKED back at the
        # queue head, not failed — it waits out the cooldown (or expires).
        if not self.breaker.allow(self._now()):
            self.queue.extendleft(reversed(group))
            return None
        out = self._guarded(
            lambda: self.engine.prefill([r.prompt for r in group], slots)
        )
        if out is None:
            for r in group:
                r.failed = "engine_unavailable"
                self.metrics.count("failed_requests")
        return out

    def _call_decode(self):
        if not self.breaker.allow(self._now()):
            return None  # parked: slots keep their state until the probe
        n_active = sum(r is not None for r in self.slot_req)
        t0 = time.perf_counter()
        out = self._guarded(
            lambda: self.engine.decode_step(self.slot_tok, self.slot_pos)
        )
        if out is not None:
            self.metrics.observe_decode(
                n_active, (time.perf_counter() - t0) * 1e3
            )
        return out

    def _decode(self) -> None:
        before = [r for r in self.slot_req if r is not None]
        super()._decode()
        for r in before:
            if r.done:
                self.metrics.observe_completion(
                    (r.t_done - r.arrival) * 1e3,
                    (r.t_first - r.arrival) * 1e3,
                )

    # -- driver -------------------------------------------------------------

    def _health_tick(self) -> None:
        before = self.health.state
        self.health.tick(
            queue_frac=len(self.queue) / max(1, self.queue_capacity),
            breaker_open=self.breaker.state != "closed",
            p95_ms=self.metrics.latency_ms.percentile(95),
        )
        if self.health.state != before:
            obs.point("serve.health", state=self.health.state,
                      was=before)

    def run(self, trace: Sequence[Request]) -> GatewayStats:
        """Replay a trace. Same scheduling loop as the batcher, plus: expiry
        sweeps, health ticks, and breaker gating — while the breaker is open
        nothing touches the engine (active work parks, arrivals keep being
        admitted/shed) until the cooldown permits the half-open probe."""
        self._t0 = time.perf_counter()
        i = 0
        trace = sorted(trace, key=lambda r: r.arrival)
        while True:
            now = self._now()
            while i < len(trace) and trace[i].arrival <= now:
                self.submit(trace[i])
                i += 1
            self._expire(now)
            # _sample_occupancy strides its own gauge writes; stride the
            # ServeMetrics series the same way (control logic reads
            # len(self.queue) directly, never these telemetry samples)
            n_active = self._sample_occupancy()
            if self._obs_tick % TELEMETRY_SAMPLE_STRIDE == 1:
                self.metrics.queue_depth = len(self.queue)
                self.metrics.observe_slots(n_active, len(self.slot_req))
            self._health_tick()
            allowed = self.breaker.allow(now)
            if allowed:
                self._join()
            active = any(r is not None for r in self.slot_req)
            if active and allowed:
                self._decode()
            elif active or self.queue:
                # parked: open breaker (or a probe just failed) — wait out
                # a slice of the cooldown; expiry sweeps bound this
                time.sleep(0.001)
            elif i < len(trace):
                time.sleep(
                    min(0.001, max(0.0, trace[i].arrival - self._now()))
                )
            else:
                break
        wall = self._now()
        # drained and idle: let hysteresis walk the health state back down
        # (bounded — a still-open breaker keeps it browned_out, honestly)
        for _ in range(4 * self.health.thresholds.recovery_ticks):
            if self.health.state == HEALTHY:
                break
            self.health.tick(
                queue_frac=0.0,
                breaker_open=self.breaker.state != "closed",
            )
        # feed the engine's compile surface into obs gauges: entry growth
        # after warmup is a recompile event (fake engines in tests may not
        # expose the surface)
        entry_sizes = getattr(self.engine, "jit_entry_sizes", None)
        if entry_sizes is not None:
            obs.record_compile_counts(
                {"/".join(map(str, k)): v
                 for k, v in entry_sizes().items()},
                prefix="serve_jit_entries",
            )
        serve = _finalize(
            trace, wall, self.decode_steps, self.prefill_calls, self.engine
        )
        c = self.metrics.counters
        return GatewayStats(
            serve=serve,
            shed=dict(self.metrics.shed),
            retries=int(c.get("retries", 0)),
            engine_call_failures=int(c.get("engine_call_failures", 0)),
            breaker_trips=self.breaker.trips,
            breaker_reopens=self.breaker.reopens,
            breaker_closes=self.breaker.closes,
            breaker_final_state=self.breaker.state,
            health_final=self.health.state,
            health_states_seen=sorted(self.health.states_seen),
            health_transitions=len(self.health.transitions),
            brownout_clamped=int(c.get("brownout_clamped", 0)),
            max_queue_depth=self.max_queue_depth,
            last_errors=list(self._errors),
            metrics=self.metrics.snapshot(),
        )

    # -- health / metrics surface (DESIGN.md §11) ----------------------------

    def prometheus_text(self) -> str:
        """Prometheus text snapshot: readiness + health level + breaker
        state prepended to the full ``ServeMetrics`` exposition."""
        level = {HEALTHY: 0, DEGRADED: 1, BROWNED_OUT: 2}[self.health.state]
        breaker = {"closed": 0, "half_open": 1, "open": 2}[self.breaker.state]
        lines = [
            "# TYPE serve_ready gauge",
            f"serve_ready {int(self.health.ready)}",
            "# TYPE serve_health_level gauge",
            f"serve_health_level {level}",
            "# TYPE serve_breaker_state gauge",
            f"serve_breaker_state {breaker}",
        ]
        return "\n".join(lines) + "\n" + self.metrics.prometheus_text()

    def health_snapshot(self) -> Dict:
        """The gateway's health surface: what a readiness probe / scrape
        endpoint would serve."""
        return {
            "ready": self.health.ready,
            "state": self.health.state,
            "breaker": self.breaker.state,
            "queue_depth": len(self.queue),
            "slots_active": sum(r is not None for r in self.slot_req),
            "prometheus": self.prometheus_text(),
        }
