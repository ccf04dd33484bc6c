"""The port's serving control plane (``repro_torch.serve.metrics``,
``repro_torch.serve.gateway``) against the reference's: the twins of
``tests/test_gateway.py``'s 22 tests, on the CPU.

Every scenario runs once through each package, with the same fake engine
and the same fake clock: the gateway modules' ``time`` is replaced by a
clock that only ``sleep`` advances (an engine call sleeps ``step_s``), and
the metrics windows and the health monitor read it too, so a run is a
deterministic simulation. The logic is pure, so every request's
disposition, ``GatewayStats``, the breaker's counters and the health
states and transitions must be EXACTLY the reference's; each twin then
makes the reference test's own assertions on the port's result.
"""
import dataclasses
import math
import types

import numpy as np
import pytest

pytest.importorskip("jax")  # the reference; the card's machine has none

from repro.runtime import faultinject as jfi  # noqa: E402
from repro.serve import batcher as jbatcher  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import gateway as jgateway  # noqa: E402
from repro.serve import metrics as jmetrics  # noqa: E402
from repro_torch.runtime import faultinject as tfi  # noqa: E402
from repro_torch.serve import batcher as tbatcher  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import gateway as tgateway  # noqa: E402
from repro_torch.serve import metrics as tmetrics  # noqa: E402

REF = types.SimpleNamespace(name="reference", fi=jfi, batcher=jbatcher, engine=jengine,
                            gateway=jgateway, metrics=jmetrics)
PORT = types.SimpleNamespace(name="port", fi=tfi, batcher=tbatcher, engine=tengine,
                             gateway=tgateway, metrics=tmetrics)


class FakeClock:
    """The simulation's clock: ``perf_counter`` and ``monotonic`` read it,
    ``sleep`` advances it."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        # a real sleep takes at least a microsecond: a shorter step could
        # vanish in the clock's rounding and stall the loop that waits
        self.t += max(1e-6, float(dt))

    def module(self):
        return types.SimpleNamespace(perf_counter=self, monotonic=self, sleep=self.sleep)


@pytest.fixture
def sim(monkeypatch):
    """The fake clock, installed as ``time`` of both packages' gateway and
    batcher modules."""
    clock = FakeClock()
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.gateway, "time", clock.module())
        monkeypatch.setattr(pkg.batcher, "time", clock.module())
    return clock


class FakeEngine:
    """Engine-shaped stub: the slot/bucket surface and fault-hook seam of
    ``SparseInferenceEngine``, a constant call latency on the fake clock."""

    kind = "lm"

    def __init__(self, cfg, clock: FakeClock, step_s: float = 0.001):
        self.cfg = cfg
        self.clock = clock
        self.step_s = step_s
        self.fault_hook = None
        self._engine_calls = 0
        self.stats = {}

    def _enter(self, op: str) -> None:
        idx = self._engine_calls
        self._engine_calls += 1
        if self.fault_hook is not None:
            self.fault_hook(op, idx)

    def bucket_for(self, L: int):
        for b in self.cfg.prefill_buckets:
            if b >= L:
                return b
        return None

    def prefill(self, prompts, slots):
        self._enter("prefill")
        self.clock.sleep(self.step_s)
        return np.ones(len(prompts), np.int32)

    def decode_step(self, tok, pos):
        self._enter("decode")
        self.clock.sleep(self.step_s)
        return np.ones(self.cfg.max_slots, np.int32)


def _cfg(pkg, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("prefill_batch", 2)
    return pkg.engine.EngineConfig(**kw)


def _gateway(pkg, clock, engine=None, *, queue_capacity=16, **gw_kw):
    """A gateway whose metrics windows and health monitor read ``clock``."""
    gc = pkg.gateway.GatewayConfig(**gw_kw)
    gw = pkg.gateway.ServingGateway(engine or FakeEngine(_cfg(pkg), clock), gateway=gc,
                                    queue_capacity=queue_capacity)
    gw.metrics = pkg.metrics.ServeMetrics(gc.metrics_window_s, clock=clock)
    gw.health = pkg.metrics.HealthMonitor(gc.health, clock=clock)
    return gw


def _req(pkg, rid=0, *, L=4, new=4, arrival=0.0, deadline=None):
    return pkg.batcher.Request(rid=rid, prompt=np.zeros((L,), np.int32), max_new_tokens=new,
                               arrival=arrival, deadline_s=deadline)


def _same(a, b, path="result"):
    """Exact equality, NaN equal to NaN, through dicts, lists, tuples and
    dataclasses."""
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario, clock=None):
    """Run ``scenario(pkg, clock)`` for the reference, then the port, each
    with the clock (``clock``, or a fresh one) at the same start; assert
    their records equal and return the port's."""
    out = []
    for pkg in (REF, PORT):
        clk = clock or FakeClock()
        clk.t = 100.0
        out.append(scenario(pkg, clk))
    _same(out[1], out[0])
    return out[1]


def _disposition(r):
    return dict(rid=r.rid, tokens=list(r.tokens), max_new=r.max_new_tokens,
                rejected=r.rejected, failed=r.failed, deadline=r.deadline_s,
                t_first=float(r.t_first), t_done=float(r.t_done))


# ---------------------------------------------------------------------------
# rolling windows
# ---------------------------------------------------------------------------


def test_rolling_window_empty_reads_nan():
    def scenario(pkg, clk):
        w = pkg.metrics.RollingWindow(5.0, clock=clk)
        return dict(p95=w.percentile(95), mean=w.mean(), rate=w.rate_per_s(), n=w.count())

    got = both(scenario)
    assert math.isnan(got["p95"]) and math.isnan(got["mean"]) and math.isnan(got["rate"])
    assert got["n"] == 0


def test_rolling_window_trims_by_time():
    def scenario(pkg, clk):
        clk.t = 0.0
        w = pkg.metrics.RollingWindow(1.0, clock=clk)
        w.observe(10.0)
        clk.t = 0.5
        w.observe(20.0)
        mean = w.mean()
        clk.t = 1.2  # the first sample (t=0) is now older than the 1 s horizon
        vals = w.values()
        clk.t = 3.0  # everything expired: back to "no data", not 0
        return dict(mean=mean, values=vals, p50=w.percentile(50))

    got = both(scenario)
    assert got["mean"] == 15.0 and got["values"] == [20.0] and math.isnan(got["p50"])


def test_rolling_window_rate_needs_spanning_samples():
    def scenario(pkg, clk):
        clk.t = 0.0
        w = pkg.metrics.RollingWindow(5.0, clock=clk)
        w.observe(4.0)
        one = w.rate_per_s()  # one sample: no measurable span
        clk.t = 2.0
        w.observe(4.0)
        return dict(one=one, two=w.rate_per_s())

    got = both(scenario)
    assert math.isnan(got["one"]) and got["two"] == pytest.approx(4.0)  # 8 tokens over 2 s


# ---------------------------------------------------------------------------
# health state machine
# ---------------------------------------------------------------------------


def _health(pkg, clk, **th):
    return pkg.metrics.HealthMonitor(pkg.metrics.HealthThresholds(**th), clock=clk)


def test_health_escalates_immediately_and_recovers_hysteretically():
    def scenario(pkg, clk):
        h = _health(pkg, clk, recovery_ticks=3)
        states = [h.tick(queue_frac=0.95)] + [h.tick(queue_frac=0.0) for _ in range(6)]
        return dict(states=states, seen=sorted(h.states_seen), transitions=h.transitions)

    got = both(scenario)
    B, D, H = tmetrics.BROWNED_OUT, tmetrics.DEGRADED, tmetrics.HEALTHY
    # one hot observation jumps straight to the target level; recovery takes
    # recovery_ticks calm ticks per level, one level at a time
    assert got["states"] == [B, B, B, D, D, D, H]
    assert got["seen"] == sorted({H, D, B})


def test_health_hot_tick_resets_recovery_count():
    def scenario(pkg, clk):
        h = _health(pkg, clk, recovery_ticks=2)
        for q in (0.6, 0.0, 0.6, 0.0):  # degraded, calm 1/2, hot again, calm 1/2
            h.tick(queue_frac=q)
        last = h.tick(queue_frac=0.0)
        return dict(last=last, transitions=h.transitions)

    got = both(scenario)
    assert got["last"] == tmetrics.HEALTHY  # needed 2 fresh calm ticks
    assert tuple(got["transitions"][-1][1:]) == (tmetrics.DEGRADED, tmetrics.HEALTHY)


def test_health_breaker_open_forces_brownout():
    def scenario(pkg, clk):
        h = _health(pkg, clk)
        return dict(state=h.tick(queue_frac=0.0, breaker_open=True), ready=h.ready)

    got = both(scenario)
    assert got["state"] == tmetrics.BROWNED_OUT and not got["ready"]


def test_health_p95_signal_degrades_but_nan_never_trips():
    def scenario(pkg, clk):
        h = _health(pkg, clk, degrade_p95_ms=100.0)
        # NaN p95 (an empty window) is "no data", not "slow"
        return [h.tick(queue_frac=0.0, p95_ms=float("nan")), h.tick(queue_frac=0.0, p95_ms=250.0)]

    assert both(scenario) == [tmetrics.HEALTHY, tmetrics.DEGRADED]


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


def _breaker_state(b):
    return dict(state=b.state, failures=b.failures, trips=b.trips, reopens=b.reopens,
                closes=b.closes, opened_at=b.opened_at)


def test_breaker_trips_on_consecutive_failures_only():
    def scenario(pkg, clk):
        b = pkg.gateway.CircuitBreaker(threshold=3, cooldown_s=1.0)
        b.record_failure(0.0)
        b.record_failure(0.0)
        b.record_success()  # streak broken
        b.record_failure(0.1)
        b.record_failure(0.1)
        mid = _breaker_state(b)
        b.record_failure(0.2)
        return dict(mid=mid, end=_breaker_state(b))

    got = both(scenario)
    assert got["mid"]["state"] == "closed"
    assert got["end"]["state"] == "open" and got["end"]["trips"] == 1


def test_breaker_cooldown_probe_cycle():
    def scenario(pkg, clk):
        b = pkg.gateway.CircuitBreaker(threshold=1, cooldown_s=1.0)
        trail = []
        b.record_failure(0.0)
        trail.append(_breaker_state(b))
        trail.append(b.allow(0.5))  # still cooling down
        trail.append(b.allow(1.1))  # the cooldown elapsed: ONE probe
        trail.append(_breaker_state(b))
        b.record_failure(1.2)  # the probe failed: open again, a fresh cooldown
        trail.append(_breaker_state(b))
        trail.append(b.allow(1.5))
        trail.append(b.allow(2.3))
        b.record_success()  # the probe succeeded
        trail.append(_breaker_state(b))
        return trail

    t = both(scenario)
    assert t[0]["state"] == "open" and t[1] is False and t[2] is True
    assert t[3]["state"] == "half_open"
    assert t[4]["state"] == "open" and t[4]["reopens"] == 1
    assert t[5] is False and t[6] is True
    assert t[7]["state"] == "closed" and t[7]["closes"] == 1


def test_breaker_open_ignores_stray_success():
    def scenario(pkg, clk):
        # only the half-open PROBE may close the breaker
        b = pkg.gateway.CircuitBreaker(threshold=1, cooldown_s=10.0)
        b.record_failure(0.0)
        b.record_success()
        return dict(b=_breaker_state(b), allow=b.allow(1.0))

    got = both(scenario)
    assert got["b"]["state"] == "open" and got["allow"] is False


# ---------------------------------------------------------------------------
# admission ladder
# ---------------------------------------------------------------------------


def _shed_record(gw, reqs):
    return dict(requests=[_disposition(r) for r in reqs], shed=dict(gw.metrics.shed),
                counters=dict(gw.metrics.counters), queue=[r.rid for r in gw.queue])


def test_submit_stamps_default_deadline():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, default_deadline_s=2.0)
        r = _req(pkg, arrival=1.0)
        ok = gw.submit(r)
        explicit = _req(pkg, rid=1, arrival=1.0, deadline=1.5)
        gw.submit(explicit)
        return dict(ok=ok, **_shed_record(gw, [r, explicit]))

    got = both(scenario)
    assert got["ok"]
    assert got["requests"][0]["deadline"] == pytest.approx(3.0)
    assert got["requests"][1]["deadline"] == 1.5  # the caller's SLO wins over the default


def test_brownout_clamps_max_new_tokens_before_shedding():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, degraded_max_new_tokens=2)
        gw.health.state = pkg.metrics.DEGRADED
        r = _req(pkg, new=10)
        return dict(ok=gw.submit(r), **_shed_record(gw, [r]))

    got = both(scenario)
    assert got["ok"]  # admitted: browned out, not shed
    assert got["requests"][0]["max_new"] == 2
    assert got["counters"]["brownout_clamped"] == 1


def test_degraded_shrinks_admission_queue():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, queue_capacity=8, degraded_queue_frac=0.5)
        reqs = [_req(pkg, rid=i) for i in range(4)]
        oks = [gw.submit(r) for r in reqs]
        gw.health.state = pkg.metrics.DEGRADED  # the effective capacity is 8 * 0.5 = 4
        r = _req(pkg, rid=9)
        oks.append(gw.submit(r))
        return dict(oks=oks, **_shed_record(gw, reqs + [r]))

    got = both(scenario)
    assert got["oks"] == [True] * 4 + [False]
    assert got["requests"][-1]["rejected"] == "shed: degraded admission limit"
    assert got["shed"]["admission_limit"] == 1


def test_browned_out_admits_only_a_trickle():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, queue_capacity=8, brownout_queue_len=2)
        gw.health.state = pkg.metrics.BROWNED_OUT
        reqs = [_req(pkg, rid=i) for i in range(3)]
        return dict(oks=[gw.submit(r) for r in reqs], **_shed_record(gw, reqs))

    got = both(scenario)
    assert got["oks"] == [True, True, False]
    assert "browned_out admission limit" in got["requests"][2]["rejected"]


def test_predicted_deadline_miss_sheds_only_with_evidence():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, default_deadline_s=0.05, admission_safety=1.0)
        first = _req(pkg, rid=0, new=50, L=4)
        cold = gw.submit(first)  # a cold decode-rate window: no evidence, admit
        now = clk()
        gw.metrics.decode_tokens.observe(4, t=now - 0.1)  # warm: 80 tok/s measured
        gw.metrics.decode_tokens.observe(4, t=now)
        r = _req(pkg, rid=1, new=50, L=4)  # ~1.2 s of work against a 50 ms SLO
        return dict(cold=cold, warm=gw.submit(r), **_shed_record(gw, [first, r]))

    got = both(scenario)
    assert got["cold"] and not got["warm"]
    assert got["requests"][1]["rejected"] == "shed: predicted deadline miss"
    assert got["shed"]["predicted_deadline_miss"] == 1


def test_static_rejections_still_counted():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk)
        r = _req(pkg, L=17)  # > the largest prefill bucket (16)
        return dict(ok=gw.submit(r), **_shed_record(gw, [r]))

    got = both(scenario)
    assert not got["ok"] and "bucket" in got["requests"][0]["rejected"]
    assert got["shed"]["static_admission"] == 1


# ---------------------------------------------------------------------------
# deadline enforcement
# ---------------------------------------------------------------------------


def test_expire_sweeps_queue_and_evicts_slots():
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, default_deadline_s=None)
        queued, live = _req(pkg, rid=0, deadline=1.0), _req(pkg, rid=1, deadline=9.0)
        gw.queue.append(queued)
        gw.queue.append(live)
        running = _req(pkg, rid=2, deadline=1.0)
        gw.slot_req[0] = running
        gw.slot_pos[0] = 5
        gw._expire(now=2.0)
        return dict(slot0=gw.slot_req[0] is None, pos0=int(gw.slot_pos[0]),
                    done=running.done, met=running.deadline_met,
                    **_shed_record(gw, [queued, live, running]))

    got = both(scenario)
    assert got["requests"][0]["rejected"] == "shed: expired in queue"
    assert got["queue"] == [1]
    assert got["requests"][2]["failed"] == "deadline_expired"
    assert got["slot0"] and got["pos0"] == 64 - 1  # the slot is freed for work that can win
    assert not got["done"] and not got["met"]


# ---------------------------------------------------------------------------
# guarded calls and whole runs
# ---------------------------------------------------------------------------


def test_guarded_retries_then_fails_into_breaker(sim):
    def scenario(pkg, clk):
        gw = _gateway(pkg, clk, retry_limit=2, retry_backoff_s=0.0, breaker_threshold=2)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return "ok"

        def dead():
            raise RuntimeError("down")

        rec = dict(flaky=gw._guarded(flaky), retries=gw.metrics.counters["retries"],
                   failures=gw.breaker.failures)
        rec["dead1"], rec["state1"] = gw._guarded(dead), gw.breaker.state
        rec["dead2"], rec["state2"] = gw._guarded(dead), gw.breaker.state
        rec["engine_call_failures"] = gw.metrics.counters["engine_call_failures"]
        rec["errors"] = list(gw._errors)
        return rec

    got = both(scenario, sim)
    assert got["flaky"] == "ok" and got["retries"] == 2 and got["failures"] == 0
    assert got["dead1"] is None and got["state1"] == "closed"  # 1 of 2 failures
    assert got["dead2"] is None and got["state2"] == "open"
    assert got["engine_call_failures"] == 2 and len(got["errors"]) > 0


def _run(pkg, clock, gateway_kw, *, chaos=None, n=40, step_s=0.001):
    """One gateway run over a 40-request Poisson trace at 2,000 req/s on the
    fake engine, as the reference test's ``_run``; returns the record the
    packages must agree on."""
    eng = FakeEngine(_cfg(pkg), clock, step_s=step_s)
    eng.fault_hook = chaos(pkg) if chaos is not None else None
    gw = _gateway(pkg, clock, eng, **gateway_kw)
    trace = pkg.batcher.poisson_trace(n, rate=2000.0, vocab=100, prompt_lens=(3, 8),
                                      new_tokens=(3, 6), seed=0)
    st = gw.run(trace)
    return dict(stats=st, requests=[_disposition(r) for r in sorted(trace, key=lambda r: r.rid)],
                transitions=gw.health.transitions, engine_calls=eng._engine_calls,
                health=dict(gw.health_snapshot()))


def _one_disposition(rec):
    for r in rec["requests"]:
        assert sum([r["failed"] is None and len(r["tokens"]) >= r["max_new"],
                    r["rejected"] is not None, r["failed"] is not None]) == 1, r


def test_clean_run_every_request_disposed_exactly_once(sim):
    got = both(lambda pkg, clk: _run(pkg, clk, dict(default_deadline_s=1.0)), sim)
    _one_disposition(got)
    st = got["stats"]
    s = st.serve
    assert s.completed + s.rejected + s.failed == 40
    assert s.completed > 0 and s.goodput_tok_s > 0
    assert st.breaker_trips == 0 and st.health_final == tmetrics.HEALTHY


def test_chaos_run_retries_trips_probes_and_recovers(sim):
    # singles are absorbed by one retry each; a contiguous burst of 6 call
    # indices with retry_limit=1 is 3 consecutive exhausted guarded calls
    def chaos(pkg):
        return pkg.fi.EngineChaos(pkg.fi.TransientFaultInjector(
            sorted(set(range(10, 16)) | {4, 22, 27}), persistent=1), sleep=sim.sleep)

    kw = dict(default_deadline_s=0.5, retry_limit=1, retry_backoff_s=0.001,
              breaker_threshold=3, breaker_cooldown_s=0.02)

    def scenario(pkg, clk):
        return _run(pkg, clk, dict(kw, health=pkg.metrics.HealthThresholds(recovery_ticks=3)),
                    chaos=chaos)

    got = both(scenario, sim)
    _one_disposition(got)  # the gateway never raises; every request is disposed
    st = got["stats"]
    assert st.retries >= 3
    assert st.engine_call_failures >= 3
    assert st.breaker_trips >= 1
    assert st.breaker_closes >= 1  # the half-open probe succeeded
    assert st.breaker_final_state == "closed"
    assert tmetrics.BROWNED_OUT in st.health_states_seen  # the open breaker was seen
    assert st.health_final == tmetrics.HEALTHY  # hysteresis walked it back down
    assert st.health_transitions >= 2
    assert st.serve.completed > 0


def test_dead_engine_terminates_via_deadlines_without_raising(sim):
    class DeadChaos:
        def __call__(self, op, idx):
            raise RuntimeError("engine is gone")

    got = both(lambda pkg, clk: _run(
        pkg, clk, dict(default_deadline_s=0.05, retry_limit=1, retry_backoff_s=0.001,
                       breaker_threshold=2, breaker_cooldown_s=0.02),
        chaos=lambda pkg: DeadChaos(), n=10), sim)
    s = got["stats"].serve
    # the liveness backstop: deadlines drain the queue, the run ends, and
    # nothing reached the caller as an exception
    assert s.completed == 0 and s.rejected + s.failed == 10
    assert got["stats"].breaker_trips >= 1
    assert got["stats"].breaker_final_state != "closed"  # honestly still sick
    assert got["stats"].health_final == tmetrics.BROWNED_OUT
    assert math.isnan(s.latency_p50_ms) and math.isnan(s.ttft_p50_ms)


def test_finalize_zero_completions_reads_nan_not_zero():
    class StubEngine:
        stats = {}

    def scenario(pkg, clk):
        r = _req(pkg, rid=0)
        r.rejected = "queue full"
        return pkg.batcher._finalize([r], wall=1.0, decode_steps=0, prefill_calls=0,
                                     engine=StubEngine())

    st = both(scenario)
    assert st.completed == 0 and st.rejected == 1
    assert all(math.isnan(v) for v in (st.latency_p50_ms, st.latency_p95_ms,
                                       st.latency_p99_ms, st.ttft_p50_ms))
    assert st.throughput_tok_s == 0.0 and st.goodput_tok_s == 0.0
