"""Continuous batching over ``SparseInferenceEngine``. Twin of
``repro.serve.batcher``.

The decode batch is a fixed set of ``max_slots`` slots. Every scheduling
iteration:

1. **admit** — requests whose (Poisson) arrival time has passed enter the
   queue; a full queue rejects them (backpressure — the caller sees the
   rejection immediately instead of a timeout later).
2. **join** — while slots are free and the queue is non-empty, up to
   ``prefill_batch`` queued requests sharing a padding bucket are prefilled
   in ONE batched forward and join the decode batch *in place*; running
   slots are untouched.
3. **step** — one decode call advances ALL slots (inactive slots compute
   garbage that is ignored — shape stability is what keeps the engine's
   bucket count at one). Finished sequences are evicted, freeing their slot
   for the next join.

The traffic generator (``poisson_trace``) samples exponential interarrivals
(bursty arrivals, ragged lengths, overlapping lifetimes);
``serve_sequential`` is the naive one-request-at-a-time loop.

Telemetry, as the reference's: the ``serve_queue_depth`` and
``serve_slot_occupancy`` gauges, written every ``TELEMETRY_SAMPLE_STRIDE``-th
scheduling tick, and per request a ``serve.queue`` span (arrival to its
slot) and a ``serve.request`` span (arrival to its last token).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.serve.engine import SparseInferenceEngine

__all__ = [
    "ContinuousBatcher",
    "Request",
    "ServeStats",
    "TELEMETRY_SAMPLE_STRIDE",
    "poisson_trace",
    "serve_sequential",
]

# telemetry (queue depth / slot occupancy) is written every N-th scheduling
# tick, not every tick: the loop spins at decode-step rate
TELEMETRY_SAMPLE_STRIDE = 8


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (L,) int32 token ids
    max_new_tokens: int
    arrival: float = 0.0         # seconds from trace start
    deadline_s: Optional[float] = None  # absolute (trace clock); None = no SLO
    # filled in by the batcher:
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: float = float("nan")   # first generated token (from arrival)
    t_done: float = float("nan")
    rejected: Optional[str] = None  # backpressure / admission / shed reason
    failed: Optional[str] = None    # admitted but not served (engine fault,
                                    # deadline expiry) — gateway dispositions

    @property
    def done(self) -> bool:
        return self.failed is None and len(self.tokens) >= self.max_new_tokens

    @property
    def deadline_met(self) -> bool:
        """Completed within its SLO (vacuously true without a deadline)."""
        return self.done and (
            self.deadline_s is None or self.t_done <= self.deadline_s
        )


def poisson_trace(
    n: int,
    rate: float,
    *,
    vocab: int,
    prompt_lens=(4, 24),
    new_tokens=(4, 12),
    seed: int = 0,
    deadline_s: Optional[float] = None,
) -> List[Request]:
    """``n`` requests with exponential interarrivals at ``rate`` req/s,
    uniform prompt lengths and generation budgets. ``deadline_s`` stamps a
    relative SLO on every request (absolute deadline = arrival + deadline_s);
    the plain batcher ignores it, the gateway enforces it."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    out = []
    for i in range(n):
        L = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        out.append(
            Request(
                rid=i,
                prompt=rng.integers(0, vocab, L).astype(np.int32),
                max_new_tokens=int(
                    rng.integers(new_tokens[0], new_tokens[1] + 1)
                ),
                arrival=float(arrivals[i]),
                deadline_s=(
                    None if deadline_s is None
                    else float(arrivals[i]) + deadline_s
                ),
            )
        )
    return out


@dataclasses.dataclass
class ServeStats:
    wall_seconds: float
    generated_tokens: int
    completed: int
    rejected: int
    failed: int
    throughput_tok_s: float
    goodput_tok_s: float          # deadline-met tokens/s (== throughput of
                                  # completed work when no deadlines are set)
    deadline_met: int
    latency_p50_ms: float
    latency_p95_ms: float
    latency_p99_ms: float
    ttft_p50_ms: float
    decode_steps: int
    prefill_calls: int
    engine: Dict[str, float]

    def asdict(self) -> Dict:
        return dataclasses.asdict(self)


def _finalize(
    requests: Sequence[Request],
    wall: float,
    decode_steps: int,
    prefill_calls: int,
    engine: SparseInferenceEngine,
) -> ServeStats:
    done = [r for r in requests if r.done]
    met = [r for r in done if r.deadline_met]
    # zero completions => no latency data. Report NaN, NOT 0 ms: a collapsed
    # run must read as structurally failed downstream (serve_bench rows and
    # run.py --compare treat non-finite gated values as regressions), never
    # as an infinitely fast one.
    lat = (
        np.array([r.t_done - r.arrival for r in done]) * 1e3
        if done else np.array([np.nan])
    )
    ttft = (
        np.array([r.t_first - r.arrival for r in done]) * 1e3
        if done else np.array([np.nan])
    )
    tokens = sum(len(r.tokens) for r in requests)
    good_tokens = sum(len(r.tokens) for r in met)
    return ServeStats(
        wall_seconds=wall,
        generated_tokens=tokens,
        completed=len(done),
        rejected=sum(1 for r in requests if r.rejected),
        failed=sum(1 for r in requests if r.failed),
        throughput_tok_s=tokens / wall if wall > 0 else 0.0,
        goodput_tok_s=good_tokens / wall if wall > 0 else 0.0,
        deadline_met=len(met),
        latency_p50_ms=float(np.percentile(lat, 50)),
        latency_p95_ms=float(np.percentile(lat, 95)),
        latency_p99_ms=float(np.percentile(lat, 99)),
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        decode_steps=decode_steps,
        prefill_calls=prefill_calls,
        engine=dict(engine.stats),
    )


class ContinuousBatcher:
    def __init__(
        self,
        engine: SparseInferenceEngine,
        *,
        queue_capacity: int = 64,
    ):
        if engine.kind != "lm":
            raise TypeError("the continuous batcher serves an LM engine")
        self.engine = engine
        self.queue_capacity = queue_capacity
        self.queue: Deque[Request] = collections.deque()
        S = engine.cfg.max_slots
        self.slot_req: List[Optional[Request]] = [None] * S
        # inactive slots park at max_len-1: their (ignored) writes land in
        # the last cache row, which any future occupant overwrites before
        # attending it
        self.slot_pos = np.full((S,), engine.cfg.max_len - 1, np.int64)
        self.slot_tok = np.zeros((S,), np.int32)
        self.decode_steps = 0
        self.prefill_calls = 0
        # sampled telemetry gauges (resolved once; a no-op write under
        # obs.disabled()), written every TELEMETRY_SAMPLE_STRIDE-th tick
        _reg = obs.default_registry()
        self._obs_queue_gauge = _reg.gauge("serve_queue_depth")
        self._obs_slot_gauge = _reg.gauge("serve_slot_occupancy")
        self._obs_tick = 0

    def _sample_occupancy(self) -> int:
        """Telemetry sample of queue depth + slot occupancy (strided);
        returns the active-slot count so the scheduling loop reuses it."""
        n_active = sum(r is not None for r in self.slot_req)
        if self._obs_tick % TELEMETRY_SAMPLE_STRIDE == 0:
            self._obs_queue_gauge.set(len(self.queue))
            self._obs_slot_gauge.set(n_active / max(1, len(self.slot_req)))
        self._obs_tick += 1
        return n_active

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Admission control: bounded queue (backpressure) + static limits
        (bucket fit, KV capacity). Rejections are immediate and recorded."""
        eng = self.engine.cfg
        L = int(req.prompt.shape[0])
        if self.engine.bucket_for(L) is None:
            req.rejected = "prompt exceeds largest prefill bucket"
        elif L + req.max_new_tokens > eng.max_len:
            req.rejected = "prompt + generation exceeds max_len"
        elif len(self.queue) >= self.queue_capacity:
            req.rejected = "queue full"
        if req.rejected:
            return False
        self.queue.append(req)
        return True

    # -- scheduling ---------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_req) if r is None]

    def _join(self) -> None:
        """Prefill queued requests into free slots, one bucket-group at a
        time (FCFS: the head of the queue picks the bucket)."""
        while self.queue and (free := self._free_slots()):
            bucket = self.engine.bucket_for(int(self.queue[0].prompt.shape[0]))
            group: List[Request] = []
            rest: Deque[Request] = collections.deque()
            limit = min(len(free), self.engine.cfg.prefill_batch)
            while self.queue and len(group) < limit:
                r = self.queue.popleft()
                if self.engine.bucket_for(int(r.prompt.shape[0])) == bucket:
                    group.append(r)
                else:
                    rest.append(r)
            self.queue = rest + self.queue
            slots = free[: len(group)]
            first = self._call_prefill(group, slots)
            if first is None:
                # engine unavailable: the override already disposed of the
                # group (failed it, or parked it back at the queue head while
                # the breaker is open — slots were never occupied). Stop
                # joining this iteration; the next loop pass re-evaluates.
                break
            self.prefill_calls += 1
            t = self._now()
            for r, s, tok in zip(group, slots, first):
                # queue span: arrival -> admitted to a slot (absolute
                # monotonic endpoints: trace times share perf_counter)
                obs.event_span("serve.queue", self._t0 + r.arrival, self._t0 + t, rid=r.rid)
                r.tokens.append(int(tok))
                r.t_first = t
                if r.done:  # single-token request: done at prefill
                    r.t_done = t
                    obs.event_span("serve.request", self._t0 + r.arrival, self._t0 + t,
                                   rid=r.rid, tokens=len(r.tokens))
                    continue
                self.slot_req[s] = r
                self.slot_pos[s] = r.prompt.shape[0]
                self.slot_tok[s] = int(tok)

    # engine-call seams: the base batcher calls the engine directly (failures
    # propagate). ``serve.gateway.ServingGateway`` overrides these with its
    # retry/breaker layer and returns None when the engine is unavailable.

    def _call_prefill(self, group: List[Request], slots: List[int]):
        return self.engine.prefill([r.prompt for r in group], slots)

    def _call_decode(self):
        return self.engine.decode_step(self.slot_tok, self.slot_pos)

    def _decode(self) -> None:
        next_tok = self._call_decode()
        if next_tok is None:
            return  # engine unavailable this step (gateway breaker path)
        self.decode_steps += 1
        t = self._now()
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.tokens.append(int(next_tok[s]))
            self.slot_pos[s] += 1
            self.slot_tok[s] = int(next_tok[s])
            if r.done:
                r.t_done = t
                obs.event_span("serve.request", self._t0 + r.arrival, self._t0 + t,
                               rid=r.rid, tokens=len(r.tokens))
                self.slot_req[s] = None  # evict: slot joins the free pool
                self.slot_pos[s] = self.engine.cfg.max_len - 1
                self.slot_tok[s] = 0

    # -- driver -------------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def run(self, trace: Sequence[Request]) -> ServeStats:
        """Replay a trace against the wall clock: requests become visible at
        their arrival times, are admitted (or rejected), continuously
        batched, and decoded until the trace drains."""
        self._t0 = time.perf_counter()
        i = 0
        trace = sorted(trace, key=lambda r: r.arrival)
        while True:
            now = self._now()
            while i < len(trace) and trace[i].arrival <= now:
                self.submit(trace[i])
                i += 1
            self._join()
            active = self._sample_occupancy() > 0
            if active:
                self._decode()
            elif self.queue:
                continue
            elif i < len(trace):
                time.sleep(
                    min(0.001, max(0.0, trace[i].arrival - self._now()))
                )
            else:
                break
        wall = self._now()
        return _finalize(
            trace, wall, self.decode_steps, self.prefill_calls, self.engine
        )


def serve_sequential(
    engine: SparseInferenceEngine, trace: Sequence[Request]
) -> ServeStats:
    """The naive per-request loop — prefill one prompt, decode it to
    completion, only then look at the next request. Same engine primitives,
    no batching: the continuous batcher must beat this."""
    t0 = time.perf_counter()
    steps = 0
    prefills = 0
    for r in sorted(trace, key=lambda x: x.arrival):
        while time.perf_counter() - t0 < r.arrival:
            time.sleep(0.0005)
        tok = int(engine.prefill([r.prompt], [0])[0])
        prefills += 1
        r.tokens.append(tok)
        r.t_first = time.perf_counter() - t0
        pos = int(r.prompt.shape[0])
        while not r.done:
            tok = int(
                engine.decode_step(
                    np.full((engine.cfg.max_slots,), tok, np.int32),
                    np.full((engine.cfg.max_slots,), pos, np.int64),
                )[0]
            )
            steps += 1
            r.tokens.append(tok)
            pos += 1
        r.t_done = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    return _finalize(trace, wall, steps, prefills, engine)
