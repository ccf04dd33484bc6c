"""Run timeline store: schema-versioned JSONL time-series of training-
dynamics snapshots, keyed by ``(run_id, step)`` (DESIGN.md §12).

Twin of ``repro.obs.timeline``, a copy (it needs no framework).

The trace (``obs.trace``) answers "where did the time go"; the timeline
answers "what was the *model* doing" — one snapshot per probe point
(epoch/round boundary), each carrying the per-layer stat dicts produced
by :mod:`repro_torch.obs.probes`. A separate file from the trace on purpose:
timelines are tiny (O(epochs) lines), diffable across runs, and read by
tools that must not parse a span forest.

Line schema (one JSON object per line; ``ev`` discriminates):

* ``{"ev":"meta","schema":1,"run_id":...,"unix":...,"attrs":{...}}`` —
  first line.
* ``{"ev":"snapshot","run_id":...,"step":n,"kind":"train|wasap|xl|...",
  "t":monotonic,"layers":[{stat:val,...},...],"extra":{...}}``
* ``{"ev":"alert","run_id":...,"step":n,"rule":...,"kind":...,
  "layer":i|null,"value":...,"threshold":...,"message":...}`` — appended
  by ``probes.record_snapshot`` when the anomaly monitor fires.

Writes are line-buffered appends through a tmp-free ``'w'`` handle —
a timeline belongs to exactly one run; diffing runs means diffing files.
``python -m repro_torch.obs report|diff`` renders/compares them.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import Any, Dict, IO, List, Optional, Union

from repro_torch.obs import _state

__all__ = [
    "TIMELINE_SCHEMA_VERSION",
    "TimelineWriter",
    "configure",
    "current",
    "timeline_to",
    "read_timeline",
    "validate_timeline",
    "snapshots",
    "alerts",
    "render_report",
    "render_diff",
]

TIMELINE_SCHEMA_VERSION = 1

_writer: Optional["TimelineWriter"] = None
_writer_lock = threading.Lock()


class TimelineWriter:
    """Serializes snapshot/alert events for ONE run to a JSONL sink.

    Unlike the trace's deferred buffer, snapshots are flushed per write:
    they are epoch-cadence (never hot-path) and the progress/health
    surface must survive a SIGKILL mid-run.
    """

    def __init__(
        self,
        sink: Union[str, os.PathLike, IO[str]],
        run_id: str,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.run_id = str(run_id)
        self._owns_file = isinstance(sink, (str, os.PathLike))
        self._fh: IO[str] = (
            open(sink, "w", encoding="utf-8") if self._owns_file else sink
        )
        self._lock = threading.Lock()
        self.events_written = 0
        self._write({
            "ev": "meta", "schema": TIMELINE_SCHEMA_VERSION,
            "run_id": self.run_id, "unix": int(time.time()),
            "attrs": dict(attrs or {}),
        })

    def _write(self, event: Dict[str, Any]) -> None:
        _state.note_alloc()
        line = json.dumps(event, separators=(",", ":"), default=str)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            self.events_written += 1

    def record(
        self, step: int, kind: str, layers: List[dict],
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._write({
            "ev": "snapshot", "run_id": self.run_id, "step": int(step),
            "kind": str(kind), "t": time.perf_counter(),
            "layers": layers, "extra": dict(extra or {}),
        })

    def alert(self, alert: Dict[str, Any]) -> None:
        self._write({"ev": "alert", "run_id": self.run_id, **alert})

    def close(self) -> None:
        if self._owns_file:
            self._fh.close()


def configure(
    path: Union[str, os.PathLike, IO[str], None] = None,
    run_id: str = "run",
    attrs: Optional[Dict[str, Any]] = None,
) -> Optional[TimelineWriter]:
    """Install (or, with ``None``, remove) the process-global timeline."""
    global _writer
    with _writer_lock:
        old, _writer = _writer, None
        if old is not None:
            old.close()
        if path is not None:
            _writer = TimelineWriter(path, run_id, attrs=attrs)
        return _writer


def current() -> Optional[TimelineWriter]:
    return _writer


@contextlib.contextmanager
def timeline_to(
    path: Union[str, os.PathLike, IO[str]],
    run_id: str = "run",
    attrs: Optional[Dict[str, Any]] = None,
):
    """Scoped timeline: install for the block, close (and restore any
    previous writer) after — mirrors ``obs.trace_to``."""
    global _writer
    with _writer_lock:
        prev = _writer
        _writer = TimelineWriter(path, run_id, attrs=attrs)
        w = _writer
    try:
        yield w
    finally:
        with _writer_lock:
            _writer = prev
        w.close()


# ---------------------------------------------------------------------------
# reading / validation
# ---------------------------------------------------------------------------


def read_timeline(path) -> List[dict]:
    events = []
    with open(path, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                events.append({"ev": "_unparseable", "line": i + 1,
                               "error": str(e)})
    return events


def validate_timeline(events: List[dict]) -> List[str]:
    """Schema check; returns a list of human-readable errors (empty =
    valid). Mirrors ``obs.export.validate_events`` for the trace."""
    errors: List[str] = []
    if not events:
        return ["empty timeline"]
    meta = events[0]
    if meta.get("ev") != "meta":
        errors.append("first event is not a meta line")
        run_id = None
    else:
        if meta.get("schema") != TIMELINE_SCHEMA_VERSION:
            errors.append(
                f"unknown schema {meta.get('schema')!r} "
                f"(expected {TIMELINE_SCHEMA_VERSION})"
            )
        run_id = meta.get("run_id")
        if not isinstance(run_id, str) or not run_id:
            errors.append("meta line missing run_id")
    for i, ev in enumerate(events[1:], start=2):
        kind = ev.get("ev")
        where = f"line {i}"
        if kind == "_unparseable":
            errors.append(f"{where}: unparseable JSON ({ev.get('error')})")
            continue
        if kind == "meta":
            errors.append(f"{where}: duplicate meta line")
            continue
        if kind not in ("snapshot", "alert"):
            errors.append(f"{where}: unknown ev {kind!r}")
            continue
        if run_id is not None and ev.get("run_id") != run_id:
            errors.append(f"{where}: run_id {ev.get('run_id')!r} != meta "
                          f"run_id {run_id!r}")
        if not isinstance(ev.get("step"), int) or ev["step"] < 0:
            errors.append(f"{where}: bad step {ev.get('step')!r}")
        if kind == "snapshot":
            layers = ev.get("layers")
            if not isinstance(layers, list):
                errors.append(f"{where}: snapshot layers is not a list")
                continue
            for li, st in enumerate(layers):
                if not isinstance(st, dict):
                    errors.append(f"{where}: layer {li} stats not a dict")
                    continue
                for k, v in st.items():
                    ok = (
                        isinstance(v, (int, float))
                        and not isinstance(v, bool)
                    ) or (
                        isinstance(v, list)
                        and all(isinstance(x, (int, float)) for x in v)
                    )
                    if not ok:
                        errors.append(
                            f"{where}: layer {li} stat {k!r} is not numeric"
                        )
        else:  # alert
            if not ev.get("rule"):
                errors.append(f"{where}: alert missing rule")
    return errors


def snapshots(events: List[dict], kind: Optional[str] = None) -> List[dict]:
    return [
        ev for ev in events
        if ev.get("ev") == "snapshot" and (kind is None or ev["kind"] == kind)
    ]


def alerts(events: List[dict]) -> List[dict]:
    return [ev for ev in events if ev.get("ev") == "alert"]


# ---------------------------------------------------------------------------
# report / diff rendering
# ---------------------------------------------------------------------------

_TABLE_COLS = (
    ("grad_l2", "grad_l2"),
    ("value_l2", "val_l2"),
    ("value_zero_frac", "val_zero"),
    ("saturation", "sat"),
    ("churn_frac", "churn"),
    ("imp_q50", "imp_q50"),
    ("dead_out_frac", "dead_out"),
)


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if not math.isfinite(v):
        return str(v)
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.2e}"
    return f"{v:.4f}".rstrip("0").rstrip(".")


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [
        max(len(header[c]), *(len(r[c]) for r in rows)) if rows
        else len(header[c])
        for c in range(len(header))
    ]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    return "\n".join([line(header)] + [line(r) for r in rows])


def _health_table(snap: dict) -> str:
    header = ["layer"] + [short for _, short in _TABLE_COLS]
    rows = []
    for li, st in enumerate(snap.get("layers", [])):
        rows.append(
            [str(li)] + [_fmt(st.get(key)) for key, _ in _TABLE_COLS]
        )
    return _table(rows, header)


def render_report(events: List[dict]) -> str:
    """Per-layer health tables from a timeline: for each snapshot kind,
    the latest snapshot's table plus first→last trend lines and any
    alerts. This is what ``python -m repro_torch.obs report`` prints."""
    meta = events[0] if events and events[0].get("ev") == "meta" else {}
    snaps = snapshots(events)
    out: List[str] = []
    run_id = meta.get("run_id", "?")
    out.append(
        f"run {run_id} — {len(snaps)} snapshot(s)"
        + (f", steps {snaps[0]['step']}..{snaps[-1]['step']}" if snaps else "")
    )
    kinds = []
    for ev in snaps:
        if ev["kind"] not in kinds:
            kinds.append(ev["kind"])
    for kind in kinds:
        ks = snapshots(events, kind)
        last = ks[-1]
        extra = last.get("extra") or {}
        tag = " ".join(
            f"{k}={_fmt(v) if isinstance(v, float) else v}"
            for k, v in sorted(extra.items())
        )
        out.append("")
        out.append(f"[{kind}] step {last['step']}" + (f"  ({tag})" if tag else ""))
        out.append(_health_table(last))
        if len(ks) > 1:
            first = ks[0]
            trends = []
            for key, short in _TABLE_COLS:
                a = [st.get(key) for st in first.get("layers", [])]
                b = [st.get(key) for st in last.get("layers", [])]
                pairs = [
                    (x, y) for x, y in zip(a, b)
                    if isinstance(x, (int, float)) and isinstance(y, (int, float))
                    and x and math.isfinite(x) and math.isfinite(y)
                ]
                if pairs:
                    ratio = sum(y / x for x, y in pairs) / len(pairs)
                    trends.append(f"{short} x{ratio:.2f}")
            if trends:
                out.append(
                    f"trend vs step {first['step']}: " + ", ".join(trends)
                )
    al = alerts(events)
    out.append("")
    if al:
        out.append(f"alerts ({len(al)}):")
        for a in al:
            layer = a.get("layer")
            where = f" layer {layer}" if layer is not None else ""
            out.append(
                f"  [{a.get('kind', '?')}]{where} step {a.get('step')}: "
                f"{a.get('rule')} — {a.get('message', '')}"
            )
    else:
        out.append("alerts: none")
    return "\n".join(out)


def render_diff(events_a: List[dict], events_b: List[dict]) -> str:
    """Compare two runs' final snapshots per kind/layer/stat: B/A ratios,
    flagged with ``!`` beyond 2x either way — the regression-triage view
    of ``python -m repro_torch.obs diff``."""
    meta_a = events_a[0] if events_a and events_a[0].get("ev") == "meta" else {}
    meta_b = events_b[0] if events_b and events_b[0].get("ev") == "meta" else {}
    out = [
        f"A: run {meta_a.get('run_id', '?')} — "
        f"{len(snapshots(events_a))} snapshot(s), "
        f"{len(alerts(events_a))} alert(s)",
        f"B: run {meta_b.get('run_id', '?')} — "
        f"{len(snapshots(events_b))} snapshot(s), "
        f"{len(alerts(events_b))} alert(s)",
    ]
    kinds = []
    for ev in snapshots(events_a) + snapshots(events_b):
        if ev["kind"] not in kinds:
            kinds.append(ev["kind"])
    n_flagged = 0
    for kind in kinds:
        ka, kb = snapshots(events_a, kind), snapshots(events_b, kind)
        if not ka or not kb:
            out.append(f"\n[{kind}] only in {'A' if ka else 'B'} — skipped")
            continue
        la, lb = ka[-1], kb[-1]
        out.append(
            f"\n[{kind}] A step {la['step']} vs B step {lb['step']} "
            f"(B/A ratios, ! beyond 2x)"
        )
        header = ["layer"] + [short for _, short in _TABLE_COLS]
        rows = []
        for li, (sa, sb) in enumerate(zip(la["layers"], lb["layers"])):
            cells = [str(li)]
            for key, _ in _TABLE_COLS:
                va, vb = sa.get(key), sb.get(key)
                if not isinstance(va, (int, float)) \
                        or not isinstance(vb, (int, float)):
                    cells.append("-")
                    continue
                if va == 0 and vb == 0:
                    cells.append("x1.00")
                    continue
                if va == 0 or not math.isfinite(va) or not math.isfinite(vb):
                    cells.append(f"{_fmt(va)}->{_fmt(vb)}!")
                    n_flagged += 1
                    continue
                ratio = vb / va
                flag = "!" if (ratio > 2.0 or ratio < 0.5) else ""
                n_flagged += bool(flag)
                cells.append(f"x{ratio:.2f}{flag}")
            rows.append(cells)
        out.append(_table(rows, header))
    out.append(f"\n{n_flagged} stat(s) flagged beyond 2x")
    return "\n".join(out)
