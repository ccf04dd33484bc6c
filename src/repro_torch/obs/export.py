"""Exporters: Prometheus text exposition, JSONL trace validation, and the
per-span summary behind ``python -m repro_torch.obs summarize`` (DESIGN.md §11).

Twin of ``repro.obs.export``, a copy (it needs no framework).

The Prometheus exporter renders a :class:`~repro_torch.obs.metrics.MetricsRegistry`
snapshot in the text exposition format (0.0.4): counters and gauges as-is,
histograms with cumulative ``_bucket{le=...}`` lines, rolling windows as
summaries with ``quantile`` labels. Output is deterministically ordered by
(name, labels) so it can be golden-tested.
"""
from __future__ import annotations

import collections
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.metrics import (
    Counter, Gauge, Histogram, MetricsRegistry, RollingWindow,
)
from repro_torch.obs.trace import SCHEMA_VERSION

__all__ = [
    "prometheus_text",
    "read_events",
    "validate_events",
    "summarize_events",
    "format_summary",
]


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_str(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every series in the registry as Prometheus exposition text."""
    lines: List[str] = []
    typed: set = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for s in registry.series():
        if isinstance(s, Counter):
            _type(s.name, "counter")
            lines.append(f"{s.name}{_labels_str(s.labels)} {_fmt(s.value)}")
        elif isinstance(s, Gauge):
            _type(s.name, "gauge")
            lines.append(f"{s.name}{_labels_str(s.labels)} {_fmt(s.value)}")
        elif isinstance(s, Histogram):
            _type(s.name, "histogram")
            cum = 0
            for bound, c in zip(s.bounds, s.counts):
                cum += c
                le = 'le="%s"' % _fmt(bound)
                lines.append(
                    f"{s.name}_bucket{_labels_str(s.labels, le)} {cum}"
                )
            cum += s.counts[-1]
            le = 'le="+Inf"'
            lines.append(
                f"{s.name}_bucket{_labels_str(s.labels, le)} {cum}"
            )
            lines.append(f"{s.name}_sum{_labels_str(s.labels)} {_fmt(s.sum)}")
            lines.append(f"{s.name}_count{_labels_str(s.labels)} {s.count}")
        elif isinstance(s, RollingWindow):
            _type(s.name, "summary")
            for q in (0.5, 0.95, 0.99):
                ql = 'quantile="%s"' % q
                lines.append(
                    f"{s.name}{_labels_str(s.labels, ql)} "
                    f"{_fmt(s.percentile(100 * q))}"
                )
            lines.append(
                f"{s.name}_count{_labels_str(s.labels)} {s.count()}"
            )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSONL trace reading / validation / summary
# ---------------------------------------------------------------------------

_REQUIRED: Dict[str, Tuple[str, ...]] = {
    "meta": ("schema", "pid", "t", "attrs"),
    "span": ("name", "id", "parent", "t0", "t1", "dur_s", "attrs"),
    "point": ("name", "t", "attrs"),
}


def read_events(path: str) -> List[Dict[str, Any]]:
    events = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def validate_events(events: Iterable[Dict[str, Any]]) -> List[str]:
    """Schema-check a trace: required keys per event type, numeric
    monotonic-clock fields, span durations consistent, parent ids known,
    meta first. Returns a list of human-readable errors (empty = valid)."""
    errors: List[str] = []
    seen_ids: set = set()
    for i, ev in enumerate(events):
        kind = ev.get("ev")
        if kind not in _REQUIRED:
            errors.append(f"event {i}: unknown ev {kind!r}")
            continue
        missing = [k for k in _REQUIRED[kind] if k not in ev]
        if missing:
            errors.append(f"event {i} ({kind}): missing keys {missing}")
            continue
        if i == 0:
            if kind != "meta":
                errors.append("event 0: first event must be 'meta'")
            elif ev["schema"] != SCHEMA_VERSION:
                errors.append(
                    f"event 0: schema {ev['schema']} != {SCHEMA_VERSION}"
                )
        if not isinstance(ev.get("attrs", {}), dict):
            errors.append(f"event {i} ({kind}): attrs must be an object")
        if kind == "span":
            for k in ("t0", "t1", "dur_s"):
                if not isinstance(ev[k], (int, float)):
                    errors.append(f"event {i}: span {k} must be numeric")
                    break
            else:
                if ev["t1"] < ev["t0"]:
                    errors.append(
                        f"event {i}: span {ev['name']!r} t1 < t0"
                    )
                if abs((ev["t1"] - ev["t0"]) - ev["dur_s"]) > 1e-6:
                    errors.append(
                        f"event {i}: span {ev['name']!r} dur_s inconsistent"
                    )
            if ev["id"] in seen_ids:
                errors.append(f"event {i}: duplicate span id {ev['id']}")
            seen_ids.add(ev["id"])
        if kind == "point" and not isinstance(ev["t"], (int, float)):
            errors.append(f"event {i}: point t must be numeric")
    # parents may close after children (span events are emitted at close),
    # so check referential integrity only after a full pass
    for i, ev in enumerate(events):
        if ev.get("ev") == "span" and ev.get("parent") is not None:
            if ev["parent"] not in seen_ids:
                errors.append(
                    f"event {i}: span {ev['name']!r} parent "
                    f"{ev['parent']} never closed"
                )
    return errors


def _percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return float("nan")
    rank = (p / 100.0) * (len(sorted_vals) - 1)
    lo, hi = int(math.floor(rank)), int(math.ceil(rank))
    if lo == hi:
        return sorted_vals[lo]
    frac = rank - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def summarize_events(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate spans by name: count, total/mean/p50/p95/p99 duration, and
    self-time (duration minus closed child spans). Points aggregate by
    name with counts."""
    spans = [e for e in events if e.get("ev") == "span"]
    points = [e for e in events if e.get("ev") == "point"]
    by_name: Dict[str, List[float]] = collections.defaultdict(list)
    child_time: Dict[int, float] = collections.defaultdict(float)
    name_of: Dict[int, str] = {}
    for s in spans:
        by_name[s["name"]].append(float(s["dur_s"]))
        name_of[s["id"]] = s["name"]
        if s.get("parent") is not None:
            child_time[s["parent"]] += float(s["dur_s"])
    self_by_name: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        self_by_name[s["name"]] += float(s["dur_s"]) - child_time.get(
            s["id"], 0.0
        )
    out_spans = {}
    for name, durs in sorted(by_name.items()):
        sv = sorted(durs)
        out_spans[name] = {
            "count": len(durs),
            "total_s": sum(durs),
            "self_s": self_by_name[name],
            "mean_s": sum(durs) / len(durs),
            "p50_s": _percentile(sv, 50),
            "p95_s": _percentile(sv, 95),
            "p99_s": _percentile(sv, 99),
        }
    out_points = collections.Counter(p["name"] for p in points)
    return {
        "n_events": len(spans) + len(points) + 1,
        "spans": out_spans,
        "points": dict(sorted(out_points.items())),
    }


def format_summary(summary: Dict[str, Any]) -> str:
    lines = [
        f"{'span':32s} {'count':>7s} {'total_s':>10s} {'self_s':>10s} "
        f"{'mean_ms':>9s} {'p50_ms':>9s} {'p95_ms':>9s} {'p99_ms':>9s}"
    ]
    for name, st in sorted(
        summary["spans"].items(), key=lambda kv: -kv[1]["total_s"]
    ):
        lines.append(
            f"{name:32s} {st['count']:7d} {st['total_s']:10.4f} "
            f"{st['self_s']:10.4f} {1e3 * st['mean_s']:9.3f} "
            f"{1e3 * st['p50_s']:9.3f} {1e3 * st['p95_s']:9.3f} "
            f"{1e3 * st['p99_s']:9.3f}"
        )
    if summary["points"]:
        lines.append("")
        lines.append(f"{'point':32s} {'count':>7s}")
        for name, n in summary["points"].items():
            lines.append(f"{name:32s} {n:7d}")
    return "\n".join(lines)
