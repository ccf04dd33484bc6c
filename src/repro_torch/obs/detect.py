"""Online anomaly detection over training-dynamics snapshots
(DESIGN.md §12).

Twin of ``repro.obs.detect``, a copy (it needs no framework).

Sparse-training failures are silent and distributional (Hoefler et al.):
a layer whose values collapse to zero still produces finite losses; an
exploding gradient shows up in accuracy only epochs later. The
:class:`AnomalyMonitor` watches the per-layer stat stream produced by
``probes.record_snapshot`` and fires typed alerts the moment a
distribution leaves its healthy envelope.

Rules (all per ``(kind, layer)`` except RSS):

* ``dead_layer``       — value L2 (or gradient L2) at numerical zero.
* ``vanishing_grads``  — gradient L2 positive but below ``vanish_grad_l2``.
* ``exploding_grads``  — gradient L2 above ``explode_grad_l2`` absolute,
  OR above ``explode_ratio`` x the layer's running-median baseline.
* ``churn_collapse``   — SET prune/regrow churn below
  ``churn_collapse_frac`` when evolution is supposed to be active
  (``churn_frac`` present in the snapshot).
* ``importance_drift`` — median neuron importance drifts beyond
  ``importance_drift_ratio`` x (or 1/x) its first-seen baseline.
* ``rss_growth``       — host RSS beyond ``rss_growth_ratio`` x the
  first-observation baseline AND ``rss_min_growth_bytes`` absolute growth
  (both conditions, so small-footprint CI runs can't trip it on noise).

**Quiet period**: the first ``quiet_snapshots`` observations per kind
establish baselines and fire nothing — step-0 stats (fresh random init,
untrained gradients) are legitimately weird. Thresholds are deliberately
order-of-magnitude loose: the acceptance contract is zero false positives
on a healthy short run, and every rule still separates its seeded
pathology from health by >= 10x.

Alerts are **sticky**: ``active_alerts`` keeps one entry per
``(rule, kind, layer)`` until :meth:`AnomalyMonitor.clear` — external
watchers poll the supervisor progress file's health block (see
``runtime/supervisor.write_progress``) and must not miss an alert that
fired between polls.
"""
from __future__ import annotations

import dataclasses
import os
import resource
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.obs import _state, trace

__all__ = [
    "DetectorThresholds",
    "Alert",
    "AnomalyMonitor",
    "configure",
    "get_monitor",
    "health_block",
    "host_rss_bytes",
]


@dataclasses.dataclass(frozen=True)
class DetectorThresholds:
    dead_value_l2: float = 1e-6
    dead_grad_l2: float = 1e-9
    vanish_grad_l2: float = 1e-7
    explode_grad_l2: float = 1e3
    explode_ratio: float = 50.0
    churn_collapse_frac: float = 0.005
    importance_drift_ratio: float = 8.0
    rss_growth_ratio: float = 2.5
    rss_min_growth_bytes: int = 512 << 20


@dataclasses.dataclass
class Alert:
    rule: str
    kind: str
    layer: Optional[int]
    step: int
    value: float
    threshold: float
    message: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def key(self) -> Tuple[str, str, Optional[int]]:
        return (self.rule, self.kind, self.layer)


def host_rss_bytes() -> Optional[int]:
    """Current resident set size via /proc/self/statm (Linux), falling
    back to ru_maxrss; ``None`` when neither is available. No psutil —
    nothing outside the standard library."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as fh:
            pages = int(fh.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except (OSError, ValueError):
        return None


_HIST_KEEP = 16  # per-(kind, layer) grad-norm history for the ratio rule


class AnomalyMonitor:
    """Consumes snapshots, fires :class:`Alert` objects, keeps sticky
    per-key active alerts plus the latest condensed snapshot for the
    supervisor progress file."""

    def __init__(
        self,
        thresholds: Optional[DetectorThresholds] = None,
        quiet_snapshots: int = 1,
        alert_hook: Optional[Callable[[Alert], None]] = None,
        rss_fn: Callable[[], Optional[int]] = host_rss_bytes,
    ):
        self.thresholds = thresholds or DetectorThresholds()
        self.quiet_snapshots = int(quiet_snapshots)
        self.alert_hook = alert_hook
        self._rss_fn = rss_fn
        self._seen: Dict[str, int] = {}
        self._grad_hist: Dict[Tuple[str, int], List[float]] = {}
        self._imp_baseline: Dict[Tuple[str, int], float] = {}
        self._rss_baseline: Optional[int] = None
        self.active: Dict[Tuple[str, str, Optional[int]], Alert] = {}
        self.latest: Optional[Dict[str, Any]] = None
        self.observed = 0

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        mid = n // 2
        return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])

    def _fire(self, fired: List[Alert], alert: Alert) -> None:
        fired.append(alert)
        if alert.key not in self.active:
            self.active[alert.key] = alert
            trace.point(
                "probe.alert", rule=alert.rule, kind=alert.kind,
                layer=alert.layer, step=alert.step, value=alert.value,
            )
            if self.alert_hook is not None:
                self.alert_hook(alert)

    # -- the one entry point ----------------------------------------------

    def observe(
        self, step: int, kind: str, layers: List[dict],
        extra: Optional[Dict[str, Any]] = None,
    ) -> List[Alert]:
        """Feed one snapshot; returns the alerts fired by it (already
        merged into ``active``). Baselines update on every call; rules
        only evaluate once the kind's quiet period has passed."""
        th = self.thresholds
        self.observed += 1
        count = self._seen[kind] = self._seen.get(kind, 0) + 1
        quiet = count <= self.quiet_snapshots
        fired: List[Alert] = []
        for li, st in enumerate(layers):
            grad = st.get("grad_l2")
            val = st.get("value_l2")
            imp = st.get("imp_q50")
            hist = self._grad_hist.setdefault((kind, li), [])
            baseline_med = self._median(hist) if hist else None
            if isinstance(grad, (int, float)):
                hist.append(float(grad))
                del hist[:-_HIST_KEEP]
            key = (kind, li)
            if key not in self._imp_baseline and isinstance(imp, (int, float)) \
                    and imp > 0:
                self._imp_baseline[key] = float(imp)
            if quiet:
                continue
            if isinstance(val, (int, float)) and val <= th.dead_value_l2:
                self._fire(fired, Alert(
                    "dead_layer", kind, li, step, float(val),
                    th.dead_value_l2,
                    f"value_l2={val:.3e} <= {th.dead_value_l2:.0e} — layer "
                    "carries no weight mass",
                ))
            elif isinstance(grad, (int, float)) and grad <= th.dead_grad_l2:
                self._fire(fired, Alert(
                    "dead_layer", kind, li, step, float(grad),
                    th.dead_grad_l2,
                    f"grad_l2={grad:.3e} <= {th.dead_grad_l2:.0e} — no "
                    "gradient reaches this layer",
                ))
            elif isinstance(grad, (int, float)) and 0 < grad < th.vanish_grad_l2:
                self._fire(fired, Alert(
                    "vanishing_grads", kind, li, step, float(grad),
                    th.vanish_grad_l2,
                    f"grad_l2={grad:.3e} < {th.vanish_grad_l2:.0e}",
                ))
            if isinstance(grad, (int, float)):
                if grad > th.explode_grad_l2:
                    self._fire(fired, Alert(
                        "exploding_grads", kind, li, step, float(grad),
                        th.explode_grad_l2,
                        f"grad_l2={grad:.3e} > {th.explode_grad_l2:.0e} "
                        "absolute ceiling",
                    ))
                elif (baseline_med is not None and baseline_med > 0
                        and grad > th.explode_ratio * baseline_med):
                    self._fire(fired, Alert(
                        "exploding_grads", kind, li, step, float(grad),
                        th.explode_ratio * baseline_med,
                        f"grad_l2={grad:.3e} > {th.explode_ratio:.0f}x "
                        f"running median {baseline_med:.3e}",
                    ))
            churn = st.get("churn_frac")
            if isinstance(churn, (int, float)) \
                    and churn < th.churn_collapse_frac:
                self._fire(fired, Alert(
                    "churn_collapse", kind, li, step, float(churn),
                    th.churn_collapse_frac,
                    f"churn_frac={churn:.4f} < {th.churn_collapse_frac} — "
                    "evolution stopped rewiring this layer",
                ))
            base_imp = self._imp_baseline.get(key)
            if (isinstance(imp, (int, float)) and base_imp
                    and (imp > th.importance_drift_ratio * base_imp
                         or imp < base_imp / th.importance_drift_ratio)):
                self._fire(fired, Alert(
                    "importance_drift", kind, li, step, float(imp),
                    base_imp,
                    f"imp_q50={imp:.3e} drifted beyond "
                    f"{th.importance_drift_ratio:.0f}x baseline "
                    f"{base_imp:.3e}",
                ))
        rss = self._rss_fn()
        if rss is not None:
            if self._rss_baseline is None:
                self._rss_baseline = rss
            elif not quiet and (
                rss > th.rss_growth_ratio * self._rss_baseline
                and rss - self._rss_baseline > th.rss_min_growth_bytes
            ):
                self._fire(fired, Alert(
                    "rss_growth", kind, None, step, float(rss),
                    th.rss_growth_ratio * self._rss_baseline,
                    f"host RSS {rss / 2**20:.0f} MiB > "
                    f"{th.rss_growth_ratio}x baseline "
                    f"{self._rss_baseline / 2**20:.0f} MiB",
                ))
        self.latest = {
            "step": int(step), "kind": str(kind),
            "layers": [
                {k: v for k, v in st.items() if not k.endswith("_hist")}
                for st in layers
            ],
            "extra": dict(extra or {}),
        }
        return fired

    @property
    def active_alerts(self) -> List[Dict[str, Any]]:
        return [a.to_dict() for a in self.active.values()]

    def clear(self) -> None:
        self.active.clear()

    def health_block(self) -> Dict[str, Any]:
        """The JSON block the supervisor appends to its progress file."""
        return {
            "latest_probe_snapshot": self.latest,
            "active_alerts": self.active_alerts,
        }


_monitor: Optional[AnomalyMonitor] = None


def configure(monitor: Optional[AnomalyMonitor]) -> Optional[AnomalyMonitor]:
    """Install (or, with ``None``, remove) the process-global monitor."""
    global _monitor
    _monitor = monitor
    return _monitor


def get_monitor() -> Optional[AnomalyMonitor]:
    if _monitor is None or not _state.is_enabled():
        return None
    return _monitor


def health_block() -> Optional[Dict[str, Any]]:
    """Active monitor's health block, or ``None`` when no monitor is
    installed — what ``runtime/supervisor.write_progress`` embeds."""
    m = get_monitor()
    return m.health_block() if m is not None else None
