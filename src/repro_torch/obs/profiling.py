"""Profiling hooks: opt-in ``torch.profiler`` capture, device-memory gauges,
and compile-event counters. Twin of ``repro.obs.profiling`` (DESIGN.md
§11).

Everything degrades gracefully off the card: without CUDA there are no
allocator statistics, and the gauges are simply not set, never faked.
Compile counters are *fed* from the subsystems' existing surfaces (the
port's ``xl.stream.compile_counts()``, the engine's stats) rather than
hooked into PyTorch internals, so they stay exact and host-side.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Mapping, Optional

from repro_torch.obs import _state, trace
from repro_torch.obs.metrics import MetricsRegistry, default_registry

__all__ = [
    "profile_trace",
    "sample_device_memory",
    "record_compile_counts",
]


@contextlib.contextmanager
def profile_trace(logdir: str, name: str = "profile"):
    """Capture a ``torch.profiler`` trace (CPU and, where there is a card,
    CUDA activity) around a block and write it into ``logdir`` as a Chrome
    trace, ``<name>.pt.trace.json``; bracketed by ``profile.start`` and
    ``profile.stop`` point events so the capture window is visible in the
    span timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    _point("profile.start", name, logdir)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(str(logdir), f"{name}.pt.trace.json"))
        _point("profile.stop", name, logdir)


def _point(event: str, name: str, logdir) -> None:
    """The capture's point event with the reference's attrs ``name`` and
    ``logdir``, through the tracer itself: ``obs.point(event, name=...)``
    cannot take an attr called ``name`` (the reference's call raises a
    ``TypeError`` there)."""
    t = trace.current_tracer()
    if t is not None and _state.is_enabled():
        t.point(event, {"name": name, "logdir": str(logdir)})


# the reference's gauge (jax ``memory_stats()`` key) -> the CUDA caching
# allocator's statistic that stands for it (``torch.cuda.memory_stats``)
_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
}


def sample_device_memory(
    registry: Optional[MetricsRegistry] = None,
    emit_point: bool = False,
) -> Dict[str, float]:
    """Read each card's allocator statistics into the reference's gauges:

    * ``device_bytes_in_use``: ``allocated_bytes.all.current``, the bytes
      of live tensors;
    * ``device_peak_bytes_in_use``: ``allocated_bytes.all.peak``, their
      peak since the last ``torch.cuda.reset_peak_memory_stats``;
    * ``device_largest_alloc_size``: left out. The allocator keeps no
      figure for its largest allocation (``max_split_size`` is a setting);
    * ``device_live_buffers``: ``active.all.current``, the allocator's live
      blocks, summed over the cards (jax counts live arrays; a tensor
      holds one block, a view shares its base's).

    Returns what was read: ``{}`` where there is no card, as the reference
    returns on CPU jaxlib. Cheap enough for per-step sampling, but meant
    for epoch and round boundaries.
    """
    if not _state.is_enabled():
        return {}
    import torch

    if not torch.cuda.is_available():
        return {}
    reg = registry if registry is not None else default_registry()
    out: Dict[str, float] = {}
    live = 0.0
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        if not stats:
            continue
        dev_id = str(i)
        for key, src in _MEMORY_KEYS.items():
            if src in stats:
                val = float(stats[src])
                reg.gauge(f"device_{key}", device=dev_id).set(val)
                out[f"device_{key}{{device={dev_id}}}"] = val
        live += float(stats.get("active.all.current", 0))
    if out:
        reg.gauge("device_live_buffers").set(live)
        out["device_live_buffers"] = live
    if emit_point and out:
        trace.point("device_memory", **{k: v for k, v in out.items()})
    return out


def record_compile_counts(
    counts: Mapping[str, float],
    registry: Optional[MetricsRegistry] = None,
    prefix: str = "compile_cache_entries",
) -> None:
    """Mirror a subsystem's compile-cache surface (program -> #entries or
    hit/miss counts) into labeled gauges; a growing entry count between two
    samples is a recompile event."""
    if not _state.is_enabled():
        return
    reg = registry if registry is not None else default_registry()
    for program, n in counts.items():
        reg.gauge(prefix, program=str(program)).set(float(n))
