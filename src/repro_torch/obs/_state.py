"""Process-global observability switch and debug allocation counter.

Twin of ``repro.obs._state``, a copy (it needs no framework).

Kept in its own tiny module so ``obs.metrics`` and ``obs.trace`` can share
it without a circular import. Two pieces of state:

* **enabled flag** — ``obs.disabled()`` flips it off, turning every
  telemetry write (span open/close, point events, telemetry-registry
  counter/gauge/histogram mutation) into an early return. Control-plane
  registries (``MetricsRegistry(control=True)``) ignore the flag: the
  serving gateway *steers* by its rolling windows, so disabling telemetry
  must not change admission/brownout behaviour — only remove the
  measurement overhead the overhead benchmark quantifies.
* **allocation counter** — every obs-owned allocation (a ``Span``, an
  event dict, a stored sample) bumps it. The disabled-mode test asserts
  the counter does not move across thousands of disabled calls: "no-op"
  is checked by accounting, not by timing.
"""
from __future__ import annotations

import contextlib

__all__ = ["is_enabled", "set_enabled", "disabled", "note_alloc",
           "debug_allocs"]

_enabled: bool = True
_allocs: int = 0


def is_enabled() -> bool:
    return _enabled


def set_enabled(flag: bool) -> None:
    global _enabled
    _enabled = bool(flag)


@contextlib.contextmanager
def disabled():
    """Context manager: all telemetry writes are no-ops inside the block."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def note_alloc(n: int = 1) -> None:
    global _allocs
    _allocs += n


def debug_allocs() -> int:
    """Total obs-owned allocations so far (monotone; for no-op tests)."""
    return _allocs
