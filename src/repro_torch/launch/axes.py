"""Ambient logical-axis context for activation sharding hints. Twin of
``repro.launch.axes``.

``hint(x, 'batch', None, 'heads_q', None)`` redistributes a DTensor ``x``
to the shape-aware placements of those logical axes when a launcher has
installed :class:`launch.sharding.ShardingRules` (the dry run, the sharded
driver); otherwise, and for a plain tensor, it returns ``x`` as it is.

The reference calls ``hint`` inside its models to keep GSPMD's propagation
from giving up inside scan bodies. The port's models call it nowhere: the
sharded step (``launch.train``) gathers the parameters and computes on
plain tensors, where a hint would do nothing but cost host time on every
call, and the host sets the pace of the decode steps.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["current_rules", "hint", "logical_axis_rules"]

_state = threading.local()


def current_rules():
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def logical_axis_rules(rules):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def hint(x, *names):
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import shape_aware_shardings

    rules = current_rules()
    if rules is None or not isinstance(x, DTensor) or x.ndim != len(names):
        return x
    # shape-aware: drop axis assignments that don't divide the dim
    layout = shape_aware_shardings(rules, tuple(names), x)
    if tuple(x.placements) == layout.placements:
        return x
    return x.redistribute(layout.mesh, layout.placements)
