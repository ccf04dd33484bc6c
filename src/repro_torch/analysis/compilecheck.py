"""Shared zero-recompile assertion helper, backed by the registry's
expected-compile-count contracts. Twin of ``repro.analysis.compilecheck``.

PyTorch compiles nothing per call, so the port's "compiles" are the builds
it counts: the engine's bucket entries (``stats["compiles"]``), the
out-of-core executor's static buffers (``xl.stream.compile_counts()``) and
the hand kernels' libraries (``kernels.build``, one ``nvcc`` per source):

    with expect_compiles(lambda: engine.stats["compiles"], 0):
        engine.classify(x)                       # a warm bucket builds nothing

    with expect_compiles(stream.compile_counts, program="xl.shard_acc"):
        ex.logits(x)                             # expected count from registry

Counter sources accepted: an object with ``_cache_size()`` (a cache that
counts its entries), a dict of named counts (read when the block starts
and ends: a live counter dict), a zero-arg callable returning an int, or a
zero-arg callable returning such a dict — dict deltas are summed.
``at_most=True`` turns the equality into an upper bound (warm-path checks
that tolerate an unbuilt cold start).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Optional, Union

__all__ = ["expect_compiles", "snapshot"]

CounterSource = Union[Callable, object]


def snapshot(source: CounterSource) -> Union[int, Dict[str, int]]:
    """Current compile count(s) of a counter source."""
    cache_size = getattr(source, "_cache_size", None)
    if cache_size is not None:
        return int(cache_size())
    if isinstance(source, dict):
        return dict(source)
    if callable(source):
        value = source()
        if isinstance(value, dict):
            return dict(value)
        return int(value)
    raise TypeError(
        f"expect_compiles: {source!r} is neither a jitted function "
        "(no _cache_size), a dict of counts nor a callable counter"
    )


def _delta(before, after) -> int:
    if isinstance(before, dict):
        keys = set(before) | set(after)
        return sum(after.get(k, 0) - before.get(k, 0) for k in keys)
    return after - before


@contextmanager
def expect_compiles(
    source: CounterSource,
    expected: Optional[int] = None,
    *,
    program: Optional[str] = None,
    at_most: bool = False,
):
    """Assert the block compiles exactly (or at most) ``expected`` new
    executables. ``program`` pulls the expectation from the registry's
    contract instead — one source of truth for tests and the CLI audit."""
    if expected is None:
        if program is None:
            raise TypeError(
                "expect_compiles needs an explicit count or a registered "
                "program name"
            )
        from repro_torch.analysis import registry

        expected = registry.expected_compiles(program)
    before = snapshot(source)
    yield
    added = _delta(before, snapshot(source))
    label = f" for {program!r}" if program else ""
    if at_most:
        assert added <= expected, (
            f"compiled {added} new executable(s){label}, contract allows at "
            f"most {expected}"
        )
    else:
        assert added == expected, (
            f"compiled {added} new executable(s){label}, contract expects "
            f"exactly {expected}"
        )
