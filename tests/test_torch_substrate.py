"""The fault-tolerance units of ``repro_torch.runtime.supervisor`` against
the reference's, on the CPU: twins of the three fault-tolerance tests of
``tests/test_distributed_substrate.py`` (the heartbeat monitor, the elastic
mesh plan, ``retry_step``). Each drives both packages with the same inputs
and compares what they return, on top of the reference test's own
assertions."""
import dataclasses

import pytest

pytest.importorskip("jax")  # the reference; the card's machine has none

from repro.runtime import supervisor as jsup  # noqa: E402
from repro_torch.runtime import supervisor as tsup  # noqa: E402


def _heartbeat_run(sup):
    """The reference test's clock script on one package's monitor: what
    ``classify``/``tick`` return and the misses charged, step by step."""
    clock = [0.0]
    pol = sup.StragglerPolicy(soft_deadline_s=10, hard_deadline_s=100, evict_after=2)
    mon = sup.HeartbeatMonitor(["a", "b"], pol, clock=lambda: clock[0])
    seen = [mon.classify()]
    clock[0] = 50.0
    mon.beat("a")
    seen.append(mon.classify())
    clock[0] = 200.0   # b misses its hard deadline (1st)
    mon.beat("a")
    # classify() is pure: polling it repeatedly never charges misses
    seen.extend(mon.classify() for _ in range(5))
    seen.append(dict(mon.misses))
    seen.append(mon.tick())          # the miss is charged on the tick
    seen.append(dict(mon.misses))
    clock[0] = 400.0   # 2nd hard miss -> evicted
    mon.beat("a")
    seen.append(mon.tick())
    seen.append(mon.classify())
    seen.append(mon.healthy_count)
    return seen


def test_heartbeat_classification_and_eviction():
    got = _heartbeat_run(tsup)
    assert got[0] == {"a": "healthy", "b": "healthy"}
    assert got[1] == {"a": "healthy", "b": "straggling"}
    assert all(c["b"] == "dead" for c in got[2:7])
    assert got[7]["b"] == 0
    assert got[8]["b"] == "dead" and got[9]["b"] == 1
    assert got[10]["b"] == "evicted" and got[11]["b"] == "evicted"
    assert got[12] == 1
    assert got == _heartbeat_run(jsup)


@pytest.mark.parametrize("devices,kwargs", [
    (512, dict(model_axis=16, per_replica_batch=16)),
    (511, dict(model_axis=16, per_replica_batch=16)),
])
def test_elastic_plan_shrinks_data_axis(devices, kwargs):
    p = tsup.plan_elastic_mesh(devices, **kwargs)
    if devices == 512:
        assert p.n_devices == 512 and p.pods == 2 and p.data == 16
    else:
        assert p.n_devices == 256  # largest power-of-two data axis that fits
        assert p.global_batch == 256
    assert dataclasses.asdict(p) == dataclasses.asdict(jsup.plan_elastic_mesh(devices, **kwargs))
    for sup in (tsup, jsup):
        with pytest.raises(RuntimeError, match="healthy devices"):
            sup.plan_elastic_mesh(8, model_axis=16)


def _retry_run(sup):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    ok = sup.retry_step(flaky, retries=3, sleep=lambda s: None)

    def always_fails():
        raise RuntimeError("permanent")

    seen, slept = [], []
    with pytest.raises(RuntimeError, match="permanent"):
        sup.retry_step(always_fails, retries=2, sleep=slept.append,
                       on_failure=lambda a, e: seen.append((a, str(e))))
    return ok, calls["n"], seen, slept


def test_retry_step_recovers_then_raises():
    ok, n_calls, seen, slept = _retry_run(tsup)
    assert ok == "ok" and n_calls == 3  # recovers on the third call
    assert [a for a, _ in seen] == [0, 1, 2]
    assert (ok, n_calls, seen, slept) == _retry_run(jsup)
