"""Device milliseconds a step of the selective scan: the device time of the
port's ``lm.mamba.scan`` spans (``models/mamba.py``: the chunked scan's
forward, in the forward pass and in remat's recompute of each Mamba layer)
over the window, summed and divided by the window's steps. The scan's
backward runs outside the span and is not covered. Silent where the
program has no such span (or ran where no device time is recorded)."""

SPAN = "lm.mamba.scan"


def read(tr):
    spans = [s for s in tr.spans if s["name"] == SPAN and "dev_t1" in s]
    steps = tr.info.get("window_steps")
    if not spans or not steps:
        return None
    return 1e3 * sum(s["dev_t1"] - s["dev_t0"] for s in spans) / steps
