"""The profiled sub-window's model flops (its training steps, counted from
the live topology: ``counts/set_mlp.py``) over its seconds, as a share of
the f32 peak outside the tensor cores, in %."""
from bench.counts import PEAKS, set_mlp


def read(tr):
    if not tr.steps or tr.window_s <= 0:
        return None
    flops = set_mlp.step_flops(tr.info["batch"], tr.info["nnz"]) * tr.steps
    return 100.0 * flops / tr.window_s / PEAKS["f32_flops_per_s"]
