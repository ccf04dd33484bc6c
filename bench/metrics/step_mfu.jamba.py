"""The profiled step's model flops (``counts/jamba.py``: the configuration,
and the rows the held experts computed, read from the ``lm.moe`` spans'
``rows``: their mean over the window's spans, each layer's forward and
recompute alike, times the MoE layers) over its seconds, as a share of the
bf16 tensor-core peak, in %. Silent where the program has no such span."""
from bench.counts import PEAKS, jamba


def read(tr):
    rows = [s["attrs"]["rows"] for s in tr.spans
            if s["name"] == "lm.moe" and "rows" in s["attrs"]]
    if not rows or not tr.steps or tr.window_s <= 0:
        return None
    c = tr.info["config"]
    n_moe = sum(f == "moe" for _, f in jamba._layer_kinds(c))
    flops = jamba.step_flops(c, tr.info["seq"], tr.info["batch"], tr.info["router_experts"],
                             n_moe * sum(rows) / len(rows))
    return 100.0 * flops * tr.steps / tr.window_s / PEAKS["bf16_flops_per_s"]
