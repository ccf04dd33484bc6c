"""Faults planted in the LM training path underneath, to show that the
comparison of an LM cell catches them (``tests/test_bench_jamba.py``;
``calibrate_lm.py --fault``): the MoE layer's capacity dispatch put back
(each held expert keeps at most ceil(1.25 * entries / experts) of its
entries, the rest dropped); RoPE applied on the attention layer; the
RMSNorms on Mamba's dt, B and C left out; the top-k gates renormalised;
the optimizer's velocity not carried from one step to the next (zeroed
before each update).
Each ``apply_*`` patches the program in place and returns the function
that undoes it; a benchmark run never plants one."""
import dataclasses
import math


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def apply_capacity_drops():
    from repro_torch.models import moe

    rows = moe._expert_rows

    def capped(counts, first, stop):
        cap = math.ceil(1.25 * sum(counts) / len(counts))
        return [(start, min(n, cap)) for start, n in rows(counts, first, stop)]

    return _patch(moe, "_expert_rows", capped)


def apply_rope_on_attention():
    from repro_torch.models import layers

    attention = layers.attention_fwd

    def with_rope(params, x, cfg, **kwargs):
        return attention(params, x, dataclasses.replace(cfg, rope=True), **kwargs)

    return _patch(layers, "attention_fwd", with_rope)


def apply_no_dt_bc_norms():
    from repro_torch.models import mamba

    return _patch(mamba, "rmsnorm", lambda params, x, **kwargs: x)


def apply_topk_renormalised():
    from repro_torch.models import moe

    route = moe._route

    def renormalised(*args):
        probs, gate, eidx = route(*args)
        return probs, gate / gate.sum(-1, keepdim=True), eidx

    return _patch(moe, "_route", renormalised)


def apply_momentum_dropped():
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    update = sgd.MomentumSGD.update

    def forgetful(self, grads, state, params, lr):
        for v in tree_leaves(state.velocity):
            v.zero_()
        return update(self, grads, state, params, lr)

    return _patch(sgd.MomentumSGD, "update", forgetful)


FAULTS = {"capacity_drops": apply_capacity_drops,
          "rope_on_attention": apply_rope_on_attention,
          "no_dt_bc_norms": apply_no_dt_bc_norms,
          "topk_renormalised": apply_topk_renormalised,
          "momentum_dropped": apply_momentum_dropped}
# the reference in the precision below the configuration's, in the program's place
CONTROLS = ("fp8", "bf16_scan")
