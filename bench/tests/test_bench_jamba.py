"""The LM cell's pieces at a toy size on the CPU: the counts of a Jamba
step by hand, each planted fault of ``bench/faults_lm.py`` and each
control (the reference in fp8 or with a bf16 scan, put in the program's
place) failing a limit of the cell, and the span readers on hand-built
spans, silent where the program has no such span."""
import pytest
import torch

from bench import compare
from bench.counts import jamba
from bench.faults_lm import CONTROLS, FAULTS
from bench.harness import ROOT, Cell, Context, SubWindow, TraceReading, load_module
from bench.tests.helpers import toy_run

CELL = "jamba2mini.train_1x8192"


def reader(name):
    return load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_")).read


def tiny_config():
    return dict(hidden_size=8, intermediate_size=12, vocab_size=10, mamba_expand=2,
                mamba_d_state=3, mamba_dt_rank=2, mamba_d_conv=4, num_attention_heads=2,
                num_key_value_heads=1, num_hidden_layers=4, attn_layer_period=4,
                attn_layer_offset=2, expert_layer_period=2, expert_layer_offset=1)


def test_jamba_step_flops_by_hand():
    c = tiny_config()
    # d 8, di 16, ds 3, r 2, K 4, H 2, KV 1, Dh 4, f 12, V 10, E 4; seq 5, batch 2
    mamba = 2 * (8 * 32 + 16 * 8 + 2 * 16 + 16 * 8) + 2 * 4 * 16 + 7 * 16 * 3
    attn = 2 * 8 * (2 * 2 * 4 + 2 * 1 * 4) + 4 * 2 * 4 * 6 / 2
    dense, router = 6 * 8 * 12, 2 * 8 * 4
    # layers 0 mamba+dense, 1 mamba+moe, 2 attention+dense, 3 mamba+moe
    per_token = 2 * 8 * 10 + 3 * mamba + attn + 2 * dense + 2 * router
    want = per_token * 10 + 6 * 8 * 12 * 7
    assert jamba.forward_flops(c, 5, 2, 4, 7) == pytest.approx(want)
    assert jamba.step_flops(c, 5, 2, 4, 7) == pytest.approx(3 * want)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    undo = FAULTS[fault]()
    try:
        r = toy_run(CELL)
    finally:
        undo()
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("precision", CONTROLS)
def test_a_control_is_not_correct(precision):
    c = Cell(CELL)
    prog = c.runner().build(Context(c, 2**31 + 5, torch.device("cpu"), toy=True))
    prog.measure(0.0, SubWindow(False))
    checks = compare.judged(prog.control_readings(precision), c.limits)
    assert any(v > lim for _, v, lim in checks), checks


def span(sid, name, dev_t0, dev_t1, **attrs):
    return {"name": name, "id": sid, "parent": None, "t0": dev_t0, "t1": dev_t1,
            "dur_s": dev_t1 - dev_t0, "dev_t0": dev_t0, "dev_t1": dev_t1, "attrs": attrs}


def reading(spans, window_steps=2):
    info = {"config": tiny_config(), "seq": 5, "batch": 2, "router_experts": 4,
            "window_steps": window_steps}
    return TraceReading([("k", 0.0, 0.5)], 2.0, 1, 1, spans, info, True, 0.0)


def test_span_readers_by_hand():
    spans = [span(1, "lm.mamba.scan", 0.0, 0.010), span(2, "lm.mamba.scan", 1.0, 1.030),
             span(3, "lm.moe", 2.0, 2.004, rows=6, max_rows=3, host_syncs=1),
             span(4, "lm.moe", 3.0, 3.006, rows=8, max_rows=4, host_syncs=1)]
    tr = reading(spans)
    assert reader("ssm_scan_ms.jamba")(tr) == pytest.approx(20.0)  # 40 ms over 2 steps
    assert reader("moe_ms.jamba")(tr) == pytest.approx(5.0)
    # 2 MoE layers, 7 rows a span on average: 14 rows a step
    flops = jamba.step_flops(tiny_config(), 5, 2, 4, 14)
    assert reader("step_mfu.jamba")(tr) == pytest.approx(100 * flops / 2.0 / 989e12)
    assert reader("idle_share.jamba")(tr) == pytest.approx(75.0)
    assert reader("launches_per_step.jamba")(tr) == 1.0


@pytest.mark.parametrize("name", ["ssm_scan_ms.jamba", "moe_ms.jamba", "step_mfu.jamba"])
def test_span_readers_silent_without_the_spans(name):
    assert reader(name)(reading([])) is None
    # spans without device times (a run without a card)
    cpu = [dict(s) for s in (span(1, "lm.mamba.scan", 0.0, 0.01), span(2, "lm.moe", 0.0, 0.01))]
    for s in cpu:
        s.pop("dev_t0"), s.pop("dev_t1")
    if name != "step_mfu.jamba":
        assert reader(name)(reading(cpu)) is None


def moe_layer_output(held=(1, 3), T=48, d=16, f=24, E=4, K=2, seed=0):
    """A held share of an MoE layer, computed by a per-entry loop: (x, y,
    eidx, gate, experts, the (token, k) entries held)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g)
    eidx = torch.stack([torch.randperm(E, generator=g)[:K] for _ in range(T)])
    gate = torch.rand(T, K, generator=g)
    w = [[torch.randn(a, b, generator=g) / a ** 0.5 for a, b in ((d, f), (d, f), (f, d))]
         for _ in range(held[1] - held[0])]

    def experts(j, rows):
        gw, uw, dw = w[j]
        return (torch.nn.functional.silu(rows @ gw) * (rows @ uw)) @ dw

    entries = [(t, k) for t in range(T) for k in range(K) if held[0] <= eidx[t, k] < held[1]]
    y = torch.zeros(T, d)
    for t, k in entries:
        y[t] += gate[t, k] * experts(int(eidx[t, k]) - held[0], x[t: t + 1])[0]
    return x, y, eidx, gate, experts, entries


def test_entries_missed_reads_what_the_layer_computed():
    from bench.runners.lm_train import entries_missed

    x, y, eidx, gate, experts, entries = moe_layer_output()
    held = (1, 3)
    assert entries_missed(x, y.bfloat16().float(), eidx, gate, experts, held) == 0
    (t0, k0), (t1, k1) = entries[0], entries[5]
    one = gate[t0, k0] * experts(int(eidx[t0, k0]) - 1, x[t0: t0 + 1])[0]
    dropped = y.clone()
    dropped[t0] -= one
    assert entries_missed(x, dropped, eidx, gate, experts, held) == 1  # dropped
    twice = y.clone()
    twice[t0] += one
    assert entries_missed(x, twice, eidx, gate, experts, held) == 1  # computed twice
    swapped = y.clone()
    swapped[[t0, t1]] = y[[t1, t0]]                                  # another token's row
    n0 = sum(1 for t, _ in entries if t == t0)
    n1 = sum(1 for t, _ in entries if t == t1)
    assert entries_missed(x, swapped, eidx, gate, experts, held) >= n0 + n1
    no_held = [t for t in range(len(y)) if not any(e == t for e, _ in entries)][0]
    stray = y.clone()
    stray[no_held] = one                                              # nobody asked for it
    assert entries_missed(x, stray, eidx, gate, experts, held) == 1
    nan = y.clone()
    nan[t0] = float("nan")
    assert entries_missed(x, nan, eidx, gate, experts, held) >= n0
