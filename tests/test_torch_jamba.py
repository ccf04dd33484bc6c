"""Jamba on the port (``configs/jamba2_mini.py``): the period of 8 with
per-slot FFNs, attention without RoPE, Mamba with dt/B/C norms, dropless
MoE with a held share and the pooled load-balancing loss, on seeded random
weights at the SMOKE size, against the benchmark's plain reference
(``bench/reference/jamba.py``), which is held against transformers'
``JambaForCausalLM`` where transformers is installed. Also the LM's bf16
embedding gradient, summed in f32 and rounded once."""
import dataclasses
import math
from pathlib import Path

import pytest
import torch

from bench.harness import load_module
from bench.reference import jamba as ref
from repro_torch import obs
from repro_torch.configs import get_spec, list_archs
from repro_torch.launch.steps import lm_loss_fn, make_train_step
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.transformer import PatternLM
from repro_torch.tree import tree_flatten_with_names, tree_map

ROOT = Path(__file__).resolve().parents[1]
RUNNER = load_module(ROOT / "bench" / "runners" / "lm_train.py", "bench_runner_lm_train")
SMOKE = get_spec("jamba2-mini").smoke
S = 32


def smoke_json(**kw):
    """SMOKE as the JambaConfig keys the reference reads."""
    c = dict(hidden_size=SMOKE.d_model, num_hidden_layers=SMOKE.n_layers,
             attn_layer_period=8, attn_layer_offset=4, expert_layer_period=2,
             expert_layer_offset=1, vocab_size=SMOKE.vocab, num_attention_heads=SMOKE.n_heads,
             num_key_value_heads=SMOKE.n_kv, intermediate_size=SMOKE.d_ff,
             mamba_expand=SMOKE.d_inner // SMOKE.d_model, mamba_d_state=SMOKE.d_state,
             mamba_d_conv=4, mamba_dt_rank=SMOKE.d_model // 16, num_experts=SMOKE.n_experts,
             num_experts_per_tok=SMOKE.top_k, rms_norm_eps=1e-6, router_aux_loss_coef=0.001)
    c.update(kw)
    return c


def seeded_model(dtype="float32", seed=0, **kw):
    """SMOKE with its norm scales drawn too (zeros would hide them)."""
    m = PatternLM(dataclasses.replace(SMOKE, dtype=dtype, **kw), seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for name, t in tree_flatten_with_names(m.params)[0]:
        if name.endswith("scale") or name.endswith("_norm"):
            t.copy_(0.2 * torch.randn(t.shape, generator=g))
    return m


def zipf_tokens(batch, seq, seed=0, vocab=SMOKE.vocab):
    g = torch.Generator().manual_seed(seed)
    p = torch.arange(1, vocab + 1, dtype=torch.float64).pow(-1.1)
    return torch.multinomial(p, batch * (seq + 1), replacement=True,
                             generator=g).reshape(batch, seq + 1)


def reference_of(model):
    named = tree_flatten_with_names(model.params)[0]
    names = RUNNER.reference_names(named, len(model.cfg.pattern))
    return RUNNER.AsReference({k: t.detach() for k, t in named}, names), names


def reference_weights(model):
    """The model's weights as the reference's f32 leaves, ready for
    autograd."""
    w, _ = reference_of(model)
    return {k: w[k].float().clone().requires_grad_(True) for k in w}


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def record_routes():
    """Patch the router to keep each call's top-k choices."""
    routes, route = [], moe._route

    def recorded(*args):
        probs, gate, eidx = route(*args)
        routes.append(eidx.detach().clone())
        return probs, gate, eidx

    moe._route = recorded
    return routes, lambda: setattr(moe, "_route", route)


# -- the configuration ----------------------------------------------------------------


def test_config_structure_and_registry():
    full = get_spec("jamba2-mini").config
    assert "jamba2-mini" not in list_archs() and len(list_archs()) == 10
    assert full.pattern[4] == "global" and full.pattern.count("mamba") == 7
    assert full.slot_ffn == ("gated", "moe") * 4 and not full.rope and full.mamba_norms
    assert full.moe_dropless and not full.moe_norm_topk and full.moe_aux_weight == 0.001
    from repro_torch.configs.jamba2_mini import STAGE
    assert STAGE.n_layers == 8 and STAGE.moe_held == (0, 8) and STAGE.d_model == 4096
    m = PatternLM(SMOKE, device="cpu", abstract=True)
    assert sorted(m.params["stack"]) == [f"s{i}_{k}" for i, k in enumerate(SMOKE.pattern)]
    assert "ffn" in m.params["stack"]["s0_mamba"] and "router" in m.params["stack"]["s1_mamba"]["ffn"]
    assert "dt_norm" in m.params["stack"]["s0_mamba"]["mamba"]
    # the logical-axis specs (tuples, one name an axis) name every leaf the build made
    spec_paths = {k.rsplit("__", 1)[0] for k, _ in tree_flatten_with_names(m.specs)[0]}
    assert {k for k, _ in tree_flatten_with_names(m.params)[0]} <= spec_paths


def test_stage_parameter_count():
    """One period at full width with 8 of 16 experts held: 7,658 M."""
    from repro_torch.configs.jamba2_mini import STAGE

    m = PatternLM(STAGE, device="cpu", abstract=True)
    n = sum(t.numel() for _, t in tree_flatten_with_names(m.params)[0])
    assert 7.6e9 < n < 7.7e9


# -- the reference against transformers -------------------------------------------------


def test_reference_matches_transformers_jamba():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.JambaConfig(
        vocab_size=SMOKE.vocab, hidden_size=SMOKE.d_model, intermediate_size=SMOKE.d_ff,
        num_hidden_layers=8, num_attention_heads=SMOKE.n_heads,
        num_key_value_heads=SMOKE.n_kv, num_experts=SMOKE.n_experts,
        num_experts_per_tok=2, attn_layer_period=8, attn_layer_offset=4,
        expert_layer_period=2, expert_layer_offset=1, mamba_d_state=SMOKE.d_state,
        mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=SMOKE.d_model // 16,
        use_mamba_kernels=False, tie_word_embeddings=False, router_aux_loss_coef=0.001,
        initializer_range=0.1, rms_norm_eps=1e-6)
    hf_cfg._attn_implementation = "eager"
    torch.manual_seed(0)
    model = transformers.JambaForCausalLM(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.add_(0.2 * torch.randn_like(p))
    mdl = model.model
    T = lambda t: t.detach().T.contiguous()  # noqa: E731
    w = {"embed": mdl.embed_tokens.weight.detach(), "final_norm": mdl.final_layernorm.weight.detach(),
         "unembed": T(model.lm_head.weight)}
    for i, layer in enumerate(mdl.layers):
        w[f"{i}.ln1"] = layer.input_layernorm.weight.detach()
        w[f"{i}.ln2"] = layer.pre_ff_layernorm.weight.detach()
        if hasattr(layer, "mamba"):
            mx = layer.mamba
            w.update({f"{i}.in_proj": T(mx.in_proj.weight), f"{i}.conv_w": T(mx.conv1d.weight[:, 0]),
                      f"{i}.conv_b": mx.conv1d.bias.detach(), f"{i}.x_proj": T(mx.x_proj.weight),
                      f"{i}.dt_proj": T(mx.dt_proj.weight), f"{i}.dt_bias": mx.dt_proj.bias.detach(),
                      f"{i}.A_log": mx.A_log.detach(), f"{i}.D": mx.D.detach(),
                      f"{i}.out_proj": T(mx.out_proj.weight),
                      f"{i}.dt_norm": mx.dt_layernorm.weight.detach(),
                      f"{i}.b_norm": mx.b_layernorm.weight.detach(),
                      f"{i}.c_norm": mx.c_layernorm.weight.detach()})
        else:
            at = layer.self_attn
            w.update({f"{i}.wq": T(at.q_proj.weight), f"{i}.wk": T(at.k_proj.weight),
                      f"{i}.wv": T(at.v_proj.weight), f"{i}.wo": T(at.o_proj.weight)})
        ff = layer.feed_forward
        if hasattr(ff, "router"):
            w[f"{i}.router"] = T(ff.router.weight)
            for leaf, attr in (("gate", "gate_proj"), ("up", "up_proj"), ("down", "down_proj")):
                w[f"{i}.{leaf}"] = torch.stack([T(getattr(e, attr).weight) for e in ff.experts])
        else:
            w.update({f"{i}.gate": T(ff.gate_proj.weight), f"{i}.up": T(ff.up_proj.weight),
                      f"{i}.down": T(ff.down_proj.weight)})
    cfg = ref.config_from_json(smoke_json(num_experts=SMOKE.n_experts))
    assert sorted(w) == sorted(ref.leaf_names(cfg))
    tokens = zipf_tokens(2, S)[:, :S]
    with torch.no_grad():
        out = model(input_ids=tokens, labels=tokens, output_router_logits=True, use_cache=False)
        logits, aux, _ = ref.forward(w, tokens, cfg)
    assert rel(logits, out.logits) < 1e-5
    assert math.isclose(float(aux), 0.001 * float(out.aux_loss), rel_tol=1e-5)
    labels = torch.cat([tokens[:, 1:], torch.full((2, 1), -1)], dim=1)
    assert math.isclose(float(ref.xent(logits, labels) + aux), float(out.loss), rel_tol=1e-5)


# -- the port against the reference -------------------------------------------------------


def reference_step(model, tokens, routes=None):
    """(logits, ce, aux, grads by reference name) of the reference on the
    model's weights."""
    cfg = ref.config_from_json(smoke_json())
    w = reference_weights(model)
    logits, aux, _ = ref.forward(w, tokens[:, :-1], cfg, routes=routes)
    ce = ref.xent(logits, tokens[:, 1:])
    names = sorted(w)
    grads = torch.autograd.grad(ce + aux, [w[k] for k in names])
    return logits.detach(), float(ce.detach()), float(aux.detach()), dict(zip(names, grads))


def port_grads(model, tokens):
    """(ce, total, grads by reference name) of the port's loss."""
    _, names = reference_of(model)
    named = tree_flatten_with_names(model.params)[0]
    leaves = [t.detach().requires_grad_(True) for _, t in named]
    params = tree_flatten_with_names(model.params)[1](leaves)
    total, ce = lm_loss_fn(model, None)(params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    gs = torch.autograd.grad(total, leaves)
    out = RUNNER._by_reference_name({k: g for (k, _), g in zip(named, gs)}, names)
    return float(ce.detach()), float(total.detach()), out


def test_port_matches_reference_f32():
    model = seeded_model()
    tokens = zipf_tokens(2, S, seed=1)
    with torch.no_grad():
        logits, _, aux = model.forward(model.params, tokens[:, :-1])
    r_logits, r_ce, r_aux, r_grads = reference_step(model, tokens)
    assert rel(logits, r_logits) < 1e-5
    assert math.isclose(float(aux), r_aux, rel_tol=1e-5)
    ce, total, grads = port_grads(model, tokens)
    assert math.isclose(ce, r_ce, rel_tol=1e-5) and math.isclose(total, r_ce + r_aux, rel_tol=1e-5)
    assert sorted(grads) == sorted(r_grads)
    for k in r_grads:
        assert rel(grads[k], r_grads[k]) < 1e-4, k


def test_one_momentum_step_f32():
    model = seeded_model()
    tokens = zipf_tokens(2, S, seed=2)
    _, _, _, r_grads = reference_step(model, tokens)
    w0, names = reference_of(model)
    p0 = {k: RUNNER._by_reference_name({n: t.detach().clone() for n, t in
                                        tree_flatten_with_names(model.params)[0]}, names)[k]
          for k in w0}
    step, opt = make_train_step(model, lr=0.01, weight_decay=0.0, inplace=True)
    state = opt.init(model.params)
    params, state, _ = step(model.params, state, {"tokens": tokens[:, :-1],
                                                 "labels": tokens[:, 1:]}, None)
    assert params is model.params  # written in place
    p1 = RUNNER._by_reference_name(dict(tree_flatten_with_names(params)[0]), names)
    for k, g in r_grads.items():
        want = p0[k] - 0.01 * g
        assert rel(p1[k] - p0[k], want - p0[k]) < 1e-3, k  # f32 rounding of p + v


@pytest.mark.parametrize("weight_decay", [0.0, 1e-3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inplace_momentum_matches_the_functional_update(dtype, weight_decay):
    """``MomentumSGD.inplace`` gives the functional update's bits: the
    parameters and the f32 velocity, over four steps of the model's own
    gradients (the velocity carried from step to step)."""
    from repro_torch.launch.steps import _microbatched_grad
    from repro_torch.optim.sgd import MomentumSGD

    model = seeded_model(dtype=dtype)
    loss_fn = lm_loss_fn(model, None)
    funct = MomentumSGD(momentum=0.9, weight_decay=weight_decay)
    inpl = dataclasses.replace(funct, inplace=True)
    pf = tree_map(lambda t: t.detach().clone(), model.params)
    pi = tree_map(lambda t: t.detach().clone(), model.params)
    sf, si = funct.init(pf), inpl.init(pi)
    for step in range(4):
        tokens = zipf_tokens(2, S, seed=10 + step)
        _, _, grads = _microbatched_grad(loss_fn, pf, {"tokens": tokens[:, :-1],
                                                       "labels": tokens[:, 1:]}, 1)
        pf, sf = funct.update(grads, sf, pf, 0.01)
        pi_new, si = inpl.update(grads, si, pi, 0.01)
        assert pi_new is pi  # written in place
        for tree_f, tree_i in ((pf, pi), (sf.velocity, si.velocity)):
            for (k, a), (_, b) in zip(tree_flatten_with_names(tree_f)[0],
                                      tree_flatten_with_names(tree_i)[0]):
                assert a.dtype == b.dtype and torch.equal(a, b), (step, k)
    assert int(sf.step) == int(si.step) == 4


def test_port_matches_reference_bf16():
    """The bf16 model against the f32 reference on its bf16 weights, routed
    by the port's own choices (a bf16 router's near ties would move whole
    tokens): looser, at bf16's rounding."""
    model = seeded_model("bfloat16")
    tokens = zipf_tokens(2, S, seed=3)
    routes, undo = record_routes()
    try:
        ce, total, grads = port_grads(model, tokens)
    finally:
        undo()
    n_moe = SMOKE.slot_ffn.count("moe")
    r_logits, r_ce, r_aux, r_grads = reference_step(model, tokens, routes=routes[:n_moe])
    assert abs(ce - r_ce) / r_ce < 5e-3
    norms = sorted(float(g.norm()) for g in r_grads.values())
    med = norms[len(norms) // 2]
    for k, g in r_grads.items():
        assert float((grads[k].float() - g).norm()) / max(float(g.norm()), med) < 0.15, k


# -- dropless MoE, the held share ---------------------------------------------------------------


def moe_setup(held=None, skew=True, seed=0, T=64):
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=24, dropless=True,
                        norm_topk_prob=False, held=held)
    g = torch.Generator().manual_seed(seed)
    params = moe.init_moe(g, dataclasses.replace(cfg, held=None), torch.float32,
                          torch.device("cpu"))
    if skew:  # most tokens to expert 0
        params["router"][:, 0] += 3.0
    x = torch.randn(T, 16, generator=g) + 1.0
    return cfg, params, x


def test_dropless_matches_a_per_token_loop_and_repeats_its_bits():
    cfg, params, x = moe_setup()
    with obs.trace_to(__import__("io").StringIO()) as tracer:
        y, stats = moe.moe_fwd(params, x, cfg)
        spans = [e for e in tracer._buf if e.get("ev") == "span" and e["name"] == "lm.moe"]
    probs = torch.softmax(x @ params["router"], -1)
    gate, eidx = torch.topk(probs, 2, -1)
    counts = torch.bincount(eidx.reshape(-1), minlength=4)
    assert int(counts[0]) > 64 * 2 * 1.25 / 4  # past what a capacity of 1.25 keeps
    assert spans[0]["attrs"]["max_rows"] == int(counts.max())
    assert spans[0]["attrs"]["rows"] == 128 and spans[0]["attrs"]["host_syncs"] == 1
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for k in range(2):
            e = int(eidx[t, k])
            h = torch.nn.functional.silu(x[t] @ params["wi_gate"][e]) * (x[t] @ params["wi_up"][e])
            want[t] += gate[t, k] * (h @ params["wo"][e])
    assert torch.allclose(y, want, atol=1e-5, rtol=1e-5)
    y2, stats2 = moe.moe_fwd(params, x, cfg)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    # the pooled loss of one layer is load_balancing_loss_func's
    f = torch.nn.functional.one_hot(eidx, 4).float().mean(0)
    assert torch.allclose(moe.pooled_aux(stats, cfg), 0.01 * 4 * (f * probs.mean(0)).sum())


def test_held_shares_add_up_to_the_uncut_layer():
    cfg, params, x = moe_setup(skew=False, seed=1)
    whole, _ = moe.moe_fwd(params, x, cfg)
    parts = []
    for first, stop in ((0, 2), (2, 4)):
        share = dict(params, **{k: params[k][first:stop] for k in ("wi_gate", "wi_up", "wo")})
        y, _ = moe.moe_fwd(share, x, dataclasses.replace(cfg, held=(first, stop)))
        parts.append(y)
    assert torch.allclose(parts[0] + parts[1], whole, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        moe.moe_fwd(params, x, dataclasses.replace(cfg, dropless=False, held=(0, 2)))


def test_reference_held_shares_add_up():
    """The same in the reference: each share's layer output minus its
    input (the FFN's part, with the mixer's alike in both) adds up."""
    model = seeded_model()
    w = {k: v.detach() for k, v in reference_weights(model).items()}
    cfg = ref.config_from_json(smoke_json())
    x = torch.randn(2, 8, SMOKE.d_model, generator=torch.Generator().manual_seed(4))
    lw = {n.split(".", 1)[1]: w[n] for n in ref.layer_leaves(cfg, 1)}
    whole, _ = ref.moe(lw, x, cfg, "f32")
    parts = 0
    for first, stop in ((0, 2), (2, 4)):
        c = dict(cfg, held=(first, stop))
        sw = dict(lw, **{k: lw[k][first:stop] for k in ("gate", "up", "down")})
        parts = parts + ref.moe(sw, x, c, "f32")[0]
    assert torch.allclose(parts, whole, atol=1e-6, rtol=1e-5)


# -- decode ----------------------------------------------------------------------------------


def test_prefill_then_decode_matches_the_full_forward():
    """A prompt of 8 through decode mode at once (Mamba's conv and SSM
    state, the attention layer's K/V written), then 8 tokens one at a
    time, against the teacher-forced forward."""
    model = seeded_model()
    tokens = zipf_tokens(2, 15, seed=5)
    with torch.no_grad():
        full, _, _ = model.forward(model.params, tokens)
        caches = model.init_caches(2, 16, dtype=torch.float32)
        assert set(caches["stack"]["s0_mamba"]) == {"ssm", "conv"}
        assert set(caches["stack"]["s4_global"]) == {"k", "v"}
        lg, caches, _ = model.forward(model.params, tokens[:, :8], positions=torch.arange(8),
                                      mode="decode", caches=caches)
        outs = [lg]
        for pos in range(8, 16):
            lg, caches, _ = model.forward(model.params, tokens[:, pos:pos + 1],
                                          positions=torch.tensor([pos]), mode="decode",
                                          caches=caches)
            outs.append(lg)
    got = torch.cat(outs, dim=1)
    assert torch.allclose(got, full, atol=1e-4, rtol=1e-4)


# -- the embedding's gradient ----------------------------------------------------------------


def test_bf16_embedding_gradient_sums_in_f32_and_rounds_once():
    g = torch.Generator().manual_seed(0)
    table = (0.02 * torch.randn(512, 32, generator=g)).bfloat16().requires_grad_(True)
    tokens = zipf_tokens(4, 2047, seed=6)  # 8,192 Zipf tokens: the head rows hit thousands of times
    up = torch.randn(4, 2048, 32, generator=g).bfloat16()
    (L.embed({"table": table}, tokens) * up).sum().backward()
    want = torch.zeros(512, 32).index_add_(0, tokens.reshape(-1), up.float().reshape(-1, 32))
    assert table.grad.dtype == torch.bfloat16
    assert torch.equal(table.grad, want.bfloat16())
    assert int(torch.bincount(tokens.reshape(-1)).max()) > 1000
    # bf16 accumulation (indexing's own backward) would be far off on those rows
    naive = torch.zeros(512, 32, dtype=torch.bfloat16).index_put_(
        (tokens.reshape(-1),), up.reshape(-1, 32), accumulate=True)
    assert rel(naive.float(), want) > rel(table.grad.float(), want)


def test_f32_embedding_keeps_plain_indexing():
    table = torch.randn(16, 4, requires_grad=True)
    tokens = torch.tensor([[1, 1, 3]])
    out = L.embed({"table": table}, tokens)
    assert out.grad_fn.name() == "IndexBackward0"
