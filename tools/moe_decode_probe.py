"""Where a full-depth qwen3-moe-30b-a3b decode step on the card parts from
each slot decoded alone (run on one card, ~1 min):

    python3 tools/moe_decode_probe.py

The model and prompts of ``chip_smoke.py``'s ``lm_moe`` phase (seed 0,
drawn on the card, 8 slots prefilled in two calls). For the first decode
step it records every layer's MoE input and top-k experts in the engine's
all-slots step (one dispatch group a slot) and in each slot's batch-1 step
on a copy of its cache rows, and prints one JSON line a layer: the largest
difference of the MoE inputs, the slots whose expert sets differ, and the
smallest gap between a slot's k-th and (k+1)-th router probability. Then
the logits' largest difference, their scale, the elements past
``logits_close``'s bound, and the argmax agreement; and the same for
each slot computed in a batch of 8 copies of its own row (one group a
row), which runs the products at the all-slots step's shapes.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.serve import EngineConfig, SparseInferenceEngine  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


def recorded(fn):
    """``fn()`` with every MoE call's input and top-k experts recorded."""
    calls, real = [], cs.transformer_mod.moe_fwd

    def rec(params, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        probs = torch.softmax((xt @ params["router"].to(xt.dtype)).float(), -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1)
        calls.append(dict(x=xt.float(), experts=top.indices[:, :cfg.top_k].sort(-1).values,
                          gap=(top.values[:, cfg.top_k - 1] - top.values[:, cfg.top_k])))
        return real(params, x, cfg)

    cs.transformer_mod.moe_fwd = rec
    try:
        return fn(), calls
    finally:
        cs.transformer_mod.moe_fwd = real


def main() -> int:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cs.phase_device({})  # prints the card's name and power limit
    cfg = cs.get_spec(cs.MOE_ARCH).config
    model, _, _ = cs.drawn_model(cfg)
    engine = SparseInferenceEngine(model, engine=EngineConfig(**cs.LM_ENGINE))
    S, V = engine.cfg.max_slots, cfg.vocab
    rng = np.random.default_rng(cs.SEED)
    lens = rng.integers(cs.LM_TRACE["prompt_lens"][0], cs.LM_TRACE["prompt_lens"][1] + 1, S)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in lens]
    tokens = np.concatenate([engine.prefill(prompts[:4], [0, 1, 2, 3]),
                             engine.prefill(prompts[4:], [4, 5, 6, 7])]).astype(np.int64)
    pos = lens.astype(np.int64)
    c = engine._caches

    def rows(s, n):
        return {"stack": tree_map(lambda a: a[:, s:s + 1].repeat_interleave(n, 1), c["stack"]),
                "rest": tree_map(lambda a: a[s:s + 1].repeat_interleave(n, 0), c["rest"])}

    def slot_step(s, n):
        lg, _, _ = model.forward(
            engine._params, torch.full((n, 1), int(tokens[s]), device=cs.CARD),
            positions=torch.full((n, 1), int(pos[s]), device=cs.CARD), mode="decode",
            caches=rows(s, n), moe_groups=n)
        return lg[0, -1].float()

    with torch.inference_mode():
        alone = [recorded(lambda s=s: slot_step(s, 1)) for s in range(S)]
        eights = torch.stack([slot_step(s, S) for s in range(S)])
        got, g_calls = recorded(lambda: engine._step_logits(
            engine._params, engine._topo, c, torch.as_tensor(tokens, device=cs.CARD),
            torch.as_tensor(pos, device=cs.CARD)).float())
        want = torch.stack([a[0] for a in alone])
        for layer, g in enumerate(g_calls):
            a_x = torch.cat([a[1][layer]["x"] for a in alone])
            a_e = torch.cat([a[1][layer]["experts"] for a in alone])
            a_gap = torch.cat([a[1][layer]["gap"] for a in alone])
            print(json.dumps({"moe_layer": dict(
                layer=layer, x_max_abs_diff=float((g["x"] - a_x).abs().max()),
                x_scale=float(a_x.abs().max()),
                slots_with_other_experts=[s for s in range(S)
                                          if not torch.equal(g["experts"][s], a_e[s])],
                min_topk_gap=float(a_gap.min()))}))
    for name, ref in (("alone", want), ("eight_copies", eights)):
        diff = (got - ref).abs()
        bound = cs.LM_LOGIT_ATOL + cs.LM_LOGIT_RTOL * ref.abs()
        top2 = ref.topk(2, -1).values
        held = (top2[:, 0] - top2[:, 1]) > cs.LM_LOGIT_ATOL
        print(json.dumps({"moe_logits": dict(
            against=name, max_abs_diff=float(diff.max()), scale=float(ref.abs().max()),
            past_bound=int((diff > bound).sum()), per_slot_max=diff.max(-1).values.tolist(),
            argmax_agree=(got.argmax(-1) == ref.argmax(-1)).tolist(), held=held.tolist())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
