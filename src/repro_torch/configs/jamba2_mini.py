"""AI21-Jamba2-Mini [hf:ai21labs/AI21-Jamba2-Mini, config.json; Jamba 1.5/1.6/1.7
Mini, 52B-A12B]: 32L d=4096 in periods of 8 layers, attention at i % 8 == 4
(32H kv8, head_dim 128, no position encoding) and Mamba-1 elsewhere
(d_inner 8192, d_state 16, d_conv 4 with bias, dt_rank 256, RMSNorms on
dt, B and C); every layer has an FFN, MoE at odd i (16 experts of width
14,336, top-2 over an f32 softmax, gates not renormalised, no token
dropped) and a dense SwiGLU of 14,336 elsewhere; vocab 65536, untied; the
load-balancing loss of ``load_balancing_loss_func`` at 0.001.

``FULL`` is the published config. ``STAGE`` is one pipeline stage's
expert-parallel share of an 8-chip deployment (4 stages of one period, each
stage on 2 chips with 8 experts a chip): one period of 8 layers, experts
0-7 of 16 held, every width as published. ``SMOKE`` keeps the period's
structure at tiny widths in f32. Not in ``list_archs()``: the JAX package
has no twin of it.
"""
import dataclasses

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import HybridConfig

PATTERN = ("mamba", "mamba", "mamba", "mamba", "global", "mamba", "mamba", "mamba")
SLOT_FFN = ("gated", "moe") * 4

FULL = HybridConfig(
    name="jamba2-mini", vocab=65536, d_model=4096, n_layers=32,
    n_heads=32, n_kv=8, head_dim=128, d_ff=14336, pattern=PATTERN, slot_ffn=SLOT_FFN,
    rope=False, causal_skip=True, n_experts=16, top_k=2, expert_d_ff=14336,
    moe_dropless=True, moe_norm_topk=False, moe_aux_weight=0.001,
    d_inner=8192, d_state=16, mamba_norms=True, tied_embeddings=False, norm="rms",
    activation="silu",
)

STAGE = dataclasses.replace(FULL, name="jamba2-mini-1p8e", n_layers=8, moe_held=(0, 8))

SMOKE = HybridConfig(
    name="jamba2-mini-smoke", vocab=512, d_model=64, n_layers=8,
    n_heads=4, n_kv=2, head_dim=16, d_ff=96, pattern=PATTERN, slot_ffn=SLOT_FFN,
    rope=False, causal_skip=True, n_experts=4, top_k=2, expert_d_ff=96,
    moe_dropless=True, moe_norm_topk=False, moe_aux_weight=0.001,
    d_inner=128, d_state=8, mamba_norms=True, tied_embeddings=False, norm="rms",
    activation="silu", dtype="float32", kv_chunk=16, ssm_chunk=16,
)

SPEC = ArchSpec(
    arch_id="jamba2-mini", family="hybrid", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True,
            "long_500k": "skip: past the published 262,144-token context"},
    source="https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json",
)
