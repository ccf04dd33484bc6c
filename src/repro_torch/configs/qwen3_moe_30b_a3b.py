"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H(kv4) MoE 128e top-8,
expert d_ff=768, vocab 151936. Pure full attention -> long_500k skipped."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-30b-a3b", vocab=151936, d_model=2048, n_layers=48,
    n_heads=32, n_kv=4, head_dim=128, d_ff=0, pattern=("global",),
    ffn="moe", n_experts=128, top_k=8, expert_d_ff=768,
    rope_theta=1e6, tied_embeddings=False, activation="silu",
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=8, n_kv=2, head_dim=8, d_ff=0, pattern=("global",),
    ffn="moe", n_experts=8, top_k=2, expert_d_ff=32,
    rope_theta=1e6, tied_embeddings=False, dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="qwen3-moe-30b-a3b", family="moe", config=FULL, smoke=SMOKE,
    shapes={
        "train_4k": True, "prefill_32k": True, "decode_32k": True,
        "long_500k": "skip: pure full attention (DESIGN.md §Shape-skips)",
    },
    source="hf:Qwen/Qwen3-30B-A3B",
)
