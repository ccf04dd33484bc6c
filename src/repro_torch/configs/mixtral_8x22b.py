"""Mixtral-8x22B [arXiv:2401.04088]: 56L d=6144 48H(kv8) MoE 8e top-2,
expert d_ff=16384, vocab 32768, sliding-window attention (per assignment).
SWA ring cache -> long_500k runs."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="mixtral-8x22b", vocab=32768, d_model=6144, n_layers=56,
    n_heads=48, n_kv=8, head_dim=128, d_ff=0, pattern=("local",),
    window=4096, ffn="moe", n_experts=8, top_k=2, expert_d_ff=16384,
    rope_theta=1e6, tied_embeddings=False, activation="silu",
)

SMOKE = ModelConfig(
    name="mixtral-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=8, n_kv=2, head_dim=8, d_ff=0, pattern=("local",), window=16,
    ffn="moe", n_experts=4, top_k=2, expert_d_ff=32,
    tied_embeddings=False, dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x22b", family="moe", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True, "long_500k": True},
    source="arXiv:2401.04088",
)
