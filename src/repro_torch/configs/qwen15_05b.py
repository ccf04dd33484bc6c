"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B]: 24L d=1024 16H(kv16, MHA) d_ff=2816
vocab 151936, QKV bias, tied embeddings. Full attention -> long skip."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-0.5b", vocab=151936, d_model=1024, n_layers=24,
    n_heads=16, n_kv=16, head_dim=64, d_ff=2816, pattern=("global",),
    qkv_bias=True, rope_theta=1e6, tied_embeddings=True, activation="silu",
)

SMOKE = ModelConfig(
    name="qwen15-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=4, head_dim=16, d_ff=128, pattern=("global",),
    qkv_bias=True, tied_embeddings=True, dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="qwen1.5-0.5b", family="dense", config=FULL, smoke=SMOKE,
    shapes={
        "train_4k": True, "prefill_32k": True, "decode_32k": True,
        "long_500k": "skip: pure full attention (DESIGN.md §Shape-skips)",
    },
    source="hf:Qwen/Qwen1.5-0.5B",
)
