"""InternLM2-1.8B [arXiv:2403.17297]: 24L d=2048 16H(kv8) d_ff=8192
vocab 92544, GQA. Full attention -> long skip."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", vocab=92544, d_model=2048, n_layers=24,
    n_heads=16, n_kv=8, head_dim=128, d_ff=8192, pattern=("global",),
    rope_theta=1e6, tied_embeddings=False, activation="silu",
)

SMOKE = ModelConfig(
    name="internlm2-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128, pattern=("global",),
    tied_embeddings=False, dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="internlm2-1.8b", family="dense", config=FULL, smoke=SMOKE,
    shapes={
        "train_4k": True, "prefill_32k": True, "decode_32k": True,
        "long_500k": "skip: pure full attention (DESIGN.md §Shape-skips)",
    },
    source="arXiv:2403.17297",
)
