"""PaliGemma-3B [arXiv:2407.07726]: gemma-2b backbone 18L d=2048 8H(kv1)
d_ff=16384 vocab 257216; SigLIP frontend STUBBED (input_specs feeds 256 patch
embeddings as a bidirectional PrefixLM prefix). Full attention -> long skip."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="paligemma-3b", vocab=257216, d_model=2048, n_layers=18,
    n_heads=8, n_kv=1, head_dim=256, d_ff=16384, pattern=("global",),
    embed_scale=True, tied_embeddings=True, activation="gelu_tanh",
    prefix_len=256,
)

SMOKE = ModelConfig(
    name="paligemma-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, n_kv=1, head_dim=16, d_ff=128, pattern=("global",),
    embed_scale=True, tied_embeddings=True, activation="gelu_tanh",
    prefix_len=8, dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="paligemma-3b", family="vlm", config=FULL, smoke=SMOKE,
    shapes={
        "train_4k": True, "prefill_32k": True, "decode_32k": True,
        "long_500k": "skip: pure full attention (DESIGN.md §Shape-skips)",
    },
    prefix_tokens=256,
    source="arXiv:2407.07726",
)
