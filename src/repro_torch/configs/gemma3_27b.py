"""Gemma3-27B [hf:google/gemma-3-*; unverified tier]: 62L d=5376 32H(kv16)
d_ff=21504 vocab 262144, 5:1 local:global (window 1024), dual rope theta
(local 10k / global 1M), post-norms, 128k context. Local-majority windowed
cache -> long_500k runs (global layers decode O(KV) linear)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma3-27b", vocab=262144, d_model=5376, n_layers=62,
    n_heads=32, n_kv=16, head_dim=128, d_ff=21504,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, rope_theta=1e6, rope_theta_local=10000.0,
    post_norms=True, embed_scale=True, tied_embeddings=True,
    activation="gelu_tanh",
)

SMOKE = ModelConfig(
    name="gemma3-smoke", vocab=512, d_model=64, n_layers=8,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=16, rope_theta_local=10000.0, post_norms=True, embed_scale=True,
    tied_embeddings=True, activation="gelu_tanh", dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="gemma3-27b", family="dense", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True, "long_500k": True},
    source="hf:google/gemma-3-1b-pt (unverified)",
)
