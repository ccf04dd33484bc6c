"""Gemma2-2B [arXiv:2408.00118]: 26L d=2304 8H(kv4) d_ff=9216 vocab 256000,
local/global alternating (window 4096), attn softcap 50, final softcap 30,
post-norms. Windowed half -> long_500k runs."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="gemma2-2b", vocab=256000, d_model=2304, n_layers=26,
    n_heads=8, n_kv=4, head_dim=256, d_ff=9216,
    pattern=("local", "global"), window=4096,
    softcap=50.0, final_softcap=30.0, post_norms=True,
    embed_scale=True, tied_embeddings=True, activation="gelu_tanh",
)

SMOKE = ModelConfig(
    name="gemma2-smoke", vocab=512, d_model=64, n_layers=4,
    n_heads=4, n_kv=2, head_dim=16, d_ff=128,
    pattern=("local", "global"), window=16,
    softcap=50.0, final_softcap=30.0, post_norms=True, embed_scale=True,
    tied_embeddings=True, activation="gelu_tanh", dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="gemma2-2b", family="dense", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True, "long_500k": True},
    source="arXiv:2408.00118",
)
