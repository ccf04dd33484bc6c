"""RecurrentGemma-2B [arXiv:2402.19427]: 26L d=2560 RG-LRU (d_rnn 2560) +
local attn (10H kv1, window 2048) in 1:2 attention:recurrent pattern,
d_ff=7680, vocab 256000. Recurrent state + ring cache -> long_500k runs."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", vocab=256000, d_model=2560, n_layers=26,
    n_heads=10, n_kv=1, head_dim=256, d_ff=7680,
    pattern=("rglru", "rglru", "local"), window=2048, d_rnn=2560,
    embed_scale=True, tied_embeddings=True, activation="gelu_tanh",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", vocab=512, d_model=64, n_layers=6,
    n_heads=4, n_kv=1, head_dim=16, d_ff=128,
    pattern=("rglru", "rglru", "local"), window=16, d_rnn=64,
    embed_scale=True, tied_embeddings=True, activation="gelu_tanh",
    dtype="float32", kv_chunk=16, ssm_chunk=16,
)

SPEC = ArchSpec(
    arch_id="recurrentgemma-2b", family="hybrid", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True, "long_500k": True},
    source="arXiv:2402.19427",
)
