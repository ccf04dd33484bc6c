"""Falcon-Mamba-7B [arXiv:2410.05355; unverified tier]: 64L d=4096 mamba1
(d_inner 8192, d_state 16, d_conv 4), attn-free, vocab 65024. O(1) state ->
all shapes incl. long_500k."""
from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b", vocab=65024, d_model=4096, n_layers=64,
    pattern=("mamba",), d_inner=8192, d_state=16,
    tied_embeddings=False, norm="rms",
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke", vocab=512, d_model=64, n_layers=2,
    pattern=("mamba",), d_inner=128, d_state=4,
    tied_embeddings=False, dtype="float32", ssm_chunk=16,
)

SPEC = ArchSpec(
    arch_id="falcon-mamba-7b", family="ssm", config=FULL, smoke=SMOKE,
    shapes={"train_4k": True, "prefill_32k": True, "decode_32k": True, "long_500k": True},
    source="arXiv:2410.05355 (unverified)",
)
