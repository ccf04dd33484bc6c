"""Whisper-medium [arXiv:2212.04356; unverified tier]: 24+24L d=1024 16H
d_ff=4096 vocab 51865, enc-dec; conv frontend STUBBED (input_specs provides
precomputed frame embeddings). Shape mapping (DESIGN.md): seq_len = encoder
frames for train/prefill; decode_32k = decoder self-cache of 32768 with
cross-attention to a 1500-frame memory. long_500k skipped (full attention,
no windowing in the architecture)."""
from repro_torch.configs import ArchSpec
from repro_torch.models.whisper import WhisperConfig

FULL = WhisperConfig(
    name="whisper-medium", vocab=51865, d_model=1024, n_layers=24,
    n_heads=16, head_dim=64, d_ff=4096, n_frames=32768, max_text=32768,
)

SMOKE = WhisperConfig(
    name="whisper-smoke", vocab=512, d_model=64, n_layers=2,
    n_heads=4, head_dim=16, d_ff=128, n_frames=32, max_text=32,
    dtype="float32", kv_chunk=16,
)

SPEC = ArchSpec(
    arch_id="whisper-medium", family="audio", config=FULL, smoke=SMOKE,
    shapes={
        "train_4k": True, "prefill_32k": True, "decode_32k": True,
        "long_500k": "skip: enc-dec full attention, no windowing (DESIGN.md)",
    },
    source="arXiv:2212.04356 (unverified)",
)
