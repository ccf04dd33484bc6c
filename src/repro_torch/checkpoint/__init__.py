"""Checkpoints in the reference's on-disk layout (``checkpoint.manager``)."""
from repro_torch.checkpoint.manager import CheckpointCorruptError, CheckpointManager

__all__ = ["CheckpointCorruptError", "CheckpointManager"]
