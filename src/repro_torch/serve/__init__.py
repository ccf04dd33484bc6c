"""Serving: deployment-time compaction, the inference engine (MLP kind) and
the checkpoint glue that serves a trained model."""
from repro_torch.serve.compact import (
    CompactionReport,
    compact_element_mlp,
    eliminate_dead_neurons,
    importance_prune_mlp,
)
from repro_torch.serve.engine import EngineConfig, SparseInferenceEngine, save_mlp_for_serving

__all__ = [
    "CompactionReport",
    "EngineConfig",
    "SparseInferenceEngine",
    "compact_element_mlp",
    "eliminate_dead_neurons",
    "importance_prune_mlp",
    "save_mlp_for_serving",
]
