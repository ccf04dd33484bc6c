"""Serving: deployment-time compaction and the inference engine (MLP kind)."""
from repro_torch.serve.compact import (
    CompactionReport,
    compact_element_mlp,
    eliminate_dead_neurons,
    importance_prune_mlp,
)
from repro_torch.serve.engine import EngineConfig, SparseInferenceEngine

__all__ = [
    "CompactionReport",
    "EngineConfig",
    "SparseInferenceEngine",
    "compact_element_mlp",
    "eliminate_dead_neurons",
    "importance_prune_mlp",
]
