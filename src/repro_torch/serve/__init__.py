"""Serving: deployment-time compaction, the inference engine (MLP and LM
kinds), continuous batching, and the checkpoint glue that serves a trained
model. The reference's ``serve.metrics`` and ``serve.gateway`` come with
ROADMAP Queue 1, item 6."""
from repro_torch.serve.batcher import (
    ContinuousBatcher,
    Request,
    ServeStats,
    poisson_trace,
    serve_sequential,
)
from repro_torch.serve.compact import (
    CompactionReport,
    compact_block_lm,
    compact_element_mlp,
    eliminate_dead_neurons,
    importance_prune_mlp,
)
from repro_torch.serve.engine import (
    EngineConfig,
    SparseInferenceEngine,
    save_lm_for_serving,
    save_mlp_for_serving,
)

__all__ = [
    "CompactionReport",
    "ContinuousBatcher",
    "EngineConfig",
    "Request",
    "ServeStats",
    "SparseInferenceEngine",
    "compact_block_lm",
    "compact_element_mlp",
    "eliminate_dead_neurons",
    "importance_prune_mlp",
    "poisson_trace",
    "save_lm_for_serving",
    "save_mlp_for_serving",
    "serve_sequential",
]
