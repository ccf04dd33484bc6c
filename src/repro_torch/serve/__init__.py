"""Serving: deployment-time compaction, the inference engine (MLP and LM
kinds), continuous batching, the checkpoint glue that serves a trained
model, and the overload-safe control plane over them: ``serve.metrics``
(rolling windows, the ``healthy -> degraded -> browned_out`` state machine)
and ``serve.gateway`` (``ServingGateway``: deadlines, shedding, bounded
retries, the circuit breaker, brownout; it never raises an engine fault to
the caller)."""
from repro_torch.serve.batcher import (
    ContinuousBatcher,
    Request,
    ServeStats,
    poisson_trace,
    serve_sequential,
)
from repro_torch.serve.gateway import (
    CircuitBreaker,
    GatewayConfig,
    GatewayStats,
    ServingGateway,
)
from repro_torch.serve.metrics import (
    BROWNED_OUT,
    DEGRADED,
    HEALTHY,
    HealthMonitor,
    HealthThresholds,
    RollingWindow,
    ServeMetrics,
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
    "BROWNED_OUT",
    "CircuitBreaker",
    "CompactionReport",
    "ContinuousBatcher",
    "DEGRADED",
    "EngineConfig",
    "GatewayConfig",
    "GatewayStats",
    "HEALTHY",
    "HealthMonitor",
    "HealthThresholds",
    "Request",
    "RollingWindow",
    "ServeMetrics",
    "ServeStats",
    "ServingGateway",
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
