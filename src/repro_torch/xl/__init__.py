"""repro_torch.xl — out-of-core extreme-scale training substrate (DESIGN.md
§7), the twin of ``repro.xl``.

Trains element-sparse MLPs whose live parameters (values + dual-order COO
topology + momentum) exceed device memory: a memory-budget **planner**
solves for a static shard capacity/chunk width/leaf placement, the
**stream** executor runs forward/backward as a double-buffered
connection-shard stream through a ring of pinned host buffers over two
per-shard products (``kernels.ops.xl_shard_acc`` / ``xl_shard_dw``: kernels
A and F; static device buffers across shards, layers and epochs), and
**evolve** runs the SET prune/regrow cycle
shard-wise with a streamed quantile sketch so no whole-layer ``(nnz,)``
array is ever materialized. The plan artifact is shared by the trainer
(``train.trainer.XLTrainer``), the streamed checkpoint path
(``CheckpointManager.save_streamed``) and the Table-4 benchmarks.
"""
from repro_torch.xl.evolve import (
    evolve_layer_streamed,
    evolve_model_streamed,
    streamed_sign_thresholds,
)
from repro_torch.xl.planner import (
    PlannerError,
    XLLayerPlan,
    XLPlan,
    estimate_in_core_bytes,
    plan_memory_budget,
)
from repro_torch.xl.stream import (
    StreamExecutor,
    XLLayerState,
    XLModelState,
    compile_counts,
)

__all__ = [
    "PlannerError",
    "XLLayerPlan",
    "XLPlan",
    "plan_memory_budget",
    "estimate_in_core_bytes",
    "StreamExecutor",
    "XLLayerState",
    "XLModelState",
    "compile_counts",
    "evolve_layer_streamed",
    "evolve_model_streamed",
    "streamed_sign_thresholds",
]
