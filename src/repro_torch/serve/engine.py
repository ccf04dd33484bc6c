"""``SparseInferenceEngine`` — the truly sparse serving runtime, MLP kind.

Twin of ``repro.serve.engine`` for the SET-MLP: run deployment-time
compaction (``serve.compact``), freeze the topology on the device ONCE (the
dual-order COO views plus each layer's column offsets for kernel A — they
never change again), and serve ``classify`` through the forward-only
``mlp_forward(..., infer=True)`` behind a bounded LRU keyed by batch bucket.

PyTorch runs eagerly, so a bucket's entry is the forward bound to that
bucket's shape, and a bucket's first use counts as its "compile" in
``stats`` (the reference counts XLA compilations there); ``jit_entry_sizes``
counts the built entries per bucket, the reference's executable count: 1
after warm-up. The counters keep their meaning for the later per-bucket
CUDA-graph cache.

``save_mlp_for_serving`` writes a trained model in the reference's
checkpoint layout and ``SparseInferenceEngine.from_checkpoint`` serves it
(either package's), with the saved connectivity.

Not in this slice, and refused naming the ROADMAP item: block models
(Queue 1, item 6) and the LM kind with ``save_lm_for_serving`` (item 7).
The ``obs`` spans come with item 4.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.importance import PruningSchedule
from repro_torch.core.sparsity import ElementTopology
from repro_torch.device import resolve_device
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, mlp_forward
from repro_torch.serve.compact import CompactionReport, compact_element_mlp

__all__ = ["EngineConfig", "SparseInferenceEngine", "save_mlp_for_serving"]

DeviceLike = Optional[Union[str, torch.device]]
_BLOCK = ("the engine serves element (COO) models; block compaction and serving come with "
          "a later slice (ROADMAP Queue 1, item 6)")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving shapes and cache policy. Buckets are the ONLY batch shapes
    the engine ever runs — admission clamps everything else to them. The
    LM kind's fields come with the LM kind."""

    batch_buckets: Tuple[int, ...] = (1, 8, 32, 128)  # MLP classify
    compile_cache_max: int = 32


class _BucketCache:
    """Bounded LRU of per-bucket forward callables with hit/miss accounting.

    A miss builds the bucket's entry and counts as a compile; eviction drops
    the entry, so a re-request counts as a compile again."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._d: "collections.OrderedDict[Tuple, Callable]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Tuple, build: Callable[[], Callable]) -> Callable:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        fn = build()
        self._d[key] = fn
        if len(self._d) > self.maxsize:
            self._d.popitem(last=False)
            self.evictions += 1
        return fn

    def __len__(self) -> int:
        return len(self._d)

    def entry_sizes(self) -> Dict[Tuple, int]:
        # an entry is one forward built for its bucket's one input shape
        return {k: 1 for k in self._d}


class SparseInferenceEngine:
    def __init__(
        self,
        model: SparseMLP,
        *,
        engine: EngineConfig = EngineConfig(),
        compaction: Optional[PruningSchedule] = None,
        compact: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``device=None`` means the card; without one it raises (pass
        ``device="cpu"`` for the plain versions)."""
        if not isinstance(model, SparseMLP):
            raise TypeError(
                f"unsupported model {type(model)!r}: the port serves SparseMLP; "
                "the LM kind comes with the LM slice"
            )
        if model.config.impl != "element":
            raise NotImplementedError(f"impl={model.config.impl!r}: {_BLOCK}")
        self.device = resolve_device(device)
        self.cfg = engine
        self.report: Optional[CompactionReport] = None
        self._cache = _BucketCache(engine.compile_cache_max)
        # chaos seam: called as fault_hook(op, call_index) at the top of every
        # served entry point, BEFORE any state mutation, so a retry of the
        # same call after a raise here is safe. ``call_index`` is monotone.
        self.fault_hook: Optional[Callable[[str, int], None]] = None
        self._engine_calls = 0
        self.kind = "mlp"
        if compact:
            model, self.report = compact_element_mlp(model, compaction)
        self.model = SparseMLP.from_state(
            model.config, model.topos, model.values, model.biases, device=self.device
        )
        self._params = self.model.params()
        # frozen once: the dual-order COO views, with kernel A's column
        # offsets registered to them (which also give kernel A its route, from
        # the host's longest segment)
        self._topo = self.model.topo_arrays()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls,
        directory,
        *,
        step: Optional[int] = None,
        engine: EngineConfig = EngineConfig(),
        compaction: Optional[PruningSchedule] = None,
        compact: bool = True,
        device: DeviceLike = None,
    ) -> "SparseInferenceEngine":
        """Restore the model a training run saved with
        ``save_mlp_for_serving`` (this package's or the reference's) and
        serve it on ``device`` (``None``: the card). The manifest's
        ``serve_kind`` selects the restore path; the topology files rebuild
        the host topologies, so the served connectivity is exactly the
        trained one, not the seed's draw."""
        mgr = (directory if isinstance(directory, CheckpointManager)
               else CheckpointManager(str(directory)))
        meta = mgr.read_manifest(step).get("meta", {})
        kind = meta.get("serve_kind")
        if kind == "lm":
            raise NotImplementedError(
                "serving an LM checkpoint comes with the LM slice (ROADMAP Queue 1, item 7)")
        if kind != "mlp":
            raise ValueError(
                f"checkpoint has no serve_kind meta (got {kind!r}); save it "
                "with serve.engine.save_mlp_for_serving"
            )
        model = _restore_mlp(mgr, step, meta, device)
        return cls(model, engine=engine, compaction=compaction, compact=compact,
                   device=device)

    # -- stats --------------------------------------------------------------

    @property
    def stats(self) -> Dict[str, float]:
        c = self._cache
        total = c.hits + c.misses
        return {
            "compiles": c.misses,
            "cache_hits": c.hits,
            "cache_evictions": c.evictions,
            "hit_rate": c.hits / total if total else 0.0,
            "jit_entries": sum(c.entry_sizes().values()),
        }

    def jit_entry_sizes(self) -> Dict[Tuple, int]:
        """Per (kind, bucket) count of built entries: exactly 1 after
        warm-up (shape-stable serving, no rebuild)."""
        return self._cache.entry_sizes()

    def _enter(self, op: str) -> None:
        """Fault-hook seam at the top of every served entry point."""
        idx = self._engine_calls
        self._engine_calls += 1
        if self.fault_hook is not None:
            self.fault_hook(op, idx)

    # -- MLP serving --------------------------------------------------------

    def classify(self, x: np.ndarray) -> np.ndarray:
        """Forward a request batch, padded up to the nearest batch bucket.
        Batches beyond the largest bucket are served in largest-bucket
        chunks (admission control upstream should prevent that)."""
        self._enter("classify")
        n = x.shape[0]
        cap = self.cfg.batch_buckets[-1]
        if n > cap:
            return np.concatenate(
                [self.classify(x[s : s + cap]) for s in range(0, n, cap)]
            )
        bucket = next(b for b in self.cfg.batch_buckets if b >= n)
        if n < bucket:
            x = np.concatenate([x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)])
        fn = self._cache.get(("classify", bucket), self._build_classify)
        xb = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        # .cpu() waits for the device, so the call covers the computation
        return fn(xb).cpu().numpy()[:n]

    def _build_classify(self) -> Callable[[torch.Tensor], torch.Tensor]:
        config = self.model.config

        @torch.inference_mode()
        def fn(xb: torch.Tensor) -> torch.Tensor:
            return mlp_forward(self._params, self._topo, xb, config, infer=True)

        return fn


# ---------------------------------------------------------------------------
# checkpoint glue (save at the end of training, restore in the engine)
# ---------------------------------------------------------------------------


def save_mlp_for_serving(mgr: CheckpointManager, model: SparseMLP, step: int = 0,
                         meta=None) -> None:
    """Params, element topologies and config, tagged for the engine's
    restore (``serve_kind: "mlp"``), in the reference's layout; waits for
    the write."""
    if model.config.impl != "element":
        raise NotImplementedError(f"impl={model.config.impl!r}: {_BLOCK}")
    topologies = {f"layer{l}": {"rows": t.rows, "cols": t.cols}
                  for l, t in enumerate(model.topos)}
    mgr.save(step, model.params(), topologies=topologies,
             meta={"serve_kind": "mlp", "mlp_config": dataclasses.asdict(model.config),
                   **(meta or {})})
    mgr.wait()


def _restore_mlp(mgr: CheckpointManager, step, meta, device: DeviceLike) -> SparseMLP:
    fields = dict(meta["mlp_config"])
    fields["layer_dims"] = tuple(fields["layer_dims"])
    config = SparseMLPConfig(**fields)
    dtype = getattr(torch, config.dtype)
    _, _, topo_npz, _ = mgr.restore(step)  # the topologies carry the slot counts
    topos, like_vals, like_biases = [], [], []
    for l in range(config.n_layers):
        t = topo_npz[f"layer{l}"]
        topo = ElementTopology(config.layer_dims[l], config.layer_dims[l + 1], t["rows"],
                               t["cols"])
        topos.append(topo)
        like_vals.append(torch.empty((topo.nnz,), dtype=dtype, device="meta"))
        like_biases.append(torch.empty((config.layer_dims[l + 1],), dtype=dtype, device="meta"))
    like = {"values": tuple(like_vals), "biases": tuple(like_biases)}
    params, _, _, _ = mgr.restore(step, like=like, verify=False)
    return SparseMLP.from_state(config, topos, params["values"], params["biases"],
                                device=device)
