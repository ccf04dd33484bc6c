"""``SparseInferenceEngine`` — the truly sparse serving runtime. Twin of
``repro.serve.engine``.

Freeze the topology on the device ONCE (they never change again) and serve
behind a bounded LRU keyed by padding bucket. Two model kinds:

* ``SparseMLP`` — ``classify(x)``: the forward-only ``mlp_forward(...,
  infer=True)`` per batch bucket. An element (COO) model takes
  deployment-time compaction (``serve.compact``) and the dual-order COO
  views plus each layer's column offsets for kernel A. A block model (kernel
  C f32, then kernel B) and the masked and dense baselines (``torch.matmul``,
  then kernel B) are served as they are, with ``compact=False``: compaction
  is for element models, and asking for it raises ``ValueError``.
* ``PatternLM`` — ``prefill(prompts, slots)`` / ``decode_step(tokens, pos)``:
  prompts padded to length buckets, one batched causal forward seeds the
  slots' KV caches (no token-by-token replay), and decode runs all slots
  as one batch of rows with **per-slot positions**: each slot writes its
  own cache row at its own position and masks by it (the reference vmaps a
  batch-1 decode over the slots instead). An MoE FFN's decode dispatches
  each slot as a group of its own (``moe_groups = max_slots``), so each
  slot, idle ones included, has the capacity of the reference's batch-1
  decode and no slot takes another's; the prefill keeps the model's own
  groups, as the reference's one batched prefill forward does, so there
  the prompts of a call (and their padding) share capacity. Padded prompt
  tails land in the cache past the true length and stay masked by
  causality until the slot's own decode steps overwrite them. The caches
  are updated in place. With a ``compaction`` schedule the LM's sparse FFN
  is compacted first
  (``serve.compact.compact_block_lm``), then moved to the device, and its
  topology arrays are made from the compacted topologies. The
  sparse FFN runs kernel C in bfloat16 on the card, W_in with All-ReLU in
  its store (kernel B's bias-free bf16 arithmetic); each layer's topology
  arrays are the same tensors
  on every call (``PatternLM`` memoizes its per-layer views), so kernel C
  checks them and makes their offsets once.

LM scope, the reference's: attention patterns only (``global``/``local``),
with any FFN (gated, sparse, MoE), ``decode_window_cache`` forced off
(full-length caches and windowed masking), no prefix-LM configs.

PyTorch runs eagerly, so a bucket's entry is the forward bound to that
bucket's shape, and a bucket's first use counts as its "compile" in
``stats`` (the reference counts XLA compilations there); ``jit_entry_sizes``
counts the built entries per bucket, the reference's executable count: 1
after warm-up. The counters keep their meaning for the later per-bucket
CUDA-graph cache.

``save_mlp_for_serving``/``save_lm_for_serving`` write a model in the
reference's checkpoint layout and ``SparseInferenceEngine.from_checkpoint``
serves it (either package's), with the saved connectivity.

The three served programs (``_build_classify``, ``_build_prefill``,
``_build_decode``) take the params, topology and caches as arguments, as
the reference's jitted ones do, and the contract auditor
(``repro_torch.analysis``) audits them (:func:`analysis_programs`).

``from_checkpoint`` restores element SET-MLPs and LMs, as the reference's
does. Each call is an ``obs`` span (``serve.classify``, ``serve.prefill``,
``serve.decode_step``), closed after the result is on the host, so it
covers the device's work; a bucket's first use is a ``serve.compile``
point.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.importance import PruningSchedule
from repro_torch.core.sparsity import BlockTopology, ElementTopology
from repro_torch.device import resolve_device
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, mlp_forward
from repro_torch.models.transformer import ModelConfig, PatternLM
from repro_torch.serve.compact import CompactionReport, compact_block_lm, compact_element_mlp

__all__ = ["EngineConfig", "SparseInferenceEngine", "save_lm_for_serving",
           "save_mlp_for_serving"]

DeviceLike = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving shapes and cache policy. Buckets are the ONLY shapes the
    engine ever runs — admission clamps everything else to them."""

    max_slots: int = 8                 # concurrent decode sequences
    max_len: int = 128                 # per-slot KV capacity
    prefill_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    prefill_batch: int = 4             # prefill requests padded per call
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

    def _cache_size(self) -> int:
        """Entries built so far (rebuilds after an eviction included): the
        counter ``analysis.compilecheck`` reads, as it reads a jitted
        function's executables in the reference."""
        return self.misses

    def entry_sizes(self) -> Dict[Tuple, int]:
        # an entry is one forward built for its bucket's one input shape
        return {k: 1 for k in self._d}


class SparseInferenceEngine:
    def __init__(
        self,
        model: Union[SparseMLP, PatternLM],
        *,
        engine: EngineConfig = EngineConfig(),
        compaction: Optional[PruningSchedule] = None,
        compact: bool = True,
        device: Optional[Union[str, torch.device]] = None,
    ):
        """``device=None`` means the card; without one it raises (pass
        ``device="cpu"`` for the plain versions). An LM is moved there, after
        its compaction."""
        self.device = resolve_device(device)
        self.cfg = engine
        self.report: Optional[CompactionReport] = None
        self._cache = _BucketCache(engine.compile_cache_max)
        # chaos seam: called as fault_hook(op, call_index) at the top of every
        # served entry point, BEFORE any state mutation, so a retry of the
        # same call after a raise here is safe. ``call_index`` is monotone.
        self.fault_hook: Optional[Callable[[str, int], None]] = None
        self._engine_calls = 0
        if isinstance(model, SparseMLP):
            self.kind = "mlp"
            if compact and model.config.impl != "element":
                raise ValueError(
                    f"impl={model.config.impl!r}: deployment-time compaction is for element "
                    "models; serve this one with compact=False")
            if compact:
                model, self.report = compact_element_mlp(model, compaction)
            self.model = SparseMLP.from_state(
                model.config, model.topos, model.values, model.biases, device=self.device
            )
            self._params = self.model.params()
            # frozen once: an element model's dual-order COO views, with
            # kernel A's column offsets registered to them (which also give
            # kernel A its route, from the host's longest segment); a block
            # model's tile arrays; a masked model's masks
            self._topo = self.model.topo_arrays()
        elif isinstance(model, PatternLM):
            self.kind = "lm"
            bad = [k for k in model.cfg.pattern if k not in ("global", "local")]
            if bad:
                # as the reference's: a prefill returns no recurrent state to
                # seed a slot's decode from
                raise ValueError(f"LM engine serves attention patterns only, got {bad}")
            if model.cfg.prefix_len:
                # prefix-LM masks attend bidirectionally inside the prefix:
                # bucket padding would put pad tokens INSIDE that window, and
                # decode drops the prefix mask entirely
                raise ValueError(
                    "LM engine does not serve prefix-LM configs "
                    f"(prefix_len={model.cfg.prefix_len})")
            if model.cfg.decode_window_cache:
                # per-slot ring buffers don't survive slot-divergent
                # positions; full-length caches + windowed masking do
                model.cfg = dataclasses.replace(model.cfg, decode_window_cache=False)
            if compact and compaction is not None and model.topologies:
                self.report = compact_block_lm(model, compaction)
            self.model = model.to(self.device)
            self._params = self.model.params
            self._topo = self.model.topo_arrays()  # frozen once
            self._caches = self._init_slot_caches()
        else:
            raise TypeError(f"unsupported model {type(model)!r}: the engine serves SparseMLP "
                            "and PatternLM")

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
        """Restore the model a training run saved with ``save_mlp_for_serving``
        or ``save_lm_for_serving`` (this package's or the reference's) and
        serve it on ``device`` (``None``: the card). The manifest's
        ``serve_kind`` selects the restore path; the topology files rebuild
        the host topologies, so the served connectivity is exactly the
        trained one, not the seed's draw."""
        mgr = (directory if isinstance(directory, CheckpointManager)
               else CheckpointManager(str(directory)))
        meta = mgr.read_manifest(step).get("meta", {})
        kind = meta.get("serve_kind")
        if kind == "mlp":
            model = _restore_mlp(mgr, step, meta, device)
        elif kind == "lm":
            model = _restore_lm(mgr, step, meta, device)
        else:
            raise ValueError(
                f"checkpoint has no serve_kind meta (got {kind!r}); save it "
                "with serve.engine.save_mlp_for_serving / save_lm_for_serving"
            )
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
        if self.kind != "mlp":
            raise TypeError("classify serves an MLP engine")
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
        with obs.span("serve.classify", n=n, bucket=bucket):
            m0 = self._cache.misses
            fn = self._cache.get(("classify", bucket), self._build_classify)
            if self._cache.misses != m0:
                obs.point("serve.compile", op="classify", bucket=bucket)
            xb = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            # .cpu() waits for the device, so the span covers the computation
            return fn(self._params, self._topo, xb).cpu().numpy()[:n]

    def _build_classify(self) -> Callable:
        """The bucket's program ``fn(params, topo, xb) -> logits``: params
        and topology are served again by the next call, nothing is
        donated."""
        config = self.model.config

        @torch.inference_mode()
        def fn(params, topo, xb: torch.Tensor) -> torch.Tensor:
            return mlp_forward(params, topo, xb, config, infer=True)

        return fn

    # -- LM serving ---------------------------------------------------------

    def _init_slot_caches(self):
        """The slots' decode caches: the model's caches with one batch row
        per slot, (n_rep, max_slots, max_len, KV, D) per stacked leaf, in the
        model dtype."""
        return self.model.init_caches(self.cfg.max_slots, self.cfg.max_len,
                                      dtype=getattr(torch, self.model.cfg.dtype))

    def reset_slots(self) -> None:
        self._caches = self._init_slot_caches()

    def bucket_for(self, prompt_len: int) -> Optional[int]:
        for b in self.cfg.prefill_buckets:
            if b >= prompt_len:
                return b
        return None

    def _require_lm(self) -> None:
        if self.kind != "lm":
            raise TypeError("prefill and decode_step serve an LM engine")

    def prefill(self, prompts: Sequence[np.ndarray], slots: Sequence[int]) -> np.ndarray:
        """One batched causal forward over up to ``prefill_batch`` prompts
        (padded to a shared length bucket and to ``prefill_batch`` rows),
        seeding each slot's KV cache and returning the first generated token
        per prompt. All prompts in a call must fit the same bucket — the
        batcher groups by bucket."""
        self._require_lm()
        self._enter("prefill")
        if not 0 < len(prompts) <= self.cfg.prefill_batch or len(slots) != len(prompts):
            raise ValueError(
                f"prefill takes 1 to {self.cfg.prefill_batch} prompts and one slot each")
        lens = [int(p.shape[0]) for p in prompts]
        bucket = self.bucket_for(max(lens))
        if bucket is None:
            raise ValueError(
                f"prompt length {max(lens)} exceeds the largest prefill "
                f"bucket {self.cfg.prefill_buckets[-1]}")
        B = self.cfg.prefill_batch
        tokens = np.zeros((B, bucket), np.int64)
        for i, p in enumerate(prompts):
            tokens[i, : lens[i]] = p
        lens_arr = np.ones((B,), np.int64)
        lens_arr[: len(prompts)] = lens
        with obs.span("serve.prefill", n=len(prompts), bucket=bucket):
            m0 = self._cache.misses
            fn = self._cache.get(("prefill", bucket), lambda: self._build_prefill(bucket))
            if self._cache.misses != m0:
                obs.point("serve.compile", op="prefill", bucket=bucket)
            next_tok, self._caches = fn(
                self._params, self._topo, self._caches,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(lens_arr, device=self.device),
                torch.as_tensor(np.asarray(slots, np.int64), device=self.device))
            # .cpu() waits for the device, so the span covers the computation
            return next_tok[: len(prompts)].cpu().numpy().astype(np.int32)

    def _build_prefill(self, bucket: int) -> Callable:
        """The bucket's program ``fn(params, topo, caches, tokens, lens,
        slots) -> (next_tok, caches)``: the slots' rows are written into the
        caller's caches (position 2) in place on every device, and the same
        caches come back."""
        model = self.model

        @torch.inference_mode()
        def fn(params, topo, caches, tokens: torch.Tensor, lens: torch.Tensor,
               slots: torch.Tensor):
            h, pre, _ = model.forward(params, tokens, topo=topo, mode="prefill",
                                      return_hidden=True)
            # the logits of each row's last prompt position only
            last = h[torch.arange(h.shape[0], device=h.device), lens - 1]
            next_tok = torch.argmax(model.logits(params, last), dim=-1)
            # seed the real rows' slots (the padded rows have none: the
            # reference sends them to slot max_slots and drops them)
            n = slots.shape[0]
            for slot, c in pre["stack"].items():
                for name, p in c.items():          # p: (n_rep, B, bucket, KV, D)
                    caches["stack"][slot][name][:, slots, :bucket] = p[:, :n]
            for big, c in zip(caches["rest"], pre["rest"]):
                for name, p in c.items():          # p: (B, bucket, KV, D)
                    big[name][slots, :bucket] = p[:n]
            return next_tok, caches

        return fn

    def decode_step(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step for ALL slots (shape-stable: inactive slots run
        too and are ignored host-side). ``tokens``/``pos`` are (max_slots,);
        each slot attends its own causal prefix at its own position."""
        self._require_lm()
        self._enter("decode")
        with obs.span("serve.decode_step"):
            m0 = self._cache.misses
            fn = self._cache.get(("decode",), self._build_decode)
            if self._cache.misses != m0:
                obs.point("serve.compile", op="decode")
            next_tok, self._caches = fn(
                self._params, self._topo, self._caches,
                torch.as_tensor(np.asarray(tokens, np.int64), device=self.device),
                torch.as_tensor(np.asarray(pos, np.int64), device=self.device))
            # .cpu() waits for the device, so the span covers the computation
            return next_tok.cpu().numpy().astype(np.int32)

    def _step_logits(self, params, topo, caches, tokens: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """The all-slots step's logits (max_slots, vocab), the caches written
        in place: each slot's token at its own position, and an MoE FFN
        dispatched in one group a slot (the reference's vmapped batch-1
        decode)."""
        logits, _, _ = self.model.forward(params, tokens[:, None], topo=topo,
                                          positions=pos[:, None], mode="decode",
                                          caches=caches, moe_groups=self.cfg.max_slots)
        return logits[:, -1]

    def _build_decode(self) -> Callable:
        """The all-slots step ``fn(params, topo, caches, tokens, pos) ->
        (next_tok, caches)``, the caches updated in place as in
        :meth:`_build_prefill`."""
        step_logits = self._step_logits

        @torch.inference_mode()
        def fn(params, topo, caches, tokens: torch.Tensor, pos: torch.Tensor):
            return torch.argmax(step_logits(params, topo, caches, tokens, pos), dim=-1), caches

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
        raise ValueError(f"impl={model.config.impl!r}: save_mlp_for_serving writes element "
                         "models, whose restore is the reference's")
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


def save_lm_for_serving(mgr: CheckpointManager, model: PatternLM, step: int = 0,
                        meta=None) -> None:
    """``PatternLM`` params, per-repeat block topologies, config and init
    seed, tagged for the engine's restore (``serve_kind: "lm"``), in the
    reference's layout; waits for the write."""
    topologies = {}
    for slot, topo_list in model.topologies.items():
        for r, (t_in, t_out) in enumerate(topo_list):
            topologies[f"{slot}__r{r}"] = {
                "rows_in": t_in.rows, "cols_in": t_in.cols,
                "rows_out": t_out.rows, "cols_out": t_out.cols,
            }
    mgr.save(step, model.params, topologies=topologies,
             meta={"serve_kind": "lm", "model_config": dataclasses.asdict(model.cfg),
                   "seed": model._seed, **(meta or {})})
    mgr.wait()


def _restore_lm(mgr: CheckpointManager, step, meta, device: DeviceLike) -> PatternLM:
    fields = dict(meta["model_config"])
    fields["pattern"] = tuple(fields["pattern"])
    # the same config and seed rebuild the same tree (leaf shapes come from
    # the files, so evolved topologies of the same capacity restore exactly);
    # then the saved topologies replace the seed's draw
    model = PatternLM(ModelConfig(**fields), seed=int(meta.get("seed", 0)), device=device)
    params, _, topo_npz, _ = mgr.restore(step, like=model.params, device=model.device)
    model.params = params
    for slot, topo_list in model.topologies.items():
        new_list = []
        for r, (t_in, t_out) in enumerate(topo_list):
            t = topo_npz[f"{slot}__r{r}"]
            new_list.append((BlockTopology(t_in.meta, t["rows_in"], t["cols_in"]),
                             BlockTopology(t_out.meta, t["rows_out"], t["cols_out"])))
        model.topologies[slot] = new_list
    return model


# ---------------------------------------------------------------------------
# contract auditor registration (repro_torch.analysis, DESIGN.md §10)
# ---------------------------------------------------------------------------


def analysis_programs():
    """Registry hook: the three served entry points, built at the
    reference's smoke scale with its contracts, field for field. The
    reference's classify contract bounds the scatter formulation its CPU
    dispatch picks at this scale; the port serves every size through
    kernel A's sorted segment sum (its plain version on the CPU), and the
    KV-cache slot inserts are plain index writes, so the port's record holds
    fewer scatters than the bounds allow."""
    from repro_torch import configs
    from repro_torch.analysis.registry import AuditProgram, Contract, ProgramSpec

    mlp_dims = (32, 24, 20, 6)
    bucket = 8

    def build_classify(device=None) -> AuditProgram:
        cfg = SparseMLPConfig(layer_dims=mlp_dims, epsilon=6, impl="element", dropout=0.0)
        eng = SparseInferenceEngine(SparseMLP(cfg, seed=0, device=device), device=device)
        args = (
            eng._params, eng._topo,
            torch.zeros((bucket, mlp_dims[0]), dtype=torch.float32, device=eng.device),
        )
        return AuditProgram(
            make=lambda donate: eng._build_classify(),
            args=args,
            meta={"dims": mlp_dims, "bucket": bucket},
        )

    def _lm_engine(device):
        lm_cfg = dataclasses.replace(
            configs.get_spec("qwen1.5-0.5b").smoke,
            ffn="sparse", sparse_block=16, sparse_density=0.5, d_ff=64,
        )
        return SparseInferenceEngine(
            PatternLM(lm_cfg, seed=0, device=device),
            engine=EngineConfig(
                max_slots=2, max_len=16, prefill_buckets=(8,),
                prefill_batch=2, batch_buckets=(1, 8),
            ),
            device=device,
        )

    def build_prefill(device=None) -> AuditProgram:
        eng = _lm_engine(device)
        B, bkt = eng.cfg.prefill_batch, eng.cfg.prefill_buckets[0]
        dev = eng.device
        args = (
            eng._params, eng._topo, eng._caches,
            torch.zeros((B, bkt), dtype=torch.int64, device=dev),
            torch.ones((B,), dtype=torch.int64, device=dev),
            torch.zeros((B,), dtype=torch.int64, device=dev),
        )
        return AuditProgram(
            make=lambda donate: eng._build_prefill(bkt),
            args=args,
            meta={"prefill_batch": B, "bucket": bkt, "slots": eng.cfg.max_slots},
        )

    def build_decode(device=None) -> AuditProgram:
        eng = _lm_engine(device)
        S = eng.cfg.max_slots
        dev = eng.device
        args = (
            eng._params, eng._topo, eng._caches,
            torch.zeros((S,), dtype=torch.int64, device=dev),
            torch.zeros((S,), dtype=torch.int64, device=dev),
        )
        return AuditProgram(
            make=lambda donate: eng._build_decode(),
            args=args,
            meta={"slots": S, "max_len": eng.cfg.max_len},
        )

    return [
        ProgramSpec(
            name="serve.classify",
            subsystem=__name__,
            contract=Contract(
                # the reference's bound: one output-sized scatter-add per
                # layer at sub-threshold serving scale
                max_unsorted_scatter=len(mlp_dims) - 1,
                max_unsorted_scatter_elems=bucket * max(mlp_dims),
                max_intermediate_elems=64 * 1024,
                max_temp_bytes=1024 * 1024,
                expected_compiles=1,
            ),
            build=build_classify,
            notes="forward-only MLP classify; params reused, no donation",
            kernels=("coo_matmul_T.epilogue",),
        ),
        ProgramSpec(
            name="serve.prefill",
            subsystem=__name__,
            contract=Contract(
                # KV slot inserts: one scatter per cache leaf, cache-sized
                max_unsorted_scatter=16,
                max_unsorted_scatter_elems=512 * 1024,
                max_intermediate_elems=1024 * 1024,
                donate_argnums=(2,),
                max_temp_bytes=16 * 1024 * 1024,
                expected_compiles=1,
            ),
            build=build_prefill,
            notes="batched causal prefill seeding slot caches (donated)",
            kernels=("bsmm_fwd",),
        ),
        ProgramSpec(
            name="serve.decode",
            subsystem=__name__,
            contract=Contract(
                max_unsorted_scatter=16,
                max_unsorted_scatter_elems=512 * 1024,
                max_intermediate_elems=1024 * 1024,
                donate_argnums=(2,),
                max_temp_bytes=16 * 1024 * 1024,
                expected_compiles=1,
            ),
            build=build_decode,
            notes="all-slots decode step, caches donated",
            kernels=("bsmm_fwd",),
        ),
    ]
