"""Serving demo on the port's truly sparse inference engine: the twin of
``examples/serve.py``.

Saves a smoke-scale sparse-FFN LM through ``CheckpointManager``, restores it
into a ``SparseInferenceEngine`` (with ``--prune-pct``, deployment-time
block compaction: the sparse FFN importance-pruned at that percentile, the
paper's Table 6 as a serving feature) and serves a synthetic Poisson trace with
continuous batching: prompts are prefilled in one batched causal forward per
bucket, and decode advances every slot in one call per token. On the card
(the default) the sparse FFN runs kernels C and B; ``--device cpu`` runs
their plain versions. ``--full`` serves Qwen1.5-0.5B at its full width and
depth (random weights from the seed) in bfloat16, on the card.

    PYTHONPATH=src python examples/serve_torch.py --arch qwen1.5-0.5b --requests 12 [--device cpu]
    PYTHONPATH=src python examples/serve_torch.py --full --requests 16
    PYTHONPATH=src python examples/serve_torch.py --prune-pct 30 [--full] [--device cpu]

bf16 matrix products on the card are pinned to full-precision reductions
(``allow_bf16_reduced_precision_reduction = False``) here, not inside the
library.

Not yet: ``--trace`` (the obs trace, ROADMAP Queue 1, item 4) is refused.
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.importance import PruningSchedule
from repro_torch.models.transformer import PatternLM
from repro_torch.serve import (
    ContinuousBatcher,
    EngineConfig,
    SparseInferenceEngine,
    poisson_trace,
    save_lm_for_serving,
    serve_sequential,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (bf16) with the sparse FFN, on the card")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=50.0, help="req/s (Poisson)")
    ap.add_argument("--prune-pct", type=float, default=0.0,
                    help=">0: importance-prune the sparse FFN at this percentile before "
                    "serving (Table 6 as a feature)")
    ap.add_argument("--naive", action="store_true",
                    help="also run the sequential per-request baseline")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="refused: the obs trace comes with ROADMAP Queue 1, item 4")
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default, 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError("--trace: the obs trace comes with ROADMAP Queue 1, item 4")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    spec = configs.get_spec(args.arch)
    if args.full:
        cfg = dataclasses.replace(spec.config, ffn="sparse")
        ec = EngineConfig(max_slots=max(8, args.slots), max_len=256,
                          prefill_buckets=(16, 32, 64), prefill_batch=4)
        prompt_lens, new_tokens = (4, 64), (8, 32)
    else:
        cfg = dataclasses.replace(
            spec.smoke, ffn="sparse", sparse_block=16, sparse_density=0.5,
            d_ff=max(64, spec.smoke.d_ff // 2),
        )
        ec = EngineConfig(max_slots=args.slots, max_len=96, prefill_buckets=(8, 16, 32),
                          prefill_batch=min(4, args.slots))
        prompt_lens, new_tokens = (4, 32), (4, 12)
    model = PatternLM(cfg, seed=0, device="cpu")
    schedule = (PruningSchedule(tau=0, period=1, percentile=args.prune_pct)
                if args.prune_pct > 0 else None)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, async_write=False)
        save_lm_for_serving(mgr, model, step=0)
        engine = SparseInferenceEngine.from_checkpoint(ckpt_dir, engine=ec, compaction=schedule,
                                                       device=args.device)
        if engine.report:
            r = engine.report
            print(f"compaction: {r.params_before} -> {r.params_after} live FFN params "
                  f"({100 * r.shrink:.1f}% freed, {r.pruned_neurons} neurons pruned)")

        def make_trace(seed):
            return poisson_trace(args.requests, args.rate, vocab=cfg.vocab,
                                 prompt_lens=prompt_lens, new_tokens=new_tokens, seed=seed)

        # warm-up: every bucket's and decode's first use
        ContinuousBatcher(engine).run(make_trace(0))
        warm_compiles = engine.stats["compiles"]
        stats = ContinuousBatcher(engine).run(make_trace(1))
        print(f"arch={args.arch} ({'full' if args.full else 'reduced'}, sparse FFN, "
              f"{cfg.dtype}) device={engine.device} slots={ec.max_slots}")
        print(f"continuous batching: {stats.generated_tokens} tokens in "
              f"{stats.wall_seconds * 1e3:.0f} ms ({stats.throughput_tok_s:.1f} tok/s, "
              f"{stats.decode_steps} decode steps, {stats.prefill_calls} prefill calls)")
        print(f"latency p50/p95/p99: {stats.latency_p50_ms:.1f}/{stats.latency_p95_ms:.1f}/"
              f"{stats.latency_p99_ms:.1f} ms, ttft p50 {stats.ttft_p50_ms:.1f} ms, "
              f"rejected {stats.rejected}")
        post = engine.stats
        print(f"bucket cache: {post['compiles']} builds "
              f"({post['compiles'] - warm_compiles} after warm-up), "
              f"hit rate {post['hit_rate']:.2f}")

        if args.naive:
            naive_engine = SparseInferenceEngine.from_checkpoint(
                ckpt_dir, compaction=schedule,
                engine=dataclasses.replace(ec, max_slots=1, prefill_batch=1),
                device=args.device)
            serve_sequential(naive_engine, make_trace(0))  # warm-up
            nstats = serve_sequential(naive_engine, make_trace(1))
            print(f"naive sequential:    {nstats.throughput_tok_s:.1f} tok/s "
                  f"-> engine speedup {stats.throughput_tok_s / nstats.throughput_tok_s:.2f}x")
    return stats


if __name__ == "__main__":
    main()
