#!/usr/bin/env python3
"""Drive the port's SET-MLP serving and training paths (block, element and
out-of-core, and the paper's masked and dense baselines), its bf16
language model's serving (also compacted at deployment) and training paths,
the RG-LRU, Mamba-1 and MoE models of its architecture zoo, Whisper-medium
and the observability layer on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each (any failure exits non-zero):

1. device        — the card's name, count, and nvidia-smi's name and power
                   limit;
2. build         — every kernel built from ``src/repro_torch/csrc``, one
                   ``nvcc`` per source, all started together;
3. kernels       — kernels A and B against their plain PyTorch versions on
                   the card, at the full-width SET-MLP's shapes and at the
                   compacted shapes the engine serves, at batch 1, 5, 33
                   and 128; kernel A's epilogue (bias, then All-ReLU of
                   either slope sign, or the bias alone) on both routes,
                   with and without a carry-in, held bit-equal to kernel A
                   followed by kernel B (or ``+ bias``); kernel B on
                   contiguous rows (16-byte and scalar paths) and on rows at
                   a pitch (a padded product's column slice); at the served
                   output layer (10 segments of 2,800 slots), kernel A's two
                   routes held bit-equal, and dropping a third of its slots
                   after zeroing their values held bit-equal;
4. block_kernels — kernels C, D and E against their plain versions at the
                   four layers of the full-width block model (batch 128 and
                   a ragged 100), at 8x8 and 32x16 tiles, on skewed
                   block-columns (one column holding every slot; columns of
                   1, 2, 7 and 33 slots; 128x128 and 5x5 tiles) and, for D,
                   skewed block-rows (the same counts); uncovered dx
                   block-rows and empty block-columns held exactly 0; C, D
                   and E launched twice more on the same inputs, held
                   bit-equal;
5. element_kernels — the element training path's kernels against their
                   plain versions at the four full-width element layers, batch
                   128, a ragged 33 and WASAP's 32, at rtol 1e-4 / atol 1e-5, each
                   launched twice more on the same inputs and held bit-equal:
                   kernel A's dX use (the row-sorted dual order), kernel F
                   (coo_dw) in its three epilogue modes (none; the bias's
                   gradient; All-ReLU's backward with the mask, both slope
                   signs: kernel G's work, dz bit-equal to the plain
                   version), also with a third of the columns emptied, G's
                   standalone call (all_relu_bwd: F's epilogue alone) with
                   and without a mask, and kernel A's training epilogue (its
                   output bit-equal to the All-ReLU epilogue's, its mask to
                   where the bias epilogue's output is > 0), with some
                   pre-activations exactly 0;
6. main          — the serving path: ``SparseInferenceEngine.classify`` at
                   full width (3072-4000-1000-4000-10, epsilon 20) with
                   deployment-time compaction, against the same model served
                   on the CPU, and its launch counts: one kernel A a layer,
                   each with its epilogue, and no standalone kernel B;
7. train         — the block training path: ``SequentialTrainer.run`` of the
                   full-width block model (128x128 tiles) for 3 epochs with
                   host SET and importance pruning, against the same run on the
                   CPU through the plain versions (topology and n_params
                   equal after every epoch, loss and accuracy within
                   tolerance), kernels C, D and E's launch counts and
                   kernel B's in the evaluations, and a run at the paper's
                   dropout whose loss must fall;
8. element_train — the paper's element training path: ``SequentialTrainer.
                   run`` of the full-width element model for 3 epochs with
                   host SET and importance pruning (the element cascade), the
                   block run's settings, against the same run on the CPU
                   (topology and n_params equal after every epoch, loss and
                   accuracy within tolerance), the launches of kernels A
                   (forward, dX) and F (each with its epilogue, G's work)
                   per step and no standalone G, and a run at the paper's
                   dropout whose loss must fall;
9. evolution     — device SET (``core.topology.evolve_element_layers_device``,
                   ``evolve_block_layers_device``) of the full-width element
                   and block models, seeded values and momentum, all four
                   layers each under ``set_sync_debug_mode("error")``: equal
                   slot for slot (rows, cols, values, momentum, pruned count)
                   to the numpy version fed the card's draws (block scores
                   within rtol 1e-6, the drop decision held on the card's
                   scores); the invariants of tests/test_device_evolution.py;
                   the device-made offsets equal to ``col_ptr()``/
                   ``row_ptr()`` and F's device plan, padding stripped, to
                   ``dw_runs``; kernels A (forward with the mask, dX; both
                   routes) and F (modes 0-2) on the device-made arrays
                   bit-equal to host-made arrays of the same topology; and
                   per layer the evolution's device time, device launches
                   and host time (``evolution_cost`` lines);
10. element_train_device_evolution, block_train_device_evolution — the 3-epoch
                   runs of phases 8 and 7 with ``device_evolution=True`` (the
                   default), every evolution under ``set_sync_debug_mode(
                   "error")``: the same launch counts, a finite loss, the
                   synced host mirror's invariants after every epoch (an
                   element model's ``n_params`` its count), ``n_params``
                   equal to the host-SET run's after epoch 0 (pruning then
                   acts on other topologies), and ``epoch_seconds`` and the
                   topology phase's seconds beside the host-SET run's;
11. timings       — classify latency per bucket, where a classify's device
                   time goes (kernels, copies and transposes, launches),
                   and per-kernel device time for A and B (CUDA events)
                   beside bound, plain version and one PyTorch library call
                   (A also with its other route's time and with its
                   epilogue; B as the epilogue's cost in A and as its
                   standalone pass);
12. train_timings — the block and the element training step's time, allocator peak and
                   device idle share, the epochs' seconds, and per-kernel rows
                   for C, D and E (C and E also with ``bound_tc_ms``, their
                   bound at the 3xTF32 tensor-core rate) and for kernel A's
                   dX use, F (with and without its epilogue) and G (as the
                   epilogue's cost in F and as its standalone call);
13. baselines     — the paper's baselines, the full-width CIFAR-10 model
                   (3072-4000-1000-4000-10, f32, seed 0) as the masked
                   (``h @ (W * mask)``, the element model's ER mask) and the
                   dense SET-MLP: their forward on the card (served and
                   evaluation) against the CPU's plain forward within 1e-5;
                   the ``train`` phase's 3-epoch run (SET and pruning
                   scheduled, which these impls skip) with ``n_params``
                   390,450 and 20,337,010 every epoch, the mask unmoved, the
                   loss falling, the history against the same run on the CPU,
                   and only kernel B launched (the evaluations' hidden
                   layers); a step's median of 30 with quartiles, device busy,
                   idle share, launches and the allocator's peak beside the
                   element and block steps of the ``train_timings`` phase; a
                   served ``classify`` at buckets 1, 8, 32 and 128 (3 B
                   launches a call) beside the element engine's, compacted
                   and not, and the block model's, served as it is (4 C f32
                   and 3 B a call, against the CPU engine within 1e-4) (a
                   ``baselines`` line);
14. lm            — serving the paper's sparse-FFN language model:
                   Qwen1.5-0.5B at full width and depth (24 layers, d_model
                   1024, vocab 151,936) with the SET sparse FFN (128 x 128
                   tiles, epsilon 64, All-ReLU alpha 0.6) in bf16, random
                   weights from the seed. Kernel C's bf16 instance against its
                   plain version (1e-2) and ``ref.bsmm_ref`` (5e-2) on the
                   reference's kernel sweep and the full-width W_in (22 tiles)
                   and W_out (15 tiles) at 1 row and the main path's 8, 64,
                   128 and 256, the same bits on three launches on the route
                   ``fwd_plan`` gives (decode up to 16 rows, rows above,
                   tiled for the sweep; its counters show the route and no
                   second pass on the served shapes); its All-ReLU store
                   bit-equal to C then kernel B, both parities; a decode-route
                   row the same alone as within the call; kernel B's bf16
                   entry bit-equal to its plain version at the main path's
                   rows, both parities, with and without a bias; the model
                   with depth cut to 2 layers on the card against the CPU run
                   (plain versions; 4 bucket-16 prompts, 4 decode steps), and
                   at full depth decode against the teacher-forced forward (2
                   prompts, 8 steps), logits within 0.1 + 5e-2 x |want| and
                   the argmax held where the top-2 margin exceeds 0.1;
                   ``SparseInferenceEngine`` (8 slots, 256 positions, buckets
                   16/32/64, 4 prompts a prefill) launching 48 C (24 with
                   All-ReLU in the store, all on the decode route for a step
                   and the rows route for a prefill) and no B a call; the
                   main path, a ``ContinuousBatcher`` over 16 Poisson requests
                   (prompts of 4-64 tokens, 8-32 new) after a warm-up trace:
                   every request completed with its budget, no build after
                   warm-up, C launched 48 times a call and B never, the same
                   tokens as ``serve_sequential`` on the same engine;
                   ``kernel_timing`` rows for C bf16 (W_in, W_out at 1, 8, 64,
                   128 and 256 rows, without and with All-ReLU, the tiled
                   route's earlier time beside; bound at the bf16 tensor
                   rate, 989 TFLOP/s; library ``torch.matmul`` against the
                   densified W) and for B bf16
                   (library ``torch.where``), and an ``lm_timing`` line:
                   prefill per bucket, the decode step (median, quartiles,
                   device busy time, idle share and launches from
                   ``torch.profiler``), the host time of one ``bsmm_infer``
                   and of the autograd path it replaced, the batcher's
                   tokens/s, latency and TTFT, the allocator's peak, the
                   card's name and power limit;
15. lm_compact    — the same LM compacted at deployment by the engine
                   (``serve.compact.compact_block_lm``): (a) one W_out block
                   zeroed in every layer (a second in odd layers), freed at
                   threshold 0 (nothing pruned): W_out 15 -> 14 blocks, the
                   odd layers re-padded with a zero block at a freed
                   position, the prefill and decode logits bit-equal to the
                   uncompacted model's, kernel C bf16 on every layer's
                   re-padded W_out held as in ``lm``; (b) compacted at the
                   30th percentile (the element serving cell's): the report
                   and every slot's block counts before and after (an
                   ``lm_compaction`` line); (c) on (b)'s model, kernel C bf16
                   with and without its All-ReLU store on every layer at the
                   main path's rows, and the ``lm`` phase's main path (16
                   Poisson requests at 20/s, 48 C a call, no B, sequential
                   tokens equal): an ``lm_compact_timing`` line with
                   tokens/s, latency, TTFT, the decode step's profile and one
                   ``bsmm_infer``'s host time;
16. lm_train      — training the same model (full width and depth, bf16,
                   ``remat="block"``) through ``examples/train_lm_torch.py``'s
                   loop, the twin of the reference's LM training example: 4
                   steps of 8 x 257 tokens of its Zipf stream
                   (``make_train_step``: lr 1e-2, momentum 0.9), host SET
                   (zeta 0.3) after steps 2 and 4, a checkpoint at the end;
                   every loss finite; each step launching kernel C bf16 96
                   times (48 forward, 48 in remat's recompute, all on the rows
                   route) and kernels D and E bf16 48 times each (E with its
                   second pass), nothing else, by the wrappers' counters.
                   Kernels D and E bf16 against their plain versions (1e-2 +
                   1e-2 x |want|) on every layer's W_in and W_out topology at
                   2,048 rows, before and after SET, and on W_in's grid with
                   columns of 4, 5 and 8 slots (block-rows of up to 22 slots),
                   the same bits on three launches, dx's uncovered block-rows
                   exactly 0; one full-depth step's gradients against the same
                   step with the sparse FFN on ``bsmm_xla`` (relative L2 per
                   leaf within 5e-2); ``kernel_timing`` rows for D and E bf16
                   on the first layer at 2,048 rows (bound at the bf16 rate;
                   library ``torch.matmul`` against the densified W^T for D,
                   ``torch.bmm`` on the gathered tiles for E) and an
                   ``lm_train_timing`` line: the step's median and quartiles,
                   device busy, idle share, launches, the kernels and host
                   operators with the most time, the allocator's peak, the
                   card's name and power limit;
17. lm_archs      — the rest of the zoo at full width, bf16, random weights
                   from the seed (each model's parameter count and the host
                   seconds of drawing it printed): (a) recurrentgemma-2b at
                   full depth (26 layers, rglru/rglru/local) with the sparse
                   FFN (W_in 60 tiles on 20 x 60, W_out 40 on 60 x 20): E
                   bf16's runs legal on both grids (``lm_archs_splits``);
                   kernels C (with and without its All-ReLU store), D and E
                   bf16 against their plain versions on every layer at 8 and
                   2,048 rows, before and after a host SET; the main path,
                   3 steps of the example's loop (8 x 257 tokens, host SET
                   after the third), every loss finite, each step launching
                   100 C (the 2 remainder layers run without remat), 52 D and
                   52 E bf16 and nothing else; one step's gradients against
                   ``bsmm_xla``'s (5e-2 a leaf); decode from ``init_caches``
                   (RG-LRU and conv states, the local ring) against the
                   teacher-forced forward over 8 x 64 tokens (0.1 + 5e-2 x
                   |want|), 52 C a step (26 with the store, decode route),
                   no B; ``kernel_timing`` rows for C, D and E bf16 on the
                   first layer at 8 and 2,048 rows and their ``kernels``-line
                   entries; (b) falcon-mamba-7b at full depth (64 layers):
                   decode against the forward held through the f32 twin of
                   the same weights, no kernel launched; its train step at
                   full width on 2 layers in f32, card against CPU (logits
                   1e-4, gradients 1e-4 relative L2 a leaf); (c)
                   qwen3-moe-30b-a3b cut to 4 layers: the dispatch
                   invariants, the combine against a loop over each token's
                   kept experts and bit-equal twice; a forward, a train step
                   whose total carries the auxiliary loss, decode steps. An
                   ``lm_archs_timing`` line each: forward tokens/s, a decode
                   step's median, busy, idle share and launches, the train
                   step's median, the allocator's peak, the draw's seconds,
                   the card's name and power limit;
18. whisper       — Whisper-medium (``models/whisper.py``) at full width and
                   depth, bf16, 792,024,064 parameters drawn on the card from
                   the seed: 3 steps of ``launch.steps.make_train_step`` at
                   batch 4 (1,500 seeded frame embeddings, 448 tokens of the
                   LM example's Zipf stream), finite losses, no kernel of the
                   port launched (its FFN is the plain GELU MLP: the path is
                   dense); the model cut to 2 + 2 layers in f32 on 1 x 64
                   frames and 16 tokens, card vs CPU: logits at rtol 1e-4,
                   each gradient leaf at 1e-4 relative L2, the cross
                   attention's bias gradients exact zeros; 8 x 1,500 frames
                   encoded, 64 tokens decoded one at a time from position 0
                   (``make_decode_step``, ``init_caches(8, 448)``) against
                   the teacher-forced logits of ``decode_train``
                   (``logits_close``), and ``make_prefill_step`` on the
                   first 32 tokens against them at position 31. A
                   ``whisper_timing`` line: the train step's median, the
                   encode's, a decode step's median with device busy, idle
                   share and launches (``torch.profiler``), the allocator's
                   peak, the draw's seconds, the card's name and power limit;
19. obs           — the observability layer (``repro_torch.obs``): (a) the
                   full-width element model, the element_train phase's data
                   and settings with device SET, 3 epochs with
                   ``TrainerConfig(probe=True)`` under ``obs.trace_to`` and
                   ``timeline.timeline_to`` with an ``AnomalyMonitor``: both
                   files valid, the reference's span taxonomy, every
                   snapshot's layer stats against numpy over the tensors the
                   probe read, no alert, the seeded dead layer
                   (``zero_layer_transform(1)``) caught on layer 1, the run
                   bit-equal to the unprobed one under ``obs.disabled()``
                   (history, topologies, weights), the unprobed run's
                   launches ``element_launches`` and the probed run's those
                   plus one probe an epoch (A 7, 4 of them with the bias
                   epilogue, B 3, F 4, G 3), ``python -m repro_torch.obs
                   report`` rendering the timeline; (b) a classify burst at
                   buckets 1 and 128 on a fresh engine: a ``serve.classify``
                   span a call, a ``serve.compile`` point a new bucket; (c)
                   the LM example's loop at full width (Qwen1.5-0.5B, bf16)
                   for 2 steps with host SET after each, with its probe,
                   trace and timeline: both files valid, the sparse FFN's
                   stats finite, C, D and E bf16 launched a step as in
                   lm_train; (d) ``sample_device_memory`` equal to the
                   allocator's figures, ``profile_trace`` writing a Chrome
                   trace that holds kernel A's launches; and the overhead:
                   (a)'s run 5 times each, interleaved, disabled, traced,
                   and traced + probed, in an ``obs_timing`` line with the
                   card's name and power limit (the reference's budget,
                   < 2 %, is reported, not enforced);
20. wasap         — WASAP-SGD (paper Algorithm 1) of the full-width element
                   model at dropout 0: 4 workers, batch 32, H = 4, 2 phase-1
                   and 1 phase-2 epochs on 1,000 samples (7 steps a
                   worker-epoch: 2 rounds, the second with a padded step). The
                   round loop (host SET) against the same run on the CPU, and
                   the fused run (device SET, every evolution under
                   ``set_sync_debug_mode("error")``) against a CPU fused run
                   fed the card's draws: every evolution's topology (the
                   master's after each phase-1 epoch, each worker's after
                   phase 2), the merged topology and the ``n_params`` history
                   equal, loss and accuracy within tolerance; every step of
                   every worker, padded ones too, launching A and F
                   (``element_launches``); a WASSP run (H = 1) that keeps its
                   connection count; the async parameter server (3 worker
                   threads on the card, 1 epoch: every update applied, the
                   model finite); ``wasap_history`` (every run's history and
                   epoch seconds by phase) and ``wasap_epoch_profile`` (a
                   phase-1 epoch's device busy time, launches and idle share).
                   It runs after the timing phases: before them it made
                   their profiler sessions lose device events.
21. checkpoint    — checkpoints and resume (``repro_torch.checkpoint``) at
                   full width on the card: the element and the block model
                   trained 3 epochs with device SET, pruning and the paper's
                   dropout 0.3, saved at every epoch; a fresh trainer
                   restored from the epoch-0 checkpoint runs on to the same
                   history, values, biases and topologies, bit for bit, on
                   kernels A and F (element) or C, D and E (block), their
                   launches counted; WASAP (the ``wasap`` phase's
                   configuration with 2 phase-2 epochs) resumed at a phase-1
                   and at a phase-2 boundary, bit-equal; the seeded serving
                   model saved with ``save_mlp_for_serving`` and served by
                   ``SparseInferenceEngine.from_checkpoint`` on the card at
                   phase ``main``'s sizes, bit-equal to the live engine, on
                   kernel A, one signature per bucket, and served on the CPU
                   from the same checkpoint within rtol 1e-5; a
                   ``checkpoint_io`` line: bytes on disk, save (snapshot and
                   write) and restore seconds of the element and block
                   checkpoints, with the card's name and power limit. It
                   profiles nothing;
22. xl            — out-of-core training (``repro_torch.xl``, ``XLTrainer``)
                   of the paper's first Table-4 row at full width,
                   65536-500000-500000-2 (epsilon 10, All-ReLU alpha 0.5,
                   17,655,362 parameters), batch 32, the device budget 0.6 x
                   the in-core bytes, on 512 synthetic extreme-scale samples:
                   the plan (an ``xl_plan`` line) equal to the reference
                   planner's numbers for these inputs; one batch's streamed
                   logits and one streamed step (values, velocity, biases,
                   loss) bit-equal to the in-core element forward and step
                   (kernel A with its fused epilogue, F with G's); 2 epochs
                   streamed (the main path: A, B, F and G launched exactly
                   as the plan's shards say, by the wrappers' counters)
                   against the in-core trainer (loss within rtol 1e-6, test
                   accuracy and n_params equal); the allocator's peak over
                   each run (``xl_memory``: the streamed one within the
                   budget plus the port's extra buffers, and below the
                   in-core one); 2 epochs with shard-wise SET, where after
                   the evolution the invariants hold and the next streamed
                   step is bit-equal to an in-core step on the evolved
                   topology, and the run resumed from its epoch-0 streamed
                   checkpoint is bit-equal to the one that never stopped;
                   K8 (``xl_shard_acc``, ``xl_shard_dw``) on every shard of
                   layer 1 against its plain versions, chained bit-equal to
                   kernels A and F over the whole layer, writing nothing
                   outside a shard's window; kernel B's (features, batch)
                   pass and G's standalone call at (500000, 32) against
                   theirs; ``kernel_timing`` rows for the four, and an
                   ``xl_timing`` line: the streamed step's median and
                   quartiles, its host split (gather, copy issue, waits,
                   host update), device busy, the H2D copies' device time,
                   idle share, bytes each way per step, the in-core step,
                   the evolution's, invariants' and checkpoint's seconds,
                   with the card's name and power limit. It runs last.

Then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Without a card it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.configs.set_mlp import mlp_config  # noqa: E402
from repro_torch.core import sparsity, topology, wasap  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.data.datasets import load, make_extreme_dataset  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.core.all_relu import activation_fn  # noqa: E402
from repro_torch.core.topology import block_device_arrays  # noqa: E402
from repro_torch.core.wasap import WASAPConfig, WASAPTrainer  # noqa: E402
from repro_torch.core.wasap_ps import AsyncParameterServer, AsyncPSConfig  # noqa: E402
from repro_torch.kernels import all_relu_fused, build, ops, ref  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as bsm  # noqa: E402
from repro_torch.launch.steps import make_mlp_train_step  # noqa: E402
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig, block_meta, mlp_forward  # noqa: E402
from repro_torch.models.transformer import ModelConfig, PatternLM  # noqa: E402
from repro_torch.optim.sgd import MomentumSGD, SGDState  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    EngineConfig,
    SparseInferenceEngine,
    importance_prune_mlp,
    poisson_trace,
    save_mlp_for_serving,
    serve_sequential,
)
from repro_torch.train.trainer import (  # noqa: E402
    SequentialTrainer,
    TrainerConfig,
    XLTrainer,
    evaluate,
)
from repro_torch import xl  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32
# (non-tensor-core) rate and dense TF32 tensor-core rate. The bound of a call
# is the larger of its bytes over the first and its operations over the
# second; kernels C and E, which run f32-accurate products as 3xTF32 on the
# tensor cores, also get the larger of the bytes' time and three times their
# operations over the third (``bound_tc_ms``).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_TC_FLOPS_PER_S = 495e12
RTOL = ATOL = 1e-5  # kernel A sums in another order than index_add_
SIZES = (1, 5, 32, 128, 300)  # 300 is above the largest bucket: chunked
EPILOGUE_BATCHES = (1, 5, 33, 128)  # kernel A's epilogue: 4-byte and 16-byte staging, ragged
SCHEDULE = PruningSchedule(tau=0, period=1, percentile=30.0)
SEED = 0
REPS = 100
CARD = torch.device("cuda")  # where the block phases run

KERNEL_A = dict(
    name="coo_matmul_T", route="cuda", source="src/repro_torch/csrc/coo_matmul_T.cu",
    replaces="src/repro/core/sparsity.py:477",
)
KERNEL_B = dict(
    name="bias_all_relu", route="cuda", source="src/repro_torch/csrc/bias_all_relu.cu",
    replaces="src/repro/kernels/all_relu_fused.py:23",
)
KERNEL_C = dict(
    name="bsmm_fwd", route="cuda", source="src/repro_torch/csrc/bsmm_fwd.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:64",
)
KERNEL_D = dict(
    name="bsmm_dx", route="cuda", source="src/repro_torch/csrc/bsmm_dx.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:127",
)
KERNEL_E = dict(
    name="bsmm_dw", route="cuda", source="src/repro_torch/csrc/bsmm_dw.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:186",
)
# the element training path: kernel A's dX use (the reference's backward
# calls sparsity.py:477 over the dual order at ops.py:223), F, and G (what
# XLA derives for All-ReLU's jnp.where), which runs in F's epilogue
KERNEL_A_DX = dict(
    name="coo_matmul_T.dX", route="cuda", source="src/repro_torch/csrc/coo_matmul_T.cu",
    replaces="src/repro/kernels/ops.py:223",
)
KERNEL_F = dict(
    name="coo_dw", route="cuda", source="src/repro_torch/csrc/coo_dw.cu",
    replaces="src/repro/core/sparsity.py:544",
)
KERNEL_G = dict(
    name="all_relu_bwd", route="cuda", source="src/repro_torch/csrc/coo_dw.cu",
    replaces="src/repro/core/all_relu.py:21",
)
WRAPPERS = {
    "coo_matmul_T": sparsity.coo_matmul_T, "bias_all_relu": all_relu_fused.bias_all_relu,
    "bsmm_fwd": bsm.bsmm_fwd, "bsmm_dx": bsm.bsmm_dx, "bsmm_dw": bsm.bsmm_dw,
    "coo_dw": sparsity.coo_dw, "all_relu_bwd": all_relu_fused.all_relu_bwd,
    "xl_shard_acc": ops.xl_shard_acc, "xl_shard_dw": ops.xl_shard_dw,
}
# The element training path's batches: the trainer's 128, a ragged 33, and
# WASAP's 32
ELEMENT_BATCHES = (128, 33, 32)
# The element gradients' tolerance, the reference's (tests/test_espmm_grad.py):
# kernels A (dX), F and G sum in other orders than the plain versions.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# Kernels C, D and E sum up to K = 4096 products per output in another order
# than the plain versions' einsums (C and E in 3xTF32, as accurate as f32;
# one TF32 pass would miss this tolerance ~10x, tests/test_torch_tf32.py).
BLOCK_RTOL = BLOCK_ATOL = 1e-4
# The training run: 1,000 training samples (7 steps of 128 an epoch), 200 test.
TRAIN_SCALE = 0.02
TRAIN_EPOCHS = 3
# Card run vs CPU run of the same 3 epochs: per-epoch mean loss within
# TRAIN_LOSS_RTOL (the kernels' sums differ from the plain versions' in the
# last bits, and 21 SGD steps carry that forward); test accuracy within one
# of the 200 test samples.
TRAIN_LOSS_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


# kernels A's and F's counts of launches with an epilogue, and with a mask
SUB_COUNTS = {f"{name}.{sub}": (WRAPPERS[name], f"{sub}_launches")
              for name in ("coo_matmul_T", "coo_dw") for sub in ("epilogue", "mask")}
# kernel B's launches by its (features, batch) entry (the out-of-core stream)
SUB_COUNTS["bias_all_relu.T"] = (all_relu_fused.bias_all_relu, "T_launches")
# kernels D's and E's launches of their bf16 instances (the LM's training step)
SUB_COUNTS.update({f"{name}.bf16": (WRAPPERS[name], "bf16_launches")
                   for name in ("bsmm_dx", "bsmm_dw")})


def reset_counts() -> None:
    """Set every kernel's launch count to 0, kernels A's and F's epilogue
    and mask counts, kernel C's sub-counts and D's and E's too."""
    for fn in WRAPPERS.values():
        fn.launches = 0
    for fn, attr in SUB_COUNTS.values():
        setattr(fn, attr, 0)
    for sub in C_SUB:
        setattr(bsm.bsmm_fwd, f"{sub}_launches", 0)
    bsm.bsmm_dx.second_pass_launches = bsm.bsmm_dw.second_pass_launches = 0


def read_counts() -> dict:
    return dict({name: fn.launches for name, fn in WRAPPERS.items()},
                **{k: getattr(fn, attr) for k, (fn, attr) in SUB_COUNTS.items()})


def c_sub_counts() -> dict:
    """Kernel C's second passes, All-ReLU stores and launches by route."""
    return {sub: getattr(bsm.bsmm_fwd, f"{sub}_launches") for sub in C_SUB}


NO_LAUNCHES = {name: 0 for name in (*WRAPPERS, *SUB_COUNTS)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS_PER_S * 1e3
    return dict(bytes=n_bytes, ops=n_ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def library_ms(fn):
    """Time of the PyTorch library call used as a yardstick, or None where
    this PyTorch build cannot run it on the card (the port never calls it)."""
    try:
        return device_ms(fn)
    except RuntimeError as e:
        print(f"library call unavailable: {e}", file=sys.stderr)
        return None


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call, from CUDA events around ``reps`` calls. A
    spin kernel ahead of them holds the stream while the host enqueues, so
    the events time the calls back to back and not the host's launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 4e5))  # ~0.2 ms of spinning per call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def requests(x_test: np.ndarray, n: int) -> np.ndarray:
    return x_test[np.arange(n) % len(x_test)]


# -- phases -----------------------------------------------------------------


def phase_device(out: dict) -> str:
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    out.update(name=name, count=count, smi=smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return f"{name} count={count} ({smi}); torch {torch.__version__} cuda {torch.version.cuda}"


def phase_build(out: dict) -> str:
    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    regs = {
        s: ",".join(re.findall(r"Used (\d+) registers", text)) for s, text in logs.items()
    }
    for s in build.KERNEL_SOURCES:
        check(build.library_path(s).exists(), f"{s} did not build")
    return f"{len(build.KERNEL_SOURCES)} sources, nvcc sm_90a, {secs:.2f} s; registers {regs}"


def seeded_model(device: str) -> SparseMLP:
    """The full-width SET-MLP with the seeded topology and init, and biases
    drawn from the same seed: the reference initialises biases to zero,
    which would leave the bias half of kernel B and the output layer's bias
    add unexercised."""
    model = SparseMLP(mlp_config("cifar10"), seed=SEED, device=device)
    rng = np.random.default_rng(SEED)
    model.biases = [
        torch.as_tensor((0.1 * rng.standard_normal(b.shape)).astype(np.float32), device=device)
        for b in model.biases
    ]
    return model


def phase_kernels(out: dict) -> str:
    """Each kernel against its plain version at the uncompacted widths and
    at the compacted ones the engine serves (the tensors phase_timings
    times), on the activations the forward gives each layer."""
    model = seeded_model("cuda")
    # compaction runs on the host at construction and launches no kernel
    engine = SparseInferenceEngine(model, compaction=SCHEDULE)
    served = engine.model
    x_test = load("cifar10", scale=0.01).x_test
    rng = np.random.default_rng(SEED)
    dev = served.device
    err = {(k, m): 0.0 for k in ("coo_matmul_T", "bias_all_relu", "epilogue")
           for m in ("full", "served")}
    n_checks = 0

    def compare_a(m, which, l, srcT, acc=None):
        nonlocal n_checks
        topo = m.topos[l]
        t = topo.device_arrays(dev)
        seg_ptr = sparsity.offsets_to_device(topo.col_ptr(), dev)
        got = sparsity.coo_matmul_T(
            srcT, m.values[l], t.rows, t.cols, topo.out_dim, acc=acc, seg_ptr=seg_ptr
        )
        torch.cuda.synchronize()
        want = sparsity.coo_matmul_T_plain(srcT, m.values[l], t.rows, t.cols, topo.out_dim, acc=acc)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        key = ("coo_matmul_T", which)
        err[key] = max(err[key], float((got - want).abs().max()))
        n_checks += 1
        return want

    def compare_b(which, x, b, layer_index):
        nonlocal n_checks
        got = all_relu_fused.bias_all_relu(x, b, alpha=model.config.alpha, layer_index=layer_index)
        torch.cuda.synchronize()
        want = all_relu_fused.bias_all_relu_plain(
            x, b, alpha=model.config.alpha, layer_index=layer_index)
        check(torch.equal(got, want),
              f"kernel B differs from its plain version at {tuple(x.shape)}, layer {layer_index}")
        key = ("bias_all_relu", which)
        err[key] = max(err[key], float((got - want).abs().max()))
        n_checks += 1
        return want

    def compare_epilogue(m, which, l, srcT, acc):
        """Kernel A's epilogue on both routes: bit-equal to kernel A then
        kernel B (slope +alpha and -alpha) or then ``+ bias``, and within
        A's tolerance of the plain version. That tolerance is the product's
        (its sum order differs), so it is taken at the larger of the
        product's and the result's magnitude: the bias can cancel the
        product, and the epilogue moves no two values further apart."""
        nonlocal n_checks
        topo, bias, alpha = m.topos[l], m.biases[l], m.config.alpha
        t = topo.device_arrays(dev)
        seg_ptr = sparsity.offsets_to_device(topo.col_ptr(), dev)
        args = (srcT, m.values[l], t.rows, t.cols, seg_ptr, topo.out_dim, acc)
        plain = sparsity.coo_matmul_T_plain(srcT, m.values[l], t.rows, t.cols, topo.out_dim,
                                            acc=acc)
        for route in (sparsity.COO_THREAD, sparsity.COO_STAGED):
            base = sparsity._coo_matmul_T_cuda(*args, route)
            for layer_index in (None, 1, 2):  # + bias; All-ReLU, slope +alpha and -alpha
                slope = None if layer_index is None else ref.slope_for(alpha, layer_index)
                got = sparsity._coo_matmul_T_cuda(*args, route, bias=bias, slope=slope)
                if layer_index is None:
                    bits = base + bias[:, None]
                else:
                    bits = all_relu_fused.bias_all_relu(
                        base.T.contiguous(), bias, alpha=alpha, layer_index=layer_index).T
                torch.cuda.synchronize()
                check(torch.equal(got, bits),
                      f"kernel A's epilogue (layer index {layer_index}) differs from kernel A "
                      f"then {'B' if layer_index else '+ bias'} at {which} layer {l}, batch "
                      f"{srcT.shape[1]}, route {route}, acc {acc is not None}")
                want = sparsity.coo_epilogue(plain, bias, slope)
                check(bool((got - want).abs().le(
                          ATOL + RTOL * torch.maximum(plain.abs(), want.abs())).all()),
                      f"kernel A's epilogue is further from its plain version than A's "
                      f"tolerance at {which} layer {l}, batch {srcT.shape[1]}, route {route}")
                key = ("epilogue", which)
                err[key] = max(err[key], float((got - want).abs().max()))
                n_checks += 1

    # each layer's input is the activation the forward gives it, carried
    # from the requests through the plain versions; kernel B sees the
    # (B, N) product and the layer's own (nonzero) bias, kernel A's
    # epilogue the (N, B) product, with and without a seeded carry-in
    for which, m in (("full", model), ("served", served)):
        for batch in EPILOGUE_BATCHES:
            srcT = torch.as_tensor(np.ascontiguousarray(requests(x_test, batch).T), device=dev)
            for l in range(m.config.n_layers):
                n_out = m.topos[l].out_dim
                carry = torch.as_tensor(
                    rng.standard_normal((n_out, batch)).astype(np.float32), device=dev)
                for acc in (None, carry):
                    compare_epilogue(m, which, l, srcT, acc)
                yT = compare_a(m, which, l, srcT)
                if l < m.config.n_layers - 1:
                    h = compare_b(which, yT.T.contiguous(), m.biases[l], l + 1)
                    srcT = h.T.contiguous()
    topo = served.topos[1]
    srcT = torch.as_tensor(rng.standard_normal((topo.in_dim, 128)).astype(np.float32), device=dev)
    acc = torch.as_tensor(rng.standard_normal((topo.out_dim, 128)).astype(np.float32), device=dev)
    compare_a(served, "served", 1, srcT, acc=acc)
    # no connections at all: the carry-in comes back, or exact zeros
    empty_f = torch.empty((0,), dtype=torch.float32, device=dev)
    empty_i = torch.empty((0,), dtype=torch.int32, device=dev)
    for acc_in in (None, acc):
        got = sparsity.coo_matmul_T(srcT, empty_f, empty_i, empty_i, topo.out_dim, acc=acc_in)
        torch.cuda.synchronize()
        check(torch.equal(got, torch.zeros_like(acc) if acc_in is None else acc),
              "kernel A with nnz == 0 must return the carry-in or zeros")
    # a ragged width takes kernel B's scalar path; a padded product's column
    # slice is read at its row pitch: 16-byte path at pitch 4096 and 1024,
    # scalar where the pitch or the start is not 16-byte aligned
    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    compare_b("full", normal(5, 1001), normal(1001), 2)
    for shape, sl in (((128, 4096), np.s_[:, :4000]), ((512, 1024), np.s_[:, :1000]),
                      ((5, 1003), np.s_[:, :1001]), ((4, 4004), np.s_[:, 1:4001])):
        x = normal(*shape)[sl]
        check(not x.is_contiguous(), "a strided input expected")
        compare_b("full", x, normal(x.shape[-1]), 1)
    routes = kernel_a_bits(served, x_test, rng)

    out.update(model=model, engine=engine, x_test=x_test,
               err={k: err[(k, "served")] for k in ("coo_matmul_T", "bias_all_relu")})
    return (
        f"{n_checks} comparisons at dims {model.config.layer_dims} and served dims "
        f"{served.config.layer_dims}, batch {EPILOGUE_BATCHES}; kernel A max_abs_err "
        f"{err[('coo_matmul_T', 'full')]:.3g} full, {err[('coo_matmul_T', 'served')]:.3g} "
        f"served (rtol {RTOL}, atol {ATOL}); kernel A's epilogue bit-equal to A then B (or "
        f"+ bias) on both routes, with and without acc, max_abs_err to the plain version "
        f"{err[('epilogue', 'full')]:.3g} full, {err[('epilogue', 'served')]:.3g} served; "
        f"kernel A routes by layer {routes}; at the served output layer its two routes and "
        f"its zero-slot elimination bit-equal at batch 1 and 128; kernel B bit-equal, "
        f"contiguous and at a row pitch"
    )


def kernel_a_bits(served: SparseMLP, x_test: np.ndarray, rng: np.random.Generator) -> list:
    """Kernel A at the served output layer (10 segments of 2,800 slots), at
    batch 1 and 128: its two routes give the same bits, and so does the
    layer with a third of its values zeroed and those slots dropped (the
    compaction contract). Returns the route each served layer takes."""
    dev = served.device
    topo, vals = served.topos[-1], served.values[-1]
    t = topo.device_arrays(dev)
    seg_ptr = sparsity.offsets_to_device(topo.col_ptr(), dev)
    zeroed = vals.clone()
    zeroed[torch.as_tensor(rng.choice(topo.nnz, topo.nnz // 3, replace=False), device=dev)] = 0
    keep = zeroed != 0
    kept_ptr = sparsity.offsets_to_device(
        np.concatenate([[0], np.cumsum(np.bincount(topo.cols[keep.cpu().numpy()],
                                                   minlength=topo.out_dim))]), dev)
    for batch in (1, 128):
        srcT = torch.as_tensor(rng.standard_normal((topo.in_dim, batch)).astype(np.float32),
                               device=dev)
        by_route = [sparsity._coo_matmul_T_cuda(srcT, vals, t.rows, t.cols, seg_ptr,
                                                topo.out_dim, None, route)
                    for route in (sparsity.COO_THREAD, sparsity.COO_STAGED)]
        full = sparsity.coo_matmul_T(srcT, zeroed, t.rows, t.cols, topo.out_dim, seg_ptr=seg_ptr)
        kept = sparsity.coo_matmul_T(srcT, zeroed[keep], t.rows[keep], t.cols[keep],
                                     topo.out_dim, seg_ptr=kept_ptr)
        torch.cuda.synchronize()
        check(torch.equal(by_route[0], by_route[1]),
              f"kernel A's two routes differ at the served output layer, batch {batch}")
        check(torch.equal(full, kept),
              f"kernel A changed its bits when zero slots were dropped, batch {batch}")
    return [sparsity.coo_route(int(np.diff(tp.col_ptr()).max())) for tp in served.topos]


def phase_main(out: dict) -> str:
    model, engine, x_test = out["model"], out["engine"], out["x_test"]
    cfg = model.config
    reqs = {n: requests(x_test, n) for n in SIZES}
    reset_counts()
    logits = {n: engine.classify(reqs[n]) for n in SIZES}
    launches = read_counts()
    cap = engine.cfg.batch_buckets[-1]
    forwards = sum(-(-n // cap) for n in SIZES)
    # one kernel A a layer, each with its epilogue; kernel B's pass is in it
    want = dict(NO_LAUNCHES, **{"coo_matmul_T": forwards * cfg.n_layers,
                                "coo_matmul_T.epilogue": forwards * cfg.n_layers})
    check(launches == want, f"launch counts {launches}, expected {want}")
    for n in SIZES:
        check(logits[n].shape == (n, cfg.layer_dims[-1]), f"logits shape {logits[n].shape}")
        check(bool(np.isfinite(logits[n]).all()), "non-finite logits")

    # the same model served on the CPU by the plain versions
    cpu_engine = SparseInferenceEngine(seeded_model("cpu"), compaction=SCHEDULE, device="cpu")
    check(cpu_engine.report == engine.report, "compaction differs between card and CPU")
    err = 0.0
    for n in SIZES:
        ref = cpu_engine.classify(reqs[n])
        np.testing.assert_allclose(logits[n], ref, rtol=RTOL, atol=ATOL)
        err = max(err, float(np.abs(logits[n] - ref).max()))

    # lossless compaction: bit-equal to the importance-pruned model served
    # without elimination
    pruned, _ = importance_prune_mlp(model, SCHEDULE)
    pruned_engine = SparseInferenceEngine(pruned, compact=False)
    for n in SIZES:
        check(np.array_equal(pruned_engine.classify(reqs[n]), logits[n]),
              f"compacted logits differ from the pruned model's at n={n}")
    out.update(launches=launches)
    r = engine.report
    return (
        f"classify sizes {SIZES}: dims {r.dims_before} -> {r.dims_after}, params "
        f"{r.params_before} -> {r.params_after}; launches {launches} over {forwards} "
        f"forwards; max |card - cpu plain| {err:.3g}; compaction bit-equal"
    )


def profile_classify(engine, x: np.ndarray, latency_ms: float, calls: int = 20,
                     attempts: int = 3) -> dict:
    """Where one classify call's time goes: device time per kernel or copy
    (torch.profiler, device-side events only), the device's busy time, and
    its idle share of the unprofiled median latency. Per call, it also
    splits the device's work into kernel A, host-device copies (``Memcpy``)
    and the other kernels (the copy and transpose kernels around A), each
    with its time and its launches.

    torch.profiler can drop the device events of whole calls (PERF.md §7):
    a profile that saw fewer kernel-A launches than A's wrapper counted over
    the same calls is taken again, up to ``attempts`` times, and the last
    one is returned as it is (``profile_attempts``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.classify(x)
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                engine.classify(x)
            torch.cuda.synchronize()
            profiled_wall_us = (time.perf_counter() - t0) * 1e6 / calls
        counted = read_counts()["coo_matmul_T"]
        by_name: dict = {}
        kinds = {k: dict(us=0.0, launches=0.0) for k in ("kernel_a", "memcpy", "other_kernels")}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                by_name[e.key[:200]] = (by_name.get(e.key[:200], 0.0)
                                        + e.self_device_time_total / calls)
                kind = ("memcpy" if e.key.startswith(("Memcpy", "Memset")) else
                        "kernel_a" if "coo_matmul_T" in e.key else "other_kernels")
                kinds[kind]["us"] += e.self_device_time_total / calls
                kinds[kind]["launches"] += e.count / calls
        if round(kinds["kernel_a"]["launches"] * calls) >= counted:
            break
    busy_us = sum(by_name.values())
    return dict(batch=len(x), latency_us=latency_ms * 1e3, profiled_wall_us=profiled_wall_us,
                device_busy_us=busy_us, device_idle_share=1.0 - busy_us / (latency_ms * 1e3),
                kernel_launches=kinds["kernel_a"]["launches"] + kinds["other_kernels"]["launches"],
                device_by_kind=kinds, device_us_by_name=by_name, profile_attempts=attempt,
                kernel_a_counted_per_call=counted / calls)


def classify_latency(engine, x_test: np.ndarray) -> dict:
    """A classify's latency at each batch bucket: the median of 30 calls
    after 5 warm-up calls, with quartiles (host clock; a call ends in its
    copy to the host)."""
    latency = {}
    for bucket in engine.cfg.batch_buckets:
        x = requests(x_test, bucket)
        for _ in range(5):
            engine.classify(x)
        ts = []
        for _ in range(30):
            t0 = time.perf_counter()
            engine.classify(x)
            ts.append((time.perf_counter() - t0) * 1e3)
        q25, q50, q75 = np.percentile(ts, [25, 50, 75])
        latency[bucket] = dict(median=float(q50), q25=float(q25), q75=float(q75))
    return latency


def phase_timings(out: dict) -> str:
    engine = out["engine"]
    latency = out["classify_ms"] = classify_latency(engine, out["x_test"])
    print(json.dumps({"classify_ms": latency}))
    cfg = engine.model.config
    profiles = {}
    for bucket in (1, 128):
        profiles[bucket] = profile_classify(
            engine, requests(out["x_test"], bucket), latency[bucket]["median"])
        print(json.dumps({"classify_profile": profiles[bucket]}))
    # the served forward: one kernel A a layer and, at bucket 128, the
    # input's and the logits' transposes; a (1, F) transpose needs no copy
    for bucket, most in ((1, 0), (128, 2)):
        kinds = profiles[bucket]["device_by_kind"]
        check(kinds["kernel_a"]["launches"] == cfg.n_layers,
              f"bucket {bucket}: {kinds['kernel_a']['launches']} kernel A launches a classify")
        check(kinds["other_kernels"]["launches"] <= most,
              f"bucket {bucket}: {kinds['other_kernels']['launches']} copy or transpose "
              f"kernels a classify, expected at most {most}")

    dev = engine.device
    rows = []
    for batch in (1, 128):
        # the served layout: each layer's (features, batch) output feeds the next
        hT = torch.as_tensor(np.ascontiguousarray(requests(out["x_test"], batch).T), device=dev)
        for l in range(cfg.n_layers):
            vals, bias = engine.model.values[l], engine.model.biases[l]
            host = engine.model.topos[l]
            topo = host.device_arrays(dev)
            seg_ptr = sparsity.registered_offsets(topo.cols)
            n_out, nnz = host.out_dim, host.nnz
            route = sparsity.coo_route(int(np.diff(host.col_ptr()).max()))
            hidden = l < cfg.n_layers - 1
            slope = ref.slope_for(cfg.alpha, l + 1) if hidden else None
            srcT = hT
            csr = torch.sparse_csr_tensor(
                seg_ptr, topo.rows.long(), vals, (n_out, host.in_dim), check_invariants=True
            )
            nbytes = 4 * (srcT.numel() + 2 * nnz + n_out * batch) + 8 * (n_out + 1)
            a_ms = device_ms(lambda: sparsity.coo_matmul_T(
                srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr))
            a_epi_ms = device_ms(lambda: sparsity.coo_matmul_T(
                srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr, bias=bias, slope=slope))
            rows.append(dict(
                kernel="coo_matmul_T", layer=l, batch=batch, shape=[host.in_dim, n_out],
                nnz=nnz, route=route, ms=a_ms, with_epilogue_ms=a_epi_ms,
                epilogue="bias + All-ReLU" if hidden else "bias",
                other_route_ms=device_ms(lambda: sparsity._coo_matmul_T_cuda(
                    srcT, vals, topo.rows, topo.cols, seg_ptr, n_out, None, 1 - route)),
                plain_ms=device_ms(lambda: sparsity.coo_matmul_T_plain(
                    srcT, vals, topo.rows, topo.cols, n_out)),
                library_ms=library_ms(lambda: torch.sparse.mm(csr, srcT)),
                **bound(nbytes, 2 * nnz * batch),
            ))
            yT = sparsity.coo_matmul_T(srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr)
            hT = sparsity.coo_matmul_T(srcT, vals, topo.rows, topo.cols, n_out, seg_ptr=seg_ptr,
                                       bias=bias, slope=slope)
            if not hidden:
                break
            # kernel B's work: its cost inside A's store (A with the epilogue
            # less A alone), bound by the bias's bytes and the 3 operations an
            # element; beside it the standalone pass on the (B, N) product
            y = yT.T.contiguous()
            weight = torch.tensor([slope], device=dev)
            rows.append(dict(
                kernel="bias_all_relu", layer=l, batch=batch, shape=list(y.shape),
                ms=a_epi_ms - a_ms,
                plain_ms=device_ms(lambda: sparsity.coo_epilogue(yT, bias, slope)),
                library_ms=library_ms(lambda: F.prelu(y + bias, weight)),
                standalone_ms=device_ms(lambda: all_relu_fused.bias_all_relu(
                    y, bias, alpha=cfg.alpha, layer_index=l + 1)),
                standalone_bound_ms=bound(4 * (2 * y.numel() + n_out), 3 * y.numel())["bound_ms"],
                **bound(4 * n_out, 3 * y.numel()),
            ))
    for r in rows:
        print(json.dumps({"kernel_timing": r}))

    # one classify call at the largest bucket: the sum over its launches.
    # Kernel B's launches are its standalone pass's in the block path's
    # evaluations; on the served path it runs inside kernel A's epilogue.
    at128 = {k: [r for r in rows if r["kernel"] == k and r["batch"] == 128]
             for k in ("coo_matmul_T", "bias_all_relu")}
    out["kernels"] = [
        dict(kernel_entry(KERNEL_A, at128["coo_matmul_T"], out["launches"]["coo_matmul_T"],
                          out["err"]["coo_matmul_T"]),
             with_epilogue_ms=sum(r["with_epilogue_ms"] for r in at128["coo_matmul_T"])),
        dict(kernel_entry(KERNEL_B, at128["bias_all_relu"],
                          out["train_launches"]["bias_all_relu"], out["err"]["bias_all_relu"]),
             epilogue_launches=out["launches"]["coo_matmul_T.epilogue"],
             **{k: sum(r[k] for r in at128["bias_all_relu"])
                for k in ("standalone_ms", "standalone_bound_ms")}),
    ]
    return "classify median ms by bucket " + ", ".join(
        f"{b}: {latency[b]['median']:.3f}" for b in latency
    ) + (f"; kernel launches a classify {profiles[1]['kernel_launches']:g} at bucket 1, "
         f"{profiles[128]['kernel_launches']:g} at 128; profiles and per-kernel rows above")


# -- the block-sparse training path (kernels C, D, E) -------------------------


def block_model(device, dropout: float = 0.0) -> SparseMLP:
    """The full-width CIFAR-10 block SET-MLP (128x128 tiles), seeded."""
    cfg = dataclasses.replace(mlp_config("cifar10", impl="block"), dropout=dropout)
    return SparseMLP(cfg, seed=SEED, device=device)


def train_config(device_evolution: bool = False) -> TrainerConfig:
    """3 epochs with SET after epochs 0 and 1 and importance pruning at
    epochs 1 and 2; SET on the host (the run held to the CPU's) unless
    ``device_evolution``."""
    return TrainerConfig(
        epochs=TRAIN_EPOCHS, batch_size=128, lr=0.01, zeta=0.3,
        device_evolution=device_evolution,
        pruning=PruningSchedule(tau=1, period=1, percentile=5.0),
    )


def block_layer_inputs(model: SparseMLP, x: np.ndarray, rng: np.random.Generator):
    """Per layer: (meta, host topology, device arrays, values, padded input
    activation, a seeded output gradient), the activations carried from
    ``x`` through the plain forward."""
    cfg, dev = model.config, model.device
    act = activation_fn(cfg.activation, alpha=cfg.alpha)
    h = torch.as_tensor(x, device=dev)
    layers = []
    for l in range(cfg.n_layers):
        meta = block_meta(cfg, l)
        t = model.topos[l].device_arrays(dev)
        xp = F.pad(h, (0, meta.padded_in - meta.in_dim)).contiguous()
        dy = torch.as_tensor(
            (0.01 * rng.standard_normal((len(x), meta.padded_out))).astype(np.float32),
            device=dev)
        layers.append((meta, model.topos[l], t, model.values[l], xp, dy))
        y = bsm.bsmm_fwd_plain(xp, model.values[l], t.rows, t.cols, t.first_col,
                               grid_n=meta.grid_n)[:, : meta.out_dim] + model.biases[l]
        h = act(y, l + 1) if l < cfg.n_layers - 1 else y
    return layers


def phase_block_kernels(out: dict) -> str:
    model = block_model(CARD)
    x_train = load("cifar10", scale=TRAIN_SCALE).x_train
    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in ("bsmm_fwd", "bsmm_dx", "bsmm_dw")}
    n_checks, n_uncovered = 0, []

    def compare(name, got, want):
        nonlocal n_checks
        torch.testing.assert_close(got, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
        err[name] = max(err[name], float((got - want).abs().max()))
        n_checks += 1

    def check_layer(meta, rows, t, v, x, dy):
        y = bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
        dx = bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)
        dw = bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m, block_n=meta.block_n)
        torch.cuda.synchronize()
        for _ in range(2):  # C, D and E split long sums: the same bits on every launch
            check(torch.equal(y, bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                               grid_n=meta.grid_n)),
                  f"kernel C gave other bits on a second launch at {tuple(x.shape)}")
            check(torch.equal(dx, bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                               grid_m=meta.grid_m)),
                  f"kernel D gave other bits on a second launch at {tuple(dy.shape)}")
            check(torch.equal(dw, bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                               block_n=meta.block_n)),
                  f"kernel E gave other bits on a second launch at {tuple(x.shape)}")
        compare("bsmm_fwd", y, bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                                  grid_n=meta.grid_n))
        compare("bsmm_dx", dx, bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row,
                                                 t.perm_r, grid_m=meta.grid_m))
        compare("bsmm_dw", dw, bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                                 block_n=meta.block_n))
        uncovered = np.setdiff1d(np.arange(meta.grid_m), rows)
        tiles = dx.reshape(dx.shape[0], meta.grid_m, meta.block_m)
        check(not tiles[:, torch.as_tensor(uncovered, device=dx.device).long()].any(),
              f"kernel D wrote nonzeros into {len(uncovered)} uncovered block-rows")
        n_uncovered.append(len(uncovered))
        return y

    for batch in (128, 100):
        for meta, host, t, v, x, dy in block_layer_inputs(model, x_train[:batch], rng):
            check_layer(meta, host.rows, t, v, x, dy)
    # 8x8 and a non-square 32x16 with padded features, full and ragged batches
    for in_dim, out_dim, bm, bn, eps in ((64, 48, 8, 8, 6), (100, 70, 32, 16, 8)):
        meta = sparsity.BlockMeta(in_dim, out_dim, bm, bn)
        small = sparsity.BlockTopology.from_epsilon(meta, eps, rng)
        v = small.init_values(rng, device=CARD)
        t = small.device_arrays(CARD)
        for batch in (128, 100):
            x = np.zeros((batch, meta.padded_in), np.float32)
            x[:, :in_dim] = rng.standard_normal((batch, in_dim))
            dy = rng.standard_normal((batch, meta.padded_out)).astype(np.float32)
            check_layer(meta, small.rows, t, v, torch.as_tensor(x, device=CARD),
                        torch.as_tensor(dy, device=CARD))
    # skewed block-columns: kernel C splits the long ones into runs (and
    # writes zeros for the empty ones), 16-byte copies at 128x128 and 4-byte
    # copies at 5x5
    for counts, bm, bn in (([0, 40, 0], 128, 128), ([1, 2, 7, 33], 128, 128),
                           ([1, 2, 7, 33], 5, 5)):
        grid_m, grid_n = max(counts) + 2, len(counts)
        meta = sparsity.BlockMeta(grid_m * bm, grid_n * bn, bm, bn)
        cols = np.repeat(np.arange(grid_n), counts).astype(np.int32)
        rows = np.concatenate([np.sort(rng.choice(grid_m, k, replace=False)) for k in counts])
        t = block_device_arrays(torch.as_tensor(rows.astype(np.int32), device=CARD),
                                torch.as_tensor(cols, device=CARD), meta=meta)
        lim = np.sqrt(6.0 / meta.padded_in)  # he-uniform, as the block model's values
        v = torch.as_tensor(rng.uniform(-lim, lim, (len(cols), bm, bn)).astype(np.float32),
                            device=CARD)
        for batch in (128, 100):
            x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(np.float32),
                                device=CARD)
            dy = torch.as_tensor(
                rng.standard_normal((batch, meta.padded_out)).astype(np.float32), device=CARD)
            y = check_layer(meta, rows, t, v, x, dy)
            empty = [c for c, k in enumerate(counts) if k == 0]
            check(not y.reshape(batch, grid_n, bn)[:, empty].any(),
                  "kernel C wrote nonzeros into a block-column with no slot")
    # skewed block-rows: kernel D splits the long ones into runs (and writes
    # exact zeros for the empty ones); the same copies as above
    for counts, bm, bn in (([0, 40, 0], 128, 128), ([1, 2, 7, 33], 128, 128),
                           ([1, 2, 7, 33], 5, 5)):
        grid_m, grid_n = len(counts), max(counts) + 2
        meta = sparsity.BlockMeta(grid_m * bm, grid_n * bn, bm, bn)
        rows = np.repeat(np.arange(grid_m), counts)
        cols = np.concatenate([rng.choice(grid_n, k, replace=False) for k in counts])
        order = np.lexsort((rows, cols))
        rows, cols = rows[order].astype(np.int32), cols[order].astype(np.int32)
        t = block_device_arrays(torch.as_tensor(rows, device=CARD),
                                torch.as_tensor(cols, device=CARD), meta=meta)
        lim = np.sqrt(6.0 / meta.padded_out)  # he-uniform over dx's fan-in
        v = torch.as_tensor(rng.uniform(-lim, lim, (len(cols), bm, bn)).astype(np.float32),
                            device=CARD)
        for batch in (128, 100):
            check(bsm.dx_parts(len(rows), grid_m, batch, bm) > 1, "kernel D did not split")
            x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(np.float32),
                                device=CARD)
            dy = torch.as_tensor(
                rng.standard_normal((batch, meta.padded_out)).astype(np.float32), device=CARD)
            check_layer(meta, rows, t, v, x, dy)
    out["err"].update(err)
    acc = block_accuracy(rng)
    print(json.dumps({"block_accuracy": acc}))
    return (
        f"{n_checks} comparisons: 4 full-width block layers (128x128 tiles, "
        f"{[tp.n_blocks for tp in model.topos]} tiles) at batch 128 and 100, 8x8 and 32x16 "
        f"tiles and skewed columns and rows (slots [0, 40, 0] and [1, 2, 7, 33]; 128x128 and "
        f"5x5) at batch 128 and 100; C, D and E bit-equal over 3 launches each; max_abs_err C "
        f"{err['bsmm_fwd']:.3g}, D {err['bsmm_dx']:.3g}, E {err['bsmm_dw']:.3g} "
        f"(rtol {BLOCK_RTOL}, atol {BLOCK_ATOL}); "
        f"uncovered dx block-rows exactly 0 ({n_uncovered[:4]} per full-width layer)"
    )


def block_accuracy(rng: np.random.Generator) -> dict:
    """Kernels C and E against an f64 product where an f32 sum is long and
    large: unit-normal inputs and values, one block-column of 40 128x128
    slots (K = 5,120) at batch 128 for C, a batch of 5,120 for E. Beside
    each, the plain version's error (cuBLAS, f32). A measurement, not a
    check: it shows whether 3xTF32 sums as an f32 sum does."""
    bm = bn = 128
    meta = sparsity.BlockMeta(42 * bm, 3 * bn, bm, bn)
    t = block_device_arrays(torch.arange(1, 41, dtype=torch.int32, device=CARD),
                            torch.ones(40, dtype=torch.int32, device=CARD), meta=meta)
    v = torch.as_tensor(rng.standard_normal((40, bm, bn)).astype(np.float32), device=CARD)
    res = {}
    for name, batch in (("bsmm_fwd", 128), ("bsmm_dw", 5120)):
        x = torch.as_tensor(rng.standard_normal((batch, meta.padded_in)).astype(np.float32),
                            device=CARD)
        if name == "bsmm_fwd":
            args = (x, v, t.rows, t.cols, t.first_col)
            fns = (bsm.bsmm_fwd, bsm.bsmm_fwd_plain)
            kw = dict(grid_n=meta.grid_n)
        else:
            dy = torch.as_tensor(
                rng.standard_normal((batch, meta.padded_out)).astype(np.float32), device=CARD)
            args = (x, dy, t.rows, t.cols)
            fns = (bsm.bsmm_dw, bsm.bsmm_dw_plain)
            kw = dict(block_m=bm, block_n=bn)
        want = fns[1](*(a.double() if a.is_floating_point() else a for a in args), **kw)
        got = [f(*args, **kw).double() for f in fns]
        torch.cuda.synchronize()
        res[name] = dict(k=40 * bm if name == "bsmm_fwd" else batch,
                         max_abs_ref=float(want.abs().max()),
                         kernel_max_abs_err=float((got[0] - want).abs().max()),
                         plain_max_abs_err=float((got[1] - want).abs().max()))
    return res


def trainer_for(model: SparseMLP, device_evolution: bool = False):
    """A trainer of ``model`` with ``train_config(device_evolution)``, the
    list its epoch hook fills with each epoch's topology (the host mirror,
    which the trainer syncs before the hook), and the list of each epoch's
    topology phase's seconds (pruning and SET, timed between two
    synchronisations of the device)."""
    trainer = SequentialTrainer(model, load("cifar10", scale=TRAIN_SCALE),
                                train_config(device_evolution))
    topologies, phase_s = [], []
    trainer.epoch_end_hook = lambda tr, epoch: topologies.append(
        [(t.rows.copy(), t.cols.copy()) for t in tr.model.topos])
    topology_phase = trainer._topology_phase

    def timed(*args):
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = topology_phase(*args)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        phase_s.append(time.perf_counter() - t0)
        return res

    trainer._topology_phase = timed
    return trainer, topologies, phase_s


def run_steps(trainer: SequentialTrainer):
    """The 3-epoch run's steps and evaluation batches."""
    return (TRAIN_EPOCHS * (len(trainer.data.x_train) // 128),
            TRAIN_EPOCHS * -(-len(trainer.data.x_test) // 512))


def block_launches(cfg, steps: int, evals: int) -> dict:
    """A block run's launches: C, D and E in each step, C in each
    evaluation batch, whose hidden layers (autograd off) run kernel B."""
    return dict(NO_LAUNCHES, bias_all_relu=evals * (cfg.n_layers - 1),
                bsmm_fwd=(steps + evals) * cfg.n_layers,
                bsmm_dx=steps * (cfg.n_layers - 1), bsmm_dw=steps * cfg.n_layers)


def element_launches(cfg, steps: int, evals: int) -> dict:
    """An element run's launches. A step: A forward on every layer (the
    hidden ones with the mask), A's dX on all but layer 0, F with its
    epilogue (G's work) on every layer (the hidden ones with All-ReLU's
    mask), no standalone G; an evaluation batch: A with its epilogue on
    every layer."""
    n_layers = cfg.n_layers
    return dict(NO_LAUNCHES, **{
        "coo_matmul_T": steps * (2 * n_layers - 1) + evals * n_layers,
        "coo_matmul_T.epilogue": (steps + evals) * n_layers,
        "coo_matmul_T.mask": steps * (n_layers - 1),
        "coo_dw": steps * n_layers, "coo_dw.epilogue": steps * n_layers,
        "coo_dw.mask": steps * (n_layers - 1)})


def phase_train(out: dict) -> str:
    card, card_topos, phase_s = trainer_for(block_model(CARD))
    reset_counts()
    hist = card.run()
    launches = read_counts()
    cfg = card.model.config
    steps, evals = run_steps(card)
    want = block_launches(cfg, steps, evals)
    check(launches == want, f"launch counts {launches}, expected {want}")
    check(bool(np.isfinite(hist["train_loss"]).all()), f"non-finite loss {hist['train_loss']}")

    cpu_hist, loss_err = same_run_on_cpu(card, hist, card_topos, block_model("cpu"))
    drop_hist = dropout_run(block_model(CARD, dropout=0.3))
    out.update(train_hist=hist, train_launches=launches, train_phase_s=phase_s)
    print(json.dumps({"train_history": {"card": hist, "cpu": cpu_hist, "dropout_0.3": drop_hist}}))
    return (
        f"3 epochs x {steps // TRAIN_EPOCHS} steps of 128 at dims {cfg.layer_dims}, tiles "
        f"{[t.n_blocks for t in card.model.topos]} after pruning; loss {hist['train_loss']}, "
        f"acc {hist['test_acc']}, n_params {hist['n_params']}; card vs CPU: topology and "
        f"n_params equal every epoch, loss rel err {loss_err:.3g} (rtol {TRAIN_LOSS_RTOL}); "
        f"launches {launches}; dropout 0.3 loss {drop_hist['train_loss']}"
    )


def same_run_on_cpu(card: SequentialTrainer, hist: dict, card_topos: list, cpu_model: SparseMLP):
    """The card run's history against the same run on the CPU, through the
    plain versions: topology and n_params equal after every epoch, loss
    within TRAIN_LOSS_RTOL, accuracy within one test sample. Returns the
    CPU history and the largest relative loss difference."""
    cpu, cpu_topos, _ = trainer_for(cpu_model)
    cpu_hist = cpu.run()
    check(hist["n_params"] == cpu_hist["n_params"],
          f"n_params {hist['n_params']} on the card, {cpu_hist['n_params']} on the CPU")
    check(len(card_topos) == len(cpu_topos) == TRAIN_EPOCHS, "an epoch hook did not fire")
    for epoch, (a, b) in enumerate(zip(card_topos, cpu_topos)):
        for l, ((ra, ca), (rb, cb)) in enumerate(zip(a, b)):
            check(np.array_equal(ra, rb) and np.array_equal(ca, cb),
                  f"topology of layer {l} differs after epoch {epoch}")
    np.testing.assert_allclose(hist["train_loss"], cpu_hist["train_loss"], rtol=TRAIN_LOSS_RTOL)
    n_test = len(card.data.y_test)
    np.testing.assert_allclose(hist["test_acc"], cpu_hist["test_acc"], atol=1.0 / n_test + 1e-9)
    return cpu_hist, max(abs(a - b) / abs(b)
                         for a, b in zip(hist["train_loss"], cpu_hist["train_loss"]))


def dropout_run(model: SparseMLP) -> dict:
    """A run at the paper's dropout on the card: the loss must be finite and
    fall."""
    hist = trainer_for(model)[0].run()  # host SET
    check(bool(np.isfinite(hist["train_loss"]).all())
          and hist["train_loss"][-1] < hist["train_loss"][0],
          f"dropout {model.config.dropout} run: loss {hist['train_loss']} is not finite "
          f"and falling")
    return hist


# -- the element training path (kernels A, F, G) ------------------------------


def element_model(device, dropout: float = 0.0) -> SparseMLP:
    """The full-width CIFAR-10 element SET-MLP, seeded."""
    return SparseMLP(dataclasses.replace(mlp_config("cifar10"), dropout=dropout), seed=SEED,
                     device=device)


def element_layer_inputs(model: SparseMLP, x: np.ndarray, rng: np.random.Generator):
    """Per layer: (host topology, device arrays, values, bias, input hT
    (in_dim, B), a seeded output gradient dz (out_dim, B), All-ReLU's slope
    or None), the activations carried from ``x`` through the plain
    training forward."""
    cfg, dev = model.config, model.device
    hT = torch.as_tensor(np.ascontiguousarray(x.T), device=dev)
    layers = []
    for l in range(cfg.n_layers):
        host = model.topos[l]
        t = host.device_arrays(dev)
        slope = ref.slope_for(cfg.alpha, l + 1) if l < cfg.n_layers - 1 else None
        dz = torch.as_tensor(
            (0.01 * rng.standard_normal((host.out_dim, hT.shape[1]))).astype(np.float32),
            device=dev)
        layers.append((host, t, model.values[l], model.biases[l], hT, dz, slope))
        hT = sparsity.coo_matmul_T_plain(hT, model.values[l], t.rows, t.cols, host.out_dim,
                                         bias=model.biases[l], slope=slope)
    return layers


def _bits_equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_bits_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def thrice(fn, what: str):
    """``fn()`` launched three times on the same inputs: the first result,
    after checking that the other two have its bits."""
    first, again = fn(), [fn(), fn()]
    torch.cuda.synchronize()
    check(all(_bits_equal(first, r) for r in again), f"{what} gave other bits on a later launch")
    return first


def emptied(host: sparsity.ElementTopology) -> sparsity.ElementTopology:
    """``host`` with every third column's connections removed: columns
    whose only run is empty, as importance pruning leaves them."""
    keep = host.cols % 3 != 0
    return sparsity.ElementTopology(host.in_dim, host.out_dim, host.rows[keep], host.cols[keep])


def phase_element_kernels(out: dict) -> str:
    model = seeded_model(CARD)  # nonzero biases: the bias gradient and A's epilogue see them
    x_train = load("cifar10", scale=TRAIN_SCALE).x_train
    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in ("coo_matmul_T.dX", "coo_matmul_T.mask", "coo_dw", "all_relu_bwd")}
    n_checks, n_zero, n_empty = 0, 0, 0

    def compare(name, got, want, what):
        nonlocal n_checks
        torch.testing.assert_close(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda m: f"{what}: {m}")
        err[name] = max(err[name], float((got - want).abs().max()))
        n_checks += 1

    def check_f(hT, dz, t, what, mask=None, slope=None, with_dbias=True):
        """Kernel F with an epilogue against its plain version: dv at the
        tolerance, dz bit-equal (one rounded multiply), dbias (G's sum) at
        the tolerance; each output bit-equal over 3 launches."""
        args = dict(with_dbias=with_dbias, mask=mask, slope=slope)
        got = thrice(lambda: sparsity.coo_dw(hT, dz, t.rows, t.cols, **args), f"kernel F at {what}")
        want = sparsity.coo_dw_plain(hT, dz, t.rows, t.cols, **args)
        compare("coo_dw", got[0], want[0], f"kernel F's dv at {what}")
        check(torch.equal(got[1], want[1]), f"kernel F's dz differs at {what}")
        compare("all_relu_bwd", got[2], want[2], f"kernel F's dbias at {what}")

    for batch in ELEMENT_BATCHES:
        for l, (host, t, v, bias, hT, dz, slope) in enumerate(
                element_layer_inputs(model, x_train[:batch], rng)):
            where = f"layer {l}, batch {batch}"
            # A's dX use: the dual order's registered offsets pick the route
            row_ptr = sparsity.registered_offsets(t.rows_r)
            check(row_ptr is not None, "the dual order's offsets are not registered")
            route = sparsity.coo_route(sparsity._longest_segment(row_ptr, host.nnz, host.in_dim))
            check(route == sparsity.COO_THREAD, f"A's dX takes route {route} at {where}")
            vr = v.index_select(0, t.perm_r)
            dx = thrice(lambda: sparsity.coo_matmul_T(dz, vr, t.cols_r, t.rows_r, host.in_dim),
                        f"kernel A's dX at {where}")
            compare("coo_matmul_T.dX", dx, sparsity.coo_matmul_T_plain(
                dz, vr, t.cols_r, t.rows_r, host.in_dim), f"kernel A's dX at {where}")
            # F with no epilogue (espmm_custom's), and with the bias alone
            # (the output layer's), on the layer and with columns emptied
            host_e = emptied(host)
            t_e = host_e.device_arrays(CARD)
            n_empty += host.out_dim - len(np.unique(host_e.cols))
            for tt, which in ((t, where), (t_e, f"{where}, columns emptied")):
                dv = thrice(lambda: sparsity.coo_dw(hT, dz, tt.rows, tt.cols),
                            f"kernel F at {which}")
                compare("coo_dw", dv, sparsity.coo_dw_plain(hT, dz, tt.rows, tt.cols),
                        f"kernel F at {which}")
                check_f(hT, dz, tt, f"{which}, bias alone")
            # G's standalone call without a mask: F's epilogue alone
            g = thrice(lambda: all_relu_fused.all_relu_bwd(dz, None, None), f"kernel G at {where}")
            want = all_relu_fused.all_relu_bwd_plain(dz, None, None)
            check(torch.equal(g[0], want[0]), f"kernel G's dz is not dy without a mask at {where}")
            compare("all_relu_bwd", g[1], want[1], f"kernel G's dbias at {where}")
            # A's training epilogue, then F with All-ReLU's backward and G's
            # standalone call on its mask, both slope signs; a bias that
            # cancels the product makes v exactly 0 in batch column 0 of
            # every third feature, where the slope branch is taken
            prod = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim)
            bias_z = bias.clone()
            bias_z[::3] = -prod[::3, 0]
            pre = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim, bias=bias_z)
            n_zero += int((pre == 0).sum())
            for layer_index in (1, 2):
                s_l = ref.slope_for(model.config.alpha, layer_index)
                o3, m3 = thrice(lambda: sparsity.coo_matmul_T(
                    hT, v, t.rows, t.cols, host.out_dim, bias=bias_z, slope=s_l, with_mask=True),
                    f"kernel A's training epilogue at {where}")
                o2 = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, host.out_dim, bias=bias_z,
                                           slope=s_l)
                torch.cuda.synchronize()
                check(torch.equal(o3, o2),
                      f"kernel A's training epilogue output is not its All-ReLU epilogue's at "
                      f"{where}, slope {s_l}")
                check(torch.equal(m3.bool(), pre > 0),
                      f"kernel A's mask is not where its bias epilogue is > 0 at {where}")
                compare("coo_matmul_T.mask", o3, sparsity.coo_matmul_T_plain(
                    hT, v, t.rows, t.cols, host.out_dim, bias=bias_z, slope=s_l),
                    f"kernel A's training epilogue at {where}")
                for tt, which in ((t, where), (t_e, f"{where}, columns emptied")):
                    check_f(hT, dz, tt, f"{which}, slope {s_l}", mask=m3, slope=s_l)
                g = thrice(lambda: all_relu_fused.all_relu_bwd(dz, m3, s_l),
                           f"kernel G with a mask at {where}")
                want = all_relu_fused.all_relu_bwd_plain(dz, m3, s_l)
                check(torch.equal(g[0], want[0]), f"kernel G's dz differs at {where}, slope {s_l}")
                compare("all_relu_bwd", g[1], want[1], f"kernel G's dbias at {where}")
    check(n_zero > 0, "no pre-activation was exactly 0")
    check(n_empty > 0, "no column was emptied")
    out["err"].update(err)
    return (
        f"{n_checks} comparisons at dims {model.config.layer_dims}, batch {ELEMENT_BATCHES}: "
        f"kernel "
        f"A's dX (thread route, registered row offsets); F with no epilogue, the bias alone "
        f"and All-ReLU's backward (slopes +-{model.config.alpha}; dz bit-equal), on each layer "
        f"and with {n_empty} columns emptied; G's standalone call with and without a mask; A's "
        f"training epilogue (output bit-equal to the All-ReLU epilogue's, mask = bias "
        f"epilogue > 0, {n_zero} pre-activations exactly 0); each bit-equal over 3 launches; "
        f"max_abs_err A dX {err['coo_matmul_T.dX']:.3g}, F dv {err['coo_dw']:.3g}, dbias "
        f"{err['all_relu_bwd']:.3g}, A training epilogue {err['coo_matmul_T.mask']:.3g} (rtol "
        f"{GRAD_RTOL}, atol {GRAD_ATOL})"
    )


def phase_element_train(out: dict) -> str:
    card, card_topos, phase_s = trainer_for(element_model(CARD))
    reset_counts()
    hist = card.run()
    launches = read_counts()
    cfg = card.model.config
    n_layers = cfg.n_layers
    steps, evals = run_steps(card)
    want = element_launches(cfg, steps, evals)
    check(launches == want, f"launch counts {launches}, expected {want}")
    check(bool(np.isfinite(hist["train_loss"]).all()), f"non-finite loss {hist['train_loss']}")
    per_step = {
        "A forward": (launches["coo_matmul_T.epilogue"] - evals * n_layers) / steps,
        "A forward with mask": launches["coo_matmul_T.mask"] / steps,
        "A dX": (launches["coo_matmul_T"] - launches["coo_matmul_T.epilogue"]) / steps,
        "F": launches["coo_dw"] / steps, "F with epilogue": launches["coo_dw.epilogue"] / steps,
        "F with mask": launches["coo_dw.mask"] / steps,
        "G standalone": launches["all_relu_bwd"] / steps}
    cpu_hist, loss_err = same_run_on_cpu(card, hist, card_topos, element_model("cpu"))
    drop_hist = dropout_run(element_model(CARD, dropout=0.3))
    out.update(element_hist=hist, element_launches=launches, element_phase_s=phase_s)
    print(json.dumps({"element_train_history": {
        "card": hist, "cpu": cpu_hist, "dropout_0.3": drop_hist}}))
    print(json.dumps({"element_launches_per_step": per_step}))
    return (
        f"3 epochs x {steps // TRAIN_EPOCHS} steps of 128 at dims {cfg.layer_dims}, connections "
        f"{[t.nnz for t in card.model.topos]} after pruning; loss {hist['train_loss']}, acc "
        f"{hist['test_acc']}, n_params {hist['n_params']}; card vs CPU: topology and n_params "
        f"equal every epoch, loss rel err {loss_err:.3g} (rtol {TRAIN_LOSS_RTOL}); launches "
        f"{launches}, per step {per_step}; dropout 0.3 loss {drop_hist['train_loss']}"
    )


# -- device SET evolution (the phase between epochs) --------------------------

EVOLVE_ZETA = 0.3  # train_config()'s


def seeded_velocity(model: SparseMLP, rng: np.random.Generator) -> list:
    return [torch.as_tensor((0.01 * rng.standard_normal(tuple(v.shape))).astype(np.float32),
                            device=model.device) for v in model.values]


def without_host_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host sync inside
    it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def with_recorded_draws(fn):
    """``(fn(), draws)``: every evolution draw ``fn`` takes, in order."""
    draws, real = [], topology.evolution_draws

    def recording(*args, **kwargs):
        draws.append(real(*args, **kwargs))
        return draws[-1]

    topology.evolution_draws = recording
    try:
        return fn(), draws
    finally:
        topology.evolution_draws = real


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def equal_slots(got, want, what: str) -> None:
    for name, g, w in zip(("rows", "cols", "values", "momentum", "n_pruned"), got, want):
        g = _np(g) if isinstance(g, torch.Tensor) else g
        check(np.array_equal(g, np.asarray(w)), f"{what}: {name} differs from the numpy version")


def element_invariants(old, rows, cols, mom, n_pruned: int, what: str) -> None:
    """tests/test_device_evolution.py's element invariants: capacity,
    unique positions in range, the canonical order, momentum 0 on grown
    slots, no more grown than pruned; the host mirror takes it."""
    n_in, n_out = old.in_dim, old.out_dim
    check(rows.shape[0] == old.nnz, f"{what}: capacity changed")
    sparsity.ElementTopology(n_in, n_out, rows, cols)  # range and uniqueness
    check(bool((np.diff(cols.astype(np.int64) * n_in + rows) > 0).all()),
          f"{what}: not in the canonical order")
    grown = ~np.isin(rows.astype(np.int64) * n_out + cols,
                     old.rows.astype(np.int64) * n_out + old.cols)
    check(bool((mom[grown] == 0).all()) and grown.sum() <= n_pruned,
          f"{what}: a grown slot kept momentum, or more grew than were pruned")


def block_invariants(old, rows, cols, vals, mom, n_pruned: int, what: str) -> None:
    """The block invariants: capacity, unique, coverage (the host mirror's
    checks), canonical order, grown tiles zero with momentum 0, at most the
    zeta-tail pruned."""
    meta = old.meta
    check(rows.shape[0] == old.n_blocks, f"{what}: capacity changed")
    sparsity.BlockTopology(meta, rows, cols)
    check(bool((np.diff(cols.astype(np.int64) * meta.grid_m + rows) > 0).all()),
          f"{what}: not in the canonical order")
    grown = np.abs(vals).sum(axis=(1, 2)) == 0
    check(mom[grown].sum() == 0 and n_pruned <= int(EVOLVE_ZETA * old.n_blocks),
          f"{what}: a grown tile kept momentum, or more than the zeta-tail was pruned")


def evolution_cost(fn, reps: int = 5) -> dict:
    """One ``fn()`` call's host time (enqueue, median of ``reps``), its time
    to the device's end (median), and its device busy time and device
    launches (torch.profiler over ``reps`` calls)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, launches = 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            busy += e.self_device_time_total / reps
            launches += e.count / reps
    check(launches > 0, "the profiler saw no device launches of the evolution")
    return dict(host_ms=float(np.median(host)) * 1e3, wall_ms=float(np.median(wall)) * 1e3,
                device_us=busy, device_launches=launches)


def plans_bit_equal(model: SparseMLP, new, values, rng: np.random.Generator):
    """Kernels A (the forward with the training epilogue, and dX; thread,
    staged and the default route) and F (modes 0-2) on the arrays device
    evolution made, against the same calls on host-made arrays of the same
    topology: bit-equal. Then F's device time at batch 128 with the
    layer's epilogue on the step (All-ReLU's backward; the output layer's
    bias alone) over the host-made plan and the padded device-made one, in
    turns (host, device, device, host). Returns the number of comparisons
    and the timing rows."""
    cfg, n, rows = model.config, 0, []
    for l, t_dev in enumerate(new):
        n_in, n_out = cfg.layer_dims[l], cfg.layer_dims[l + 1]
        host = sparsity.ElementTopology(n_in, n_out, _np(t_dev.rows), _np(t_dev.cols))
        t_host = host.device_arrays(CARD)
        v = values[l]
        hT = torch.as_tensor(rng.standard_normal((n_in, 128)).astype(np.float32), device=CARD)
        dz = torch.as_tensor((0.01 * rng.standard_normal((n_out, 128))).astype(np.float32),
                             device=CARD)
        bias = torch.as_tensor((0.1 * rng.standard_normal(n_out)).astype(np.float32),
                               device=CARD)
        slope = ref.slope_for(cfg.alpha, l + 1) if l < cfg.n_layers - 1 else None
        both = (t_dev, t_host)
        for route in (sparsity.COO_THREAD, sparsity.COO_STAGED, None):
            fwd = [sparsity._coo_matmul_T_cuda(hT, v, t.rows, t.cols, None, n_out, None, route,
                                               bias=bias, slope=slope,
                                               with_mask=slope is not None) for t in both]
            dx = [sparsity._coo_matmul_T_cuda(dz, v.index_select(0, t.perm_r), t.cols_r,
                                              t.rows_r, None, n_in, None, route) for t in both]
            torch.cuda.synchronize()
            check(_bits_equal(*fwd) and _bits_equal(*dx),
                  f"kernel A on the device-made arrays of layer {l} (route {route}) differs")
            n += 2
        f_args = [dict(), dict(with_dbias=True)]  # F's modes 0 and 1, then 2 on A's mask
        if slope is not None:
            f_args.append(dict(with_dbias=True, mask=fwd[1][1], slope=slope))
        for args in f_args:
            f = [sparsity.coo_dw(hT, dz, t.rows, t.cols, **args) for t in both]
            torch.cuda.synchronize()
            check(_bits_equal(*f), f"kernel F on the device-made plan of layer {l} differs")
            n += 1
        ms = {"host": [], "device": []}
        for which in ("host", "device", "device", "host"):
            t = t_host if which == "host" else t_dev
            ms[which].append(device_ms(lambda: sparsity.coo_dw(hT, dz, t.rows, t.cols,
                                                               **f_args[-1])))
        plan = sparsity.dw_plan(t_dev.rows, t_dev.cols, n_out)
        rows.append(dict(layer=l, batch=128, slot_runs=sparsity.dw_plan(
            t_host.rows, t_host.cols, n_out).n_slot_runs, capacity=plan.n_slot_runs,
            host_plan_ms=ms["host"], device_plan_ms=ms["device"]))
    return n, rows


def phase_evolution(out: dict) -> str:
    """Device SET of the full-width element and block models on the card,
    with seeded values and momentum: held slot for slot to the numpy
    version fed the same draws; the invariants; the device-made offsets
    and F's plan against the host's; A and F on them bit-equal to
    host-made arrays; no host sync; and its cost per layer."""
    rng = np.random.default_rng(SEED)
    emodel, bmodel = element_model(CARD), block_model(CARD)
    ecfg, bcfg = emodel.config, bmodel.config
    metas = [block_meta(bcfg, l) for l in range(bcfg.n_layers)]
    etopo, btopo = emodel.topo_arrays(), bmodel.topo_arrays()
    evel, bvel = seeded_velocity(emodel, rng), seeded_velocity(bmodel, rng)
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    reset_counts()
    (enew, evals, evels, epruned), edraws = with_recorded_draws(lambda: without_host_sync(
        lambda: topology.evolve_element_layers_device(
            etopo, emodel.values, evel, gen, layer_dims=ecfg.layer_dims, zeta=EVOLVE_ZETA,
            init_scheme=ecfg.init)))
    (bnew, bvals, bvels, bpruned), bdraws = with_recorded_draws(lambda: without_host_sync(
        lambda: topology.evolve_block_layers_device(
            btopo, bmodel.values, bvel, gen, metas=metas, zeta=EVOLVE_ZETA)))
    torch.cuda.synchronize()
    check(read_counts() == NO_LAUNCHES, "device SET launched a hand kernel")
    for l, host in enumerate(emodel.topos):
        what = f"element layer {l}"
        cand, init = edraws[l]
        got = (enew[l].rows, enew[l].cols, evals[l], evels[l], epruned[l])
        equal_slots(got, topology.evolve_element_device_reference(
            host.rows, host.cols, _np(emodel.values[l]), _np(evel[l]), _np(cand), _np(init),
            in_dim=host.in_dim, out_dim=host.out_dim, zeta=EVOLVE_ZETA), what)
        rows, cols = _np(enew[l].rows), _np(enew[l].cols)
        element_invariants(host, rows, cols, _np(evels[l]), int(epruned[l]), what)
        made = sparsity.ElementTopology(host.in_dim, host.out_dim, rows, cols)
        check(np.array_equal(_np(sparsity.registered_offsets(enew[l].cols)), made.col_ptr())
              and np.array_equal(_np(sparsity.registered_offsets(enew[l].rows_r)),
                                 made.row_ptr()), f"{what}: device-made offsets differ")
        runs, n_slot = sparsity.dw_runs(rows, made.col_ptr())
        plan = sparsity.dw_plan(enew[l].rows, enew[l].cols, host.out_dim)
        got_runs = _np(plan.runs)
        check(np.array_equal(got_runs[:n_slot], runs[:n_slot])
              and np.array_equal(got_runs[plan.n_slot_runs:], runs[n_slot:])
              and bool((got_runs[n_slot:plan.n_slot_runs] == [-1, 0, 0]).all()),
              f"{what}: F's device plan, padding stripped, is not dw_runs")
    score_err = 0.0
    for l, host in enumerate(bmodel.topos):
        what = f"block layer {l}"
        vals = bmodel.values[l]
        scores = _np(vals.abs().mean(dim=(1, 2)))
        want_scores = np.abs(_np(vals)).mean(axis=(1, 2))
        np.testing.assert_allclose(scores, want_scores, rtol=1e-6)
        score_err = max(score_err, float(np.abs(scores / want_scores - 1).max()))
        got = (bnew[l].rows, bnew[l].cols, bvals[l], bvels[l], bpruned[l])
        equal_slots(got, topology.evolve_block_device_reference(
            host.rows, host.cols, _np(vals), _np(bvel[l]), _np(bdraws[l][0]), meta=metas[l],
            zeta=EVOLVE_ZETA, scores=scores), what)
        block_invariants(host, _np(bnew[l].rows), _np(bnew[l].cols), _np(bvals[l]),
                         _np(bvels[l]), int(bpruned[l]), what)
    n_bits, f_rows = plans_bit_equal(emodel, enew, evals, rng)
    for r in f_rows:
        print(json.dumps({"f_plan_timing": r}))

    costs = []
    for l, t in enumerate(etopo):
        dims = ecfg.layer_dims[l:l + 2]
        costs.append(dict(kind="element", layer=l, slots=emodel.topos[l].nnz, **evolution_cost(
            lambda: topology.evolve_element_layers_device(
                [t], [emodel.values[l]], [evel[l]], gen, layer_dims=dims, zeta=EVOLVE_ZETA,
                init_scheme=ecfg.init))))
    for l, t in enumerate(btopo):
        costs.append(dict(kind="block", layer=l, slots=bmodel.topos[l].n_blocks,
                          **evolution_cost(lambda: topology.evolve_block_layers_device(
                              [t], [bmodel.values[l]], [bvel[l]], gen, metas=[metas[l]],
                              zeta=EVOLVE_ZETA))))
    for c in costs:
        print(json.dumps({"evolution_cost": c}))
    out["evolution_cost"] = costs
    return (
        f"element {ecfg.layer_dims} ({[t.nnz for t in emodel.topos]} connections) and block "
        f"({[t.n_blocks for t in bmodel.topos]} tiles of 128x128) SET on the card, zeta "
        f"{EVOLVE_ZETA}, under set_sync_debug_mode('error'): pruned "
        f"{_np(epruned).tolist()} and {_np(bpruned).tolist()}, equal slot for slot to the numpy "
        f"version on the card's draws; invariants hold; device-made offsets and F's plan "
        f"(padding stripped) equal the host's; {n_bits} A/F calls on the device-made arrays "
        f"bit-equal to host-made ones; block scores within {score_err:.3g} (rtol 1e-6); device "
        f"us per layer element {[round(c['device_us'], 1) for c in costs[:4]]}, block "
        f"{[round(c['device_us'], 1) for c in costs[4:]]}; launches "
        f"{[c['device_launches'] for c in costs]}; host ms "
        f"{[round(c['host_ms'], 3) for c in costs]}; F ms a layer on the host plan "
        f"{[round(min(r['host_plan_ms']), 4) for r in f_rows]}, on the padded device plan "
        f"{[round(min(r['device_plan_ms']), 4) for r in f_rows]}"
    )


def device_evolution_run(model: SparseMLP, host_hist: dict, host_phase_s: list, want_of,
                         what: str) -> tuple:
    """The 3-epoch run of ``model`` with device SET: every device evolution
    under ``set_sync_debug_mode("error")``, the launches of ``want_of``,
    a finite loss, the host mirror's invariants after every epoch (the
    trainer syncs it for the hook), and, after epoch 0 (before pruning
    first fires, one SET apart), ``n_params`` equal to the host-SET run's.
    Returns the history, the topology phase's seconds and the launches."""
    card, topos, phase_s = trainer_for(model, device_evolution=True)
    evolve = card._evolve_device
    card._evolve_device = lambda topo: without_host_sync(lambda: evolve(topo))
    reset_counts()
    hist = card.run()
    launches = read_counts()
    cfg = card.model.config
    want = want_of(cfg, *run_steps(card))
    check(launches == want, f"{what}: launch counts {launches}, expected {want}")
    check(bool(np.isfinite(hist["train_loss"]).all()), f"{what}: non-finite loss")
    check(len(topos) == TRAIN_EPOCHS, f"{what}: an epoch hook did not fire")
    biases = sum(int(b.numel()) for b in card.model.biases)
    for epoch, layers in enumerate(topos):
        for l, (rows, cols) in enumerate(layers):
            # the mirror's constructors check range, uniqueness (and a block
            # model's coverage); the order must already be canonical
            if cfg.impl == "element":
                sparsity.ElementTopology(cfg.layer_dims[l], cfg.layer_dims[l + 1], rows, cols)
                n_rows = cfg.layer_dims[l]
            else:
                n_rows = sparsity.BlockTopology(block_meta(cfg, l), rows, cols).meta.grid_m
            check(bool((np.diff(cols.astype(np.int64) * n_rows + rows) > 0).all()),
                  f"{what}: layer {l} is not in the canonical order after epoch {epoch}")
        if cfg.impl == "element":
            check(hist["n_params"][epoch] == biases + sum(r.shape[0] for r, _ in layers),
                  f"{what}: n_params is not the synced mirror's after epoch {epoch}")
    check(hist["n_params"][0] == host_hist["n_params"][0],
          f"{what}: n_params {hist['n_params'][0]} after epoch 0, host SET's "
          f"{host_hist['n_params'][0]}")
    print(json.dumps({f"{what}_history": {"device_set": hist, "host_set": host_hist,
                                          "topology_phase_s": {"device_set": phase_s,
                                                               "host_set": host_phase_s}}}))
    return hist, phase_s, launches


def phase_element_train_device_evolution(out: dict) -> str:
    hist, phase_s, launches = device_evolution_run(
        element_model(CARD), out["element_hist"], out["element_phase_s"], element_launches,
        "element_train_device_evolution")
    out.update(element_dev_hist=hist, element_dev_phase_s=phase_s)
    return (
        f"3 epochs, device SET after epochs 0 and 1: loss {hist['train_loss']}, acc "
        f"{hist['test_acc']}, n_params {hist['n_params']} (host SET "
        f"{out['element_hist']['n_params']}); launches as the host-SET run's; epoch_seconds "
        f"{hist['epoch_seconds']} (host SET {out['element_hist']['epoch_seconds']}); topology "
        f"phase s {phase_s} (host SET {out['element_phase_s']})"
    )


def phase_block_train_device_evolution(out: dict) -> str:
    hist, phase_s, launches = device_evolution_run(
        block_model(CARD), out["train_hist"], out["train_phase_s"], block_launches,
        "block_train_device_evolution")
    out.update(block_dev_hist=hist, block_dev_phase_s=phase_s)
    return (
        f"3 epochs, device SET after epochs 0 and 1: loss {hist['train_loss']}, acc "
        f"{hist['test_acc']}, n_params {hist['n_params']} (host SET "
        f"{out['train_hist']['n_params']}); launches as the host-SET run's; epoch_seconds "
        f"{hist['epoch_seconds']} (host SET {out['train_hist']['epoch_seconds']}); topology "
        f"phase s {phase_s} (host SET {out['train_phase_s']})"
    )


# -- WASAP-SGD, the paper's parallel training (Algorithm 1) ------------------

# The full-width element model at dropout 0 on 1,000 training samples: 250 a
# worker shard, 7 steps of 32 a worker-epoch, so H = 4 gives 2 rounds a
# phase-1 epoch, the second with one padded step.
WASAP_SCALE = 0.02
WASAP_CONFIG = dict(n_workers=4, phase1_epochs=2, phase2_epochs=1, sync_every=4, batch_size=32,
                    lr=0.01, zeta=0.3, seed=0)


def wasap_trainer(device, **wc) -> WASAPTrainer:
    return WASAPTrainer(element_model(device), load("cifar10", scale=WASAP_SCALE),
                        WASAPConfig(**dict(WASAP_CONFIG, **wc)))


def wasap_run(device, *, fused: bool, mode: str = "wasap", draws=None) -> dict:
    """One WASAP run of the full-width element model on ``device``: its
    history, launches, the topologies its evolutions returned (per layer,
    in order: the master's after each phase-1 epoch, then each worker's
    after each phase-2 epoch), the merged topology, and the draws its device
    evolutions took (``draws`` given: those, in order, on ``device``). On
    the card every device evolution runs under ``set_sync_debug_mode(
    "error")``."""
    trainer = wasap_trainer(device, fused=fused, mode=mode)
    evolved, taken = [], []
    real = (wasap.evolve_element, wasap.evolve_element_layers_device, topology.evolution_draws)

    def host_evolution(*args, **kwargs):
        res = real[0](*args, **kwargs)
        evolved.append((res.topology.rows.copy(), res.topology.cols.copy()))
        return res

    def device_evolution(*args, **kwargs):
        out = (without_host_sync(lambda: real[1](*args, **kwargs)) if device.type == "cuda"
               else real[1](*args, **kwargs))
        evolved.extend((t.rows, t.cols) for t in out[0])  # read after the run
        return out

    def evolution_draws(generator, n, total, **kwargs):
        got = (real[2](generator, n, total, **kwargs) if draws is None
               else tuple(d.to(generator.device) for d in draws[len(taken)]))
        taken.append(got)
        return got

    wasap.evolve_element, wasap.evolve_element_layers_device = host_evolution, device_evolution
    topology.evolution_draws = evolution_draws
    try:
        reset_counts()
        hist = trainer.run()
        launches = read_counts()
    finally:
        wasap.evolve_element, wasap.evolve_element_layers_device, topology.evolution_draws = real
    return dict(hist=hist, launches=launches, trainer=trainer, draws=taken,
                evolved=[tuple(_np(a) if isinstance(a, torch.Tensor) else a for a in t)
                         for t in evolved],
                merged=[(t.rows.copy(), t.cols.copy()) for t in trainer.model.topos])


def wasap_launches(trainer: WASAPTrainer) -> dict:
    """A run's launches: every step of every worker (phase 1's padded ones
    too) is an element step, and the evaluations (after each phase-1 epoch
    and at the end) run A with its epilogue."""
    wc = trainer.wc
    h = 1 if wc.mode == "wassp" else wc.sync_every
    rounds = -(-min(ld.steps_per_epoch for ld in trainer.loaders) // h)
    steps = (wc.phase1_epochs * rounds * h * wc.n_workers
             + wc.phase2_epochs * sum(ld.steps_per_epoch for ld in trainer.loaders))
    evals = (wc.phase1_epochs + 1) * -(-len(trainer.data.x_test) // 512)
    return element_launches(trainer.model.config, steps, evals)


def same_wasap_run(a: dict, b: dict, what: str) -> float:
    """Run ``a`` against run ``b``: every evolution's topology, the merged
    topology and the ``n_params`` history equal; the loss at
    TRAIN_LOSS_RTOL and accuracy within one test sample. Returns the
    largest relative loss difference."""
    wc = a["trainer"].wc
    n_layers = a["trainer"].model.config.n_layers
    want = (wc.phase1_epochs + wc.phase2_epochs * wc.n_workers) * n_layers
    check(len(a["evolved"]) == len(b["evolved"]) == want,
          f"{what}: {len(a['evolved'])} and {len(b['evolved'])} evolutions, expected {want}")
    for i, ((ra, ca), (rb, cb)) in enumerate(zip(a["evolved"], b["evolved"])):
        check(np.array_equal(ra, rb) and np.array_equal(ca, cb),
              f"{what}: the topology of evolution {i} (layer {i % n_layers}) differs")
    for l, ((ra, ca), (rb, cb)) in enumerate(zip(a["merged"], b["merged"])):
        check(np.array_equal(ra, rb) and np.array_equal(ca, cb),
              f"{what}: the merged topology of layer {l} differs")
    ha, hb = a["hist"], b["hist"]
    check(ha["n_params"] == hb["n_params"], f"{what}: n_params {ha['n_params']}, {hb['n_params']}")
    np.testing.assert_allclose(ha["train_loss"], hb["train_loss"], rtol=TRAIN_LOSS_RTOL,
                               equal_nan=True)
    n_test = len(a["trainer"].data.y_test)
    np.testing.assert_allclose(ha["test_acc"], hb["test_acc"], atol=1.0 / n_test + 1e-9,
                               equal_nan=True)
    return max(abs(x - y) / abs(y) for x, y in zip(ha["train_loss"], hb["train_loss"])
               if np.isfinite(y))


def profile_phase1_epoch(trainer: WASAPTrainer) -> dict:
    """A phase-1 epoch of ``trainer``'s model as its fused loop runs it (the
    sync rounds, then the master's device SET), from the model's state: the
    median of 3 host-clock epochs that end in a synchronise, then its
    profile (device busy time, launches and idle share)."""
    model = trainer.model
    x_all, y_all = trainer._data_on_device()
    params, topo = model.params(), model.topo_arrays()
    state = trainer.opt.init(params)
    args = trainer._phase1_inputs(0, 0)

    def one_epoch():
        p, s, _ = trainer._epoch_fn(params, state, topo, x_all, y_all, *args, trainer.key)
        trainer._evolve_device(topo, p, s, trainer.key)

    one_epoch()
    torch.cuda.synchronize()
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_epoch()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    prof = profile_train_step(one_epoch, float(np.median(ts)), steps=2)
    rounds, k, h = args[0].shape[:3]
    return dict(epoch_ms=prof.pop("step_ms"), epoch_ms_runs=ts,
                profiled_epoch_ms=prof.pop("profiled_step_ms"), rounds=rounds, workers=k,
                h=h, real_steps=int(args[2].sum()), **prof)


def phase_wasap(out: dict) -> str:
    """WASAP-SGD of the full-width element model on the card: the round
    loop (host SET) against the same run on the CPU; the fused run (device
    SET under the sync check) against a CPU fused run fed the card's draws;
    a WASSP run; the async parameter server; and a phase-1 epoch's
    profile."""
    loop_card = wasap_run(CARD, fused=False)
    loop_cpu = wasap_run(torch.device("cpu"), fused=False)
    fused_card = wasap_run(CARD, fused=True)
    fused_cpu = wasap_run(torch.device("cpu"), fused=True,
                          draws=[tuple(d.cpu() for d in dr) for dr in fused_card["draws"]])
    wassp = wasap_run(CARD, fused=True, mode="wassp")
    for run, what in ((loop_card, "round loop"), (fused_card, "fused"), (wassp, "wassp")):
        want = wasap_launches(run["trainer"])
        check(run["launches"] == want, f"WASAP {what}: launches {run['launches']}, "
                                       f"expected {want}")
        loss = np.asarray(run["hist"]["train_loss"][:-1])
        check(bool(np.isfinite(loss).all()), f"WASAP {what}: non-finite loss {loss}")
    check(fused_card["trainer"]._fused and not loop_card["trainer"]._fused,
          "the runs did not take the paths asked for")
    check(len(fused_card["draws"]) == len(fused_cpu["draws"]), "the CPU run took other draws")
    loop_err = same_wasap_run(loop_card, loop_cpu, "round loop, card vs CPU")
    fused_err = same_wasap_run(fused_card, fused_cpu, "fused, card vs CPU on its draws")
    n0 = wassp["hist"]["n_params"]
    check(n0[-1] == n0[0], f"wassp: n_params {n0} did not come back to its start")

    # the paper's literal protocol: 3 worker threads on the card, the server on the host
    model = element_model(CARD)
    reset_counts()
    ps = AsyncParameterServer(model, load("cifar10", scale=WASAP_SCALE),
                              AsyncPSConfig(n_workers=3, epochs=1, batch_size=32, lr=0.01,
                                            zeta=0.3, seed=0))
    stats = ps.run()
    ps_launches = read_counts()
    check(stats["updates"] == ps.steps_per_epoch,
          f"the parameter server applied {stats['updates']} updates, not {ps.steps_per_epoch}")
    check(all(bool(torch.isfinite(v).all()) for v in model.values + model.biases),
          "the parameter server's model is not finite")
    check(ps_launches["coo_matmul_T"] > 0 and ps_launches["coo_dw"] > 0,
          f"the parameter server's workers launched no kernel: {ps_launches}")
    ps_acc = evaluate(model, ps.data.x_test, ps.data.y_test)

    def by_phase(hist):
        return {str(p): [s for s, q in zip(hist["epoch_seconds"], hist["phase"]) if q == p]
                for p in (1, 2)}

    runs = dict(round_loop_card=loop_card, round_loop_cpu=loop_cpu, fused_card=fused_card,
                fused_cpu_on_card_draws=fused_cpu, wassp_card=wassp)
    print(json.dumps({"wasap_history": {
        **{k: r["hist"] for k, r in runs.items()},
        "epoch_seconds_by_phase": {k: by_phase(r["hist"]) for k, r in runs.items()},
        "async_ps": {k: v for k, v in stats.items() if k != "history"} | {"test_acc": ps_acc},
    }}))
    prof = profile_phase1_epoch(wasap_trainer(CARD))
    print(json.dumps({"wasap_epoch_profile": prof}))
    hist = fused_card["hist"]
    return (
        f"{WASAP_CONFIG['n_workers']} workers, batch 32, H {WASAP_CONFIG['sync_every']} at dims "
        f"{fused_card['trainer'].model.config.layer_dims}, 2+1 epochs: round loop card vs CPU "
        f"and fused card vs CPU on the card's {len(fused_card['draws'])} draws: every "
        f"evolution's topology, the merged one and n_params equal, loss rel err "
        f"{loop_err:.3g} and {fused_err:.3g} (rtol {TRAIN_LOSS_RTOL}); fused loss "
        f"{hist['train_loss']}, acc {hist['test_acc']}, n_params {hist['n_params']}; launches "
        f"{fused_card['launches']}; wassp loss {wassp['hist']['train_loss']}; async PS "
        f"{stats['updates']} updates, stale entries dropped {stats['stale_entries_dropped']}, "
        f"acc {ps_acc}; phase-1 epoch {prof['epoch_ms']:.1f} ms, device busy "
        f"{prof['device_busy_us']:.0f} us, {prof['device_launches']:g} launches, idle share "
        f"{prof['device_idle_share']:.3f}"
    )


def block_bound(kind: str, meta, host, batch: int) -> dict:
    """The least time for one launch: each input read once (x only at the
    block-rows some tile reads), each output written once; 2 flops per
    multiply-add of the live tiles."""
    nb, bm, bn = host.n_blocks, meta.block_m, meta.block_n
    rows_read = len(np.unique(host.rows))
    w, idx = 4 * nb * bm * bn, 4 * 2 * nb
    x_read = 4 * batch * rows_read * bm
    dy_read = 4 * batch * meta.padded_out  # every block-column is covered
    n_bytes = {
        "bsmm_fwd": x_read + w + idx + 8 * (meta.grid_n + 1) + 4 * batch * meta.padded_out,
        "bsmm_dx": dy_read + w + idx + 8 * (meta.grid_m + 1) + 4 * batch * meta.padded_in,
        "bsmm_dw": x_read + dy_read + idx + w,
    }[kind]
    flops = 2 * batch * nb * bm * bn
    out = bound(n_bytes, flops)
    if kind in ("bsmm_fwd", "bsmm_dw"):  # 3xTF32: three tensor-core products per product
        out["bound_tc_ms"] = max(n_bytes / HBM_BYTES_PER_S, 3 * flops / TF32_TC_FLOPS_PER_S) * 1e3
    return out


def profile_train_step(one_step, step_ms: float, steps: int = 10) -> dict:
    """Where a training step's time goes (torch.profiler over ``steps``
    steps): device busy time by kernel, device launches (kernels and
    copies) per step, the device's idle share of the unprofiled median step
    time, and the host's own time by operator (the twelve largest, with
    their calls per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name: dict = {}
    host: list = []
    launches = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key[:200]] = by_name.get(e.key[:200], 0.0) + e.self_device_time_total / steps
            launches += e.count / steps
        elif e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total / steps, e.count / steps, e.key[:120]))
    busy_us = sum(by_name.values())
    check(busy_us > 0, "the profiler saw no device time")
    host.sort(reverse=True)
    return dict(step_ms=step_ms, profiled_step_ms=profiled_ms, device_busy_us=busy_us,
                device_idle_share=1.0 - busy_us / (step_ms * 1e3), device_launches=launches,
                device_us_by_name=by_name,
                host_self_us_total=sum(h[0] for h in host),
                host_self_us_top=[dict(op=k, us=us, calls=n) for us, n, k in host[:12]])


def time_train_step(model: SparseMLP, data, name: str) -> dict:
    """One training step of ``model`` at batch 128 (forward, backward,
    momentum-SGD update): the median of 30 host-clock steps that end in a
    synchronise, after 5 warm-up steps, with quartiles (``<name>_ms``), then
    its profile (``<name>_profile``), and the allocator's peak over the
    steps, also less what was allocated before them (``step_peak_bytes``:
    the step's own gradients, velocity and temporaries)."""
    dev = model.device
    xb = torch.as_tensor(data.x_train[:128], device=dev)
    yb = torch.as_tensor(data.y_train[:128], device=dev).long()
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    step = make_mlp_train_step(model.config, opt)
    topo = model.topo_arrays()
    lr = torch.tensor(0.01, device=dev)
    state = {"params": model.params(), "opt": opt.init(model.params())}

    def one_step():
        state["params"], state["opt"], _ = step(state["params"], state["opt"], topo, xb, yb,
                                                lr, None)

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    q25, q50, q75 = np.percentile(ts, [25, 50, 75])
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({f"{name}_ms": dict(median=float(q50), q25=float(q25), q75=float(q75),
                                         max_memory_allocated=peak,
                                         step_peak_bytes=peak - resident)}))
    prof = profile_train_step(one_step, float(q50))
    print(json.dumps({f"{name}_profile": prof}))
    return dict(prof, q25=float(q25), q75=float(q75), max_memory_allocated=peak,
                step_peak_bytes=peak - resident)


def element_timing_rows(data) -> list:
    """Per-layer device times at batch 128 of the element step's backward
    kernels, on the full-width element model: kernel A's dX use (not on
    layer 0), F without and with the layer's epilogue (All-ReLU's backward
    with the mask kernel A's training epilogue gives a hidden layer; the
    bias alone on the output layer), and G as that epilogue's cost in F and
    as its standalone call, each beside its bound, its plain version and
    one PyTorch call: ``torch.sparse.mm`` on the dual order's CSR,
    ``sampled_addmm`` on the layer's CSR pattern, ``torch.where`` then
    ``.sum(1)``."""
    model = element_model(CARD)
    rows = []
    rng = np.random.default_rng(SEED)
    for l, (host, t, v, bias, hT, dz, slope) in enumerate(
            element_layer_inputs(model, data.x_train[:128], rng)):
        batch, nnz, n_in, n_out = hT.shape[1], host.nnz, host.in_dim, host.out_dim
        common = dict(layer=l, batch=batch, shape=[n_in, n_out], nnz=nnz)
        row_ptr = sparsity.registered_offsets(t.rows_r)
        vr = v.index_select(0, t.perm_r)
        if l > 0:  # the step needs no gradient of the data
            csr = torch.sparse_csr_tensor(row_ptr, t.cols_r.long(), vr, (n_in, n_out))
            rows.append(dict(
                kernel="coo_matmul_T.dX", **common,
                ms=device_ms(lambda: sparsity.coo_matmul_T(dz, vr, t.cols_r, t.rows_r, n_in)),
                plain_ms=device_ms(lambda: sparsity.coo_matmul_T_plain(
                    dz, vr, t.cols_r, t.rows_r, n_in)),
                library_ms=library_ms(lambda: torch.sparse.mm(csr, dz)),
                **bound(4 * (dz.numel() + 2 * nnz + n_in * batch) + 8 * (n_in + 1),
                        2 * nnz * batch),
            ))
        if slope is None:
            mask = None
            lib = lambda: dz.sum(1)  # noqa: E731
        else:
            _, mask = sparsity.coo_matmul_T(hT, v, t.rows, t.cols, n_out, bias=bias, slope=slope,
                                            with_mask=True)
            keep = mask.bool()
            lib = lambda: torch.where(keep, dz, slope * dz).sum(1)  # noqa: E731
            # the training epilogue's cost: kernel A's forward with the mask
            # store against the served All-ReLU epilogue (not a kernels-line
            # entry: A's forward is kernel A's)
            rows.append(dict(
                kernel="coo_matmul_T.train", **common,
                ms=device_ms(lambda: sparsity.coo_matmul_T(hT, v, t.rows, t.cols, n_out,
                                                           bias=bias, slope=slope,
                                                           with_mask=True)),
                all_relu_epilogue_ms=device_ms(lambda: sparsity.coo_matmul_T(
                    hT, v, t.rows, t.cols, n_out, bias=bias, slope=slope)),
            ))
        epi = dict(with_dbias=True, mask=mask, slope=slope)  # the layer's epilogue in the step
        pattern = torch.sparse_csr_tensor(row_ptr, t.cols_r.long(), torch.zeros_like(vr),
                                          (n_in, n_out))
        dz_bt = dz.T.contiguous()  # sampled_addmm's (B, out_dim) operand, made untimed
        f_ms = device_ms(lambda: sparsity.coo_dw(hT, dz, t.rows, t.cols))
        f_epi_ms = device_ms(lambda: sparsity.coo_dw(hT, dz, t.rows, t.cols, **epi))
        rows.append(dict(
            kernel="coo_dw", **common, ms=f_ms, with_epilogue_ms=f_epi_ms,
            epilogue="All-ReLU's backward" if mask is not None else "bias alone",
            plain_ms=device_ms(lambda: sparsity.coo_dw_plain(hT, dz, t.rows, t.cols)),
            library_ms=library_ms(lambda: torch.sparse.sampled_addmm(pattern, hT, dz_bt, beta=0.0)),
            **bound(4 * (hT.numel() + dz.numel() + 3 * nnz), 2 * nnz * batch),
        ))
        # G's work: its cost inside F (F with the epilogue less F alone),
        # bound by what the epilogue adds to F's traffic (the mask read, dz
        # and dbias written) and its operations; beside it the standalone
        # call, bound by its own traffic (dy read, mask read, dz written
        # with a mask, dbias written)
        n = dz.numel()
        masked = mask is not None
        rows.append(dict(
            kernel="all_relu_bwd", **common, mask=masked, ms=f_epi_ms - f_ms,
            plain_ms=device_ms(lambda: sparsity.coo_dw_epilogue(dz, mask, slope)),
            library_ms=library_ms(lib),
            standalone_ms=device_ms(lambda: all_relu_fused.all_relu_bwd(dz, mask, slope)),
            standalone_bound_ms=bound(4 * n + 4 * n_out + (5 * n if masked else 0),
                                      (2 if masked else 1) * n)["bound_ms"],
            **bound(4 * n_out + (5 * n if masked else 0), (2 if masked else 1) * n),
        ))
    return rows


def phase_train_timings(out: dict) -> str:
    model = block_model(CARD)
    data = load("cifar10", scale=TRAIN_SCALE)
    prof = time_train_step(model, data, "train_step")
    eprof = time_train_step(element_model(CARD), data, "element_train_step")
    out["step_timing"] = {"block": prof, "element": eprof}
    print(json.dumps({"epoch_seconds": out["train_hist"]["epoch_seconds"],
                      "element_epoch_seconds": out["element_hist"]["epoch_seconds"]}))

    rows = []
    rng = np.random.default_rng(SEED)
    for l, (meta, host, t, v, x, dy) in enumerate(
            block_layer_inputs(model, data.x_train[:128], rng)):
        batch = x.shape[0]
        dense = ref.blocks_to_dense(v, t.rows, t.cols, meta.grid_m, meta.grid_n)
        xg = x.reshape(batch, meta.grid_m, meta.block_m)[:, t.rows.long()].permute(1, 2, 0)
        dyg = dy.reshape(batch, meta.grid_n, meta.block_n)[:, t.cols.long()].transpose(0, 1)
        xg, dyg = xg.contiguous(), dyg.contiguous()
        common = dict(layer=l, batch=batch, shape=[meta.in_dim, meta.out_dim],
                      block=[meta.block_m, meta.block_n], n_blocks=host.n_blocks)
        rows.append(dict(
            kernel="bsmm_fwd", **common,
            ms=device_ms(lambda: bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                              grid_n=meta.grid_n)),
            plain_ms=device_ms(lambda: bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                                          grid_n=meta.grid_n)),
            library_ms=library_ms(lambda: torch.matmul(x, dense)),
            **block_bound("bsmm_fwd", meta, host, batch),
        ))
        if l > 0:  # the step needs no gradient of the data
            rows.append(dict(
                kernel="bsmm_dx", **common,
                ms=device_ms(lambda: bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row,
                                                 t.perm_r, grid_m=meta.grid_m)),
                plain_ms=device_ms(lambda: bsm.bsmm_dx_plain(
                    dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=meta.grid_m)),
                library_ms=library_ms(lambda: torch.matmul(dy, dense.t())),
                **block_bound("bsmm_dx", meta, host, batch),
            ))
        rows.append(dict(
            kernel="bsmm_dw", **common,
            ms=device_ms(lambda: bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                             block_n=meta.block_n)),
            plain_ms=device_ms(lambda: bsm.bsmm_dw_plain(x, dy, t.rows, t.cols,
                                                         block_m=meta.block_m,
                                                         block_n=meta.block_n)),
            # the tiles gathered beforehand: the gather is not timed
            library_ms=library_ms(lambda: torch.bmm(xg, dyg)),
            **block_bound("bsmm_dw", meta, host, batch),
        ))
    rows += element_timing_rows(data)
    for r in rows:
        print(json.dumps({"kernel_timing": r}))
    el = out["element_launches"]
    # G runs in F's epilogue: its launches are F's with an epilogue, and its
    # standalone call (all_relu_bwd) launches no time on the path
    element_launches = {"coo_matmul_T.dX": el["coo_matmul_T"] - el["coo_matmul_T.epilogue"],
                        "coo_dw": el["coo_dw"], "all_relu_bwd": el["coo_dw.epilogue"]}
    for meta, launches in ((KERNEL_C, out["train_launches"]["bsmm_fwd"]),
                           (KERNEL_D, out["train_launches"]["bsmm_dx"]),
                           (KERNEL_E, out["train_launches"]["bsmm_dw"]),
                           *((m, element_launches[m["name"]])
                             for m in (KERNEL_A_DX, KERNEL_F, KERNEL_G))):
        # one training step: the sum over its launches
        mine = [r for r in rows if r["kernel"] == meta["name"]]
        extra = {k: sum(r[k] for r in mine) for k in ("with_epilogue_ms", "standalone_ms",
                                                      "standalone_bound_ms") if k in mine[0]}
        if meta is KERNEL_G:
            extra.update(epilogue_launches=el["coo_dw.epilogue"],
                         standalone_launches=el["all_relu_bwd"])
        out["kernels"].append(dict(kernel_entry(meta, mine, launches, out["err"][meta["name"]]),
                                   **extra))

    def step_line(p):
        return (f"median {p['step_ms']:.3f} ms (q25 {p['q25']:.3f}, q75 {p['q75']:.3f}), "
                f"device busy {p['device_busy_us']:.1f} us, {p['device_launches']:g} launches, "
                f"idle share {p['device_idle_share']:.3f}")

    return (
        f"block step {step_line(prof)}; element step {step_line(eprof)}; epoch_seconds block "
        f"{out['train_hist']['epoch_seconds']}, element {out['element_hist']['epoch_seconds']}; "
        f"per-kernel rows above"
    )


# -- the paper's baselines: the masked and the dense SET-MLP -----------------

BASELINES = ("masked", "dense")
# The full-width CIFAR-10 model's n_params: the masked model counts its
# mask's connections (the element model's ER counts, 381,440) and the
# biases (9,010), the dense model every weight and the biases.
BASELINE_N_PARAMS = {"masked": 390_450, "dense": 20_337_010}
# torch.matmul on the card against the CPU's, both IEEE f32: other sum
# orders over up to 4,000 products an output
BASELINE_RTOL = BASELINE_ATOL = 1e-5
# The dense run against the CPU run: at the paper's lr the dense model's
# loss swings (45, 54, then 15: its logits reach tens), so the sum orders'
# last-bit differences grow from epoch to epoch: card against CPU 0,
# 1.7e-6 and 3.7e-4 relative over the 3 epochs, the CPU at 8 threads
# against 2 threads 3.3e-5 (NVIDIA H100 80GB HBM3, 700.00 W). It is held
# at 2e-3 and its test accuracy within 3 of the 200 test samples; the
# masked run keeps the block and element runs' TRAIN_LOSS_RTOL and one
# sample.
DENSE_LOSS_RTOL = 2e-3
DENSE_ACC_SAMPLES = 3


def baseline_model(impl: str, device) -> SparseMLP:
    """The full-width CIFAR-10 SET-MLP as the paper's masked or dense
    baseline, seeded, dropout 0."""
    return SparseMLP(dataclasses.replace(mlp_config("cifar10", impl=impl), dropout=0.0),
                     seed=SEED, device=device)


def baseline_forward_vs_cpu(impl: str, x: np.ndarray) -> float:
    """The forward on the card (infer and evaluation) against the CPU's plain
    forward on the same weights, within BASELINE_RTOL; the largest
    |difference|."""
    card, cpu = baseline_model(impl, CARD), baseline_model(impl, "cpu")
    err = 0.0
    with torch.no_grad():
        for infer in (True, False):
            got = mlp_forward(card.params(), card.topo_arrays(), torch.as_tensor(x, device=CARD),
                              card.config, infer=infer).cpu()
            want = mlp_forward(cpu.params(), cpu.topo_arrays(), torch.as_tensor(x), cpu.config,
                               infer=infer)
            torch.testing.assert_close(got, want, rtol=BASELINE_RTOL, atol=BASELINE_ATOL)
            err = max(err, float((got - want).abs().max()))
    return err


def baseline_run(impl: str, device) -> tuple:
    """The ``train`` phase's 3-epoch run (``train_config()``: SET and
    importance pruning scheduled, which a masked or dense model skips) of
    the baseline on ``device``: the trainer and its history."""
    trainer = SequentialTrainer(baseline_model(impl, device),
                                load("cifar10", scale=TRAIN_SCALE), train_config())
    return trainer, trainer.run()


def phase_baselines(out: dict) -> str:
    data = load("cifar10", scale=TRAIN_SCALE)
    res = {}
    for impl in BASELINES:
        err = baseline_forward_vs_cpu(impl, data.x_test[:128])
        reset_counts()
        card, hist = baseline_run(impl, CARD)
        launches = read_counts()
        cfg = card.model.config
        steps, evals = run_steps(card)
        # torch.matmul in every product; kernel B on the hidden layers of
        # each evaluation batch (autograd off), nothing else
        want = dict(NO_LAUNCHES, bias_all_relu=evals * (cfg.n_layers - 1))
        check(launches == want, f"{impl}: launch counts {launches}, expected {want}")
        n_params = card.model.n_params
        check(n_params == BASELINE_N_PARAMS[impl],
              f"{impl}: n_params {n_params}, expected {BASELINE_N_PARAMS[impl]}")
        check(hist["n_params"] == [n_params] * TRAIN_EPOCHS, f"{impl}: n_params {hist['n_params']}")
        check(bool(np.isfinite(hist["train_loss"]).all())
              and hist["train_loss"][-1] < hist["train_loss"][0],
              f"{impl}: loss {hist['train_loss']} is not finite and falling")
        if impl == "masked":  # no topology phase: the mask is the seed's
            seeded = baseline_model(impl, "cpu")
            check(all(np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols)
                      for a, b in zip(card.model.topos, seeded.topos)), "the mask moved")
        _, cpu_hist = baseline_run(impl, "cpu")
        dense = impl == "dense"
        np.testing.assert_allclose(hist["train_loss"], cpu_hist["train_loss"],
                                   rtol=DENSE_LOSS_RTOL if dense else TRAIN_LOSS_RTOL)
        np.testing.assert_allclose(hist["test_acc"], cpu_hist["test_acc"],
                                   atol=(DENSE_ACC_SAMPLES if dense else 1) / len(data.y_test)
                                   + 1e-9)
        step = time_train_step(baseline_model(impl, CARD), data, f"{impl}_train_step")
        engine = SparseInferenceEngine(baseline_model(impl, CARD), compact=False)
        reset_counts()
        logits = engine.classify(data.x_test[:128])
        served = read_counts()
        check(served == dict(NO_LAUNCHES, bias_all_relu=cfg.n_layers - 1),
              f"{impl}: a classify launched {served}")
        check(bool(np.isfinite(logits).all()), f"{impl}: non-finite served logits")
        res[impl] = dict(n_params=n_params, history=hist, cpu_history=cpu_hist,
                         forward_max_abs_err=err, launches=launches, step=step,
                         classify_ms=classify_latency(engine, data.x_test))
        del card, engine
    # the truly sparse paths of the same run: the element model served
    # uncompacted too (phase main's engine is compacted)
    element_engine = SparseInferenceEngine(seeded_model(CARD), compact=False)
    res["element"] = dict(n_params=element_model(CARD).n_params, step=out["step_timing"]["element"],
                          classify_ms=out["classify_ms"],
                          uncompacted_classify_ms=classify_latency(element_engine, data.x_test))
    # the block model served as it is: kernel C f32 a layer, then B on the hidden ones
    block_engine = SparseInferenceEngine(block_model(CARD), compact=False)
    reset_counts()
    logits = block_engine.classify(data.x_test[:128])
    served = read_counts()
    n_layers = block_engine.model.config.n_layers
    check(served == dict(NO_LAUNCHES, bsmm_fwd=n_layers, bias_all_relu=n_layers - 1),
          f"block: a classify launched {served}")
    want = SparseInferenceEngine(block_model("cpu"), compact=False, device="cpu").classify(
        data.x_test[:128])
    np.testing.assert_allclose(logits, want, rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    res["block"] = dict(n_params=block_model(CARD).n_params, step=out["step_timing"]["block"],
                        served_max_abs_err=float(np.abs(logits - want).max()),
                        classify_ms=classify_latency(block_engine, data.x_test))
    step_keys = ("step_ms", "q25", "q75", "device_busy_us", "device_idle_share",
                 "device_launches", "max_memory_allocated", "step_peak_bytes")
    print(json.dumps({"baselines": dict(card=out["smi"], **{
        k: dict({f: v for f, v in r.items() if f != "step"},
                step={f: r["step"][f] for f in step_keys}) for k, r in res.items()})}))

    def line(k):
        st = res[k]["step"]
        return (f"{k} {res[k]['n_params']} params, step {st['step_ms']:.3f} ms (busy "
                f"{st['device_busy_us']:.1f} us, idle {st['device_idle_share']:.3f}, "
                f"{st['device_launches']:g} launches, peak +{st['step_peak_bytes'] / 1e6:.1f} MB)")

    cls = {k: res[k]["classify_ms"][128]["median"] for k in ("element", "block", *BASELINES)}
    return (
        "; ".join(line(k) for k in ("element", "block", *BASELINES))
        + f"; masked and dense forward card vs CPU within {BASELINE_RTOL} (max "
        + ", ".join(f"{res[k]['forward_max_abs_err']:.3g}" for k in BASELINES)
        + "), histories card vs CPU held, loss " + ", ".join(
            f"{k} {res[k]['history']['train_loss']}" for k in BASELINES)
        + "; classify at 128 " + ", ".join(f"{k} {v:.3f} ms" for k, v in cls.items())
    )


# -- checkpoints and resume ----------------------------------------------------

TRAJ = ("epoch", "train_loss", "test_acc", "n_params")


def same_history(got: dict, want: dict, what: str) -> None:
    """Bit-equal histories, NaN equal to NaN (WASAP's phase 2 does not
    evaluate)."""
    for key in TRAJ:
        check(np.array_equal(np.asarray(got[key], float), np.asarray(want[key], float),
                             equal_nan=True), f"{what}: {key} {got[key]}, expected {want[key]}")
    check(got.get("phase") == want.get("phase"), f"{what}: phases differ")


def same_model(a: SparseMLP, b: SparseMLP, what: str) -> None:
    for l, (x, y) in enumerate(zip(a.values + a.biases, b.values + b.biases)):
        check(x.device == y.device and torch.equal(x, y), f"{what}: tensor {l} differs")
    for l, (s, t) in enumerate(zip(a.topos, b.topos)):
        check(np.array_equal(s.rows, t.rows) and np.array_equal(s.cols, t.cols),
              f"{what}: the topology of layer {l} differs")


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def resumed_training(root: Path, model_of, wrappers: tuple, what: str) -> dict:
    """The 3-epoch run of ``model_of(CARD)`` with device SET and pruning at
    the paper's dropout, saved at every epoch (each save timed: the
    snapshot, which ``save`` takes before it returns, then the write, which
    ``wait`` joins); then a fresh trainer restored from the epoch-0
    checkpoint (timed) runs on: its history and final state bit-equal to the
    run that never stopped, and each of ``wrappers`` launched in it."""
    mgr = CheckpointManager(str(root / what), keep_last=TRAIN_EPOCHS)
    tc = train_config(device_evolution=True)
    live = SequentialTrainer(model_of(CARD), load("cifar10", scale=TRAIN_SCALE), tc)
    saves = []

    def save(tr, epoch):
        t0 = time.perf_counter()
        tr.save_checkpoint(mgr)
        t1 = time.perf_counter()
        mgr.wait()
        saves.append(dict(snapshot_s=t1 - t0, write_s=time.perf_counter() - t1))

    live.epoch_end_hook = save
    hist = live.run()
    steps = mgr.all_steps()
    check(len(steps) == TRAIN_EPOCHS, f"{what}: {len(steps)} checkpoints, not {TRAIN_EPOCHS}")
    resumed = SequentialTrainer(model_of(CARD), live.data, tc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.restore_checkpoint(mgr, steps[0])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    reset_counts()
    got = resumed.run()
    launches = read_counts()
    for w in wrappers:
        check(launches[w] > 0, f"{what}: the resumed run launched no {w}: {launches}")
    same_history(got, hist, what)
    same_model(resumed.model, live.model, what)
    return dict(history=hist, steps=steps, launches=launches, saves=saves,
                restore_s=restore_s, bytes=[dir_bytes(mgr.dir / f"step_{s:09d}") for s in steps])


def resumed_wasap(root: Path) -> dict:
    """WASAP of the full-width element model (the ``wasap`` phase's
    configuration with 2 phase-2 epochs), saved at every epoch boundary;
    fresh trainers resumed at a phase-1 boundary (after epoch 0) and at a
    phase-2 boundary (after epoch 2) run on to the same history and merged
    model, bit for bit, launching kernels A and F."""
    mgr = CheckpointManager(str(root / "wasap"), keep_last=4)
    config = dict(phase2_epochs=2)
    live = wasap_trainer(CARD, **config)
    live.epoch_end_hook = lambda tr, epoch: tr.save_checkpoint(mgr)
    hist = live.run()
    mgr.wait()
    check(mgr.all_steps() == [1, 2, 3, 4], f"WASAP checkpoints {mgr.all_steps()}")
    res = {}
    for step, phase in ((1, 1), (3, 2)):
        check(mgr.read_manifest(step)["meta"]["resume"]["phase"] == phase,
              f"WASAP step {step} is not a phase-{phase} checkpoint")
        resumed = wasap_trainer(CARD, **config)
        resumed.restore_checkpoint(mgr, step)
        reset_counts()
        got = resumed.run()
        launches = read_counts()
        check(launches["coo_matmul_T"] > 0 and launches["coo_dw"] > 0,
              f"WASAP resumed at step {step} launched no A or F: {launches}")
        same_history(got, hist, f"WASAP resumed at step {step}")
        same_model(resumed.model, live.model, f"WASAP resumed at step {step}")
        res[f"phase{phase}_step{step}"] = launches
    return dict(history=hist, launches=res)


def served_from_checkpoint(root: Path, out: dict) -> dict:
    """The seeded serving model saved, restored on the card (compacted as
    phase ``main``'s engine is) and served at its sizes, bit-equal to the
    live engine, on kernel A; then served on the CPU from the same
    checkpoint within rtol 1e-5."""
    mgr = CheckpointManager(str(root / "serve"), async_write=False)
    t0 = time.perf_counter()
    save_mlp_for_serving(mgr, out["model"], step=0)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = SparseInferenceEngine.from_checkpoint(mgr, compaction=SCHEDULE)
    restore_s = time.perf_counter() - t0
    check(engine.report == out["engine"].report, "the restored model compacted otherwise")
    reqs = {n: requests(out["x_test"], n) for n in SIZES}
    reset_counts()
    logits = {n: engine.classify(reqs[n]) for n in SIZES}
    launches = read_counts()
    check(launches == out["launches"], f"served from the checkpoint: launches {launches}, "
                                       f"the live engine's {out['launches']}")
    for n in SIZES:
        check(np.array_equal(logits[n], out["engine"].classify(reqs[n])),
              f"served from the checkpoint: logits differ from the live engine's at n={n}")
    sizes = engine.jit_entry_sizes()
    check(set(sizes.values()) == {1}, f"jit_entry_sizes {sizes}")
    cpu = SparseInferenceEngine.from_checkpoint(mgr, compaction=SCHEDULE, device="cpu")
    err = 0.0
    for n in SIZES:
        want = cpu.classify(reqs[n])
        np.testing.assert_allclose(logits[n], want, rtol=RTOL, atol=ATOL)
        err = max(err, float(np.abs(logits[n] - want).max()))
    return dict(launches=launches, jit_entry_sizes={str(k): v for k, v in sizes.items()},
                cpu_max_abs_err=err, save_s=save_s, restore_s=restore_s,
                bytes=dir_bytes(mgr.dir / "step_000000000"))


def phase_checkpoint(out: dict) -> str:
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        root = Path(tmp)
        element = resumed_training(
            root, lambda dev: element_model(dev, dropout=0.3), ("coo_matmul_T", "coo_dw"),
            "element")
        block = resumed_training(
            root, lambda dev: block_model(dev, dropout=0.3), ("bsmm_fwd", "bsmm_dx", "bsmm_dw"),
            "block")
        was = resumed_wasap(root)
        served = served_from_checkpoint(root, out)
    io = {what: {k: r[k] for k in ("steps", "bytes", "saves", "restore_s")}
          for what, r in (("element", element), ("block", block))}
    io["serving"] = {k: served[k] for k in ("bytes", "save_s", "restore_s")}
    print(json.dumps({"checkpoint_io": dict(io, card=out["smi"])}))
    print(json.dumps({"checkpoint_history": {
        "element": element["history"], "block": block["history"], "wasap": was["history"],
        "launches": {"element": element["launches"], "block": block["launches"],
                     "wasap": was["launches"], "served": served["launches"]}}}))
    return (
        f"element and block, 3 epochs (device SET, pruning, dropout 0.3) resumed after epoch 0: "
        f"history and final state bit-equal (element n_params {element['history']['n_params']}, "
        f"block {block['history']['n_params']}; A {element['launches']['coo_matmul_T']}, F "
        f"{element['launches']['coo_dw']}; C {block['launches']['bsmm_fwd']}, D "
        f"{block['launches']['bsmm_dx']}, E {block['launches']['bsmm_dw']} launches); WASAP "
        f"resumed at a phase-1 and a phase-2 boundary bit-equal; served from a checkpoint "
        f"bit-equal to the live engine (A {served['launches']['coo_matmul_T']} launches, "
        f"jit_entry_sizes {served['jit_entry_sizes']}), on the CPU within "
        f"{served['cpu_max_abs_err']:.3g}; bytes element {element['bytes'][0]}, block "
        f"{block['bytes'][0]}"
    )


# -- the bfloat16 LM: Qwen1.5-0.5B with the paper's sparse FFN, served ---------

# Qwen1.5-0.5B at full width and depth (configs/qwen15_05b.py) with the
# paper's SET sparse FFN at the reference's defaults (128 x 128 tiles,
# epsilon 64, All-ReLU alpha 0.6), bf16, random weights from the seed: the
# reference's serving demo's model (examples/serve.py) at its published size.
LM_ARCH = "qwen1.5-0.5b"
LM_ENGINE = dict(max_slots=8, max_len=256, prefill_buckets=(16, 32, 64), prefill_batch=4)
LM_TRACE = dict(rate=20.0, prompt_lens=(4, 64), new_tokens=(8, 32))
LM_REQUESTS = 16
LM_CPU_LAYERS = 2  # the card against the CPU: full width, depth cut to 2 layers
# The rows the main path gives the sparse FFN's kernels: a decode step's
# max_slots, and a prefill's prefill_batch prompts at each bucket.
LM_PATH_ROWS = tuple(sorted({LM_ENGINE["max_slots"]} | {
    LM_ENGINE["prefill_batch"] * b for b in LM_ENGINE["prefill_buckets"]}))
# Logits of two bf16 computations (kernels against plain versions, decode
# against the teacher-forced forward) are held elementwise at
# LM_LOGIT_ATOL + LM_LOGIT_RTOL x |want|. The logits are bf16 (one ulp is
# 2**-8 of a value, 0.031 at the measured scale of 5), and the measured
# maxima on the H100 were 0.031 (2 layers, card against CPU) and 0.035 (decode
# against teacher-forced, 24 layers): the atol is about three times those;
# the rtol is the reference's bf16 tolerance. A row whose top-2 margin
# exceeds LM_LOGIT_ATOL must keep its argmax.
LM_LOGIT_ATOL = 0.1
LM_LOGIT_RTOL = 5e-2
C_BF16_TOL = 1e-2  # kernel C bf16 vs its plain version: one rounding each, other sum orders
C_ORACLE_TOL = 5e-2  # against ref.bsmm_ref: the reference's bf16 tolerance
# The H100 SXM's dense bf16 tensor-core rate (NVIDIA data sheet): kernel C's
# bf16 instance runs on the tensor cores.
BF16_TC_FLOPS_PER_S = 989e12
KERNEL_C_BF16 = dict(
    name="bsmm_fwd.bf16", route="cuda", source="src/repro_torch/csrc/bsmm_fwd.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:64",
)
KERNEL_B_BF16 = dict(
    name="bias_all_relu.bf16", route="cuda", source="src/repro_torch/csrc/bias_all_relu.cu",
    replaces="src/repro/kernels/all_relu_fused.py:23",
)
# The rows kernel_timing times C bf16 at: 1 row and the main path's
LM_TIMED_ROWS = (1,) + LM_PATH_ROWS
# C bf16 on W_in's grid with every block-column holding L slots: columns
# longer than the routes' rings (4 slot stages; 3 on the rows route's 64 x
# 64 tile), at rows that take the decode route (one and two x-fragments) and
# both rows tiles (32 x 32 at 64 rows, 64 x 64 at 256)
LONG_COLUMNS = (4, 5, 8)
LONG_COLUMN_ROWS = (8, 16, 64, 256)
# kernel C's counts of second passes, All-ReLU stores and launches by route
C_SUB = ("second_pass", "epilogue", "decode", "rows")


def lm_config(n_layers=None) -> ModelConfig:
    cfg = dataclasses.replace(get_spec(LM_ARCH).config, ffn="sparse")
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def bound_bf16(n_bytes: float, n_flops: float) -> dict:
    """The least time for a bf16 tensor-core product: bytes over HBM
    bandwidth or its operations over the dense bf16 tensor rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / BF16_TC_FLOPS_PER_S * 1e3
    return dict(bytes=n_bytes, ops=n_flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bf16_block_case(meta, topo, rows: int, rng: np.random.Generator):
    values = topo.init_values(rng, dtype=torch.bfloat16, device=CARD)
    x = torch.as_tensor(rng.standard_normal((rows, meta.padded_in)).astype(np.float32),
                        device=CARD).to(torch.bfloat16)
    return topo.device_arrays(CARD), values, x


def long_columns(meta, length: int, rng: np.random.Generator):
    """A topology whose every block-column holds ``length`` slots, on block-rows
    drawn without replacement."""
    rows = np.concatenate([np.sort(rng.choice(meta.grid_m, length, replace=False))
                           for _ in range(meta.grid_n)])
    return sparsity.BlockTopology(meta, rows, np.repeat(np.arange(meta.grid_n), length))


def lm_kernel_cases():
    """Kernel C's bf16 cases: the reference's sweep (tests/test_kernels.py:32,
    seed 0), then the served model's sparse FFN at full width (seed 0's
    first layer: W_in 1024 -> 2816 over 22 tiles, W_out 2816 -> 1024 over 15)
    at 1 row and at every row count of the main path (LM_PATH_ROWS), then
    W_in's grid with columns of LONG_COLUMNS slots at LONG_COLUMN_ROWS."""
    cases = []
    for B, gm, gn, bm, bn, density in ((8, 2, 3, 8, 16, 0.7), (16, 4, 4, 16, 16, 0.4),
                                       (32, 3, 5, 8, 8, 0.9), (8, 1, 2, 16, 8, 1.0),
                                       (24, 5, 2, 8, 16, 0.5)):
        rng = np.random.default_rng(0)
        meta = sparsity.BlockMeta(gm * bm, gn * bn, bm, bn)
        topo = sparsity.BlockTopology.erdos_renyi(meta, density, rng)
        cases.append((f"sweep B{B} {gm}x{gn} {bm}x{bn}", meta, topo) + bf16_block_case(
            meta, topo, B, rng))
    cfg = lm_config()
    rng = np.random.default_rng(SEED)
    topos = {}
    for name, (n_in, n_out) in (("win", (cfg.d_model, cfg.d_ff)), ("wout", (cfg.d_ff, cfg.d_model))):
        meta = sparsity.BlockMeta(n_in, n_out, cfg.sparse_block, cfg.sparse_block)
        topos[name] = (meta, sparsity.BlockTopology.from_epsilon(meta, cfg.sparse_epsilon, rng))
    check((topos["win"][1].n_blocks, topos["wout"][1].n_blocks) == (22, 15),
          "the full-width sparse FFN's tile counts")
    for name, (meta, topo) in topos.items():
        for rows in (1,) + LM_PATH_ROWS:
            cases.append((f"{name} {rows} rows", meta, topo) + bf16_block_case(
                meta, topo, rows, rng))
    meta = topos["win"][0]
    for length in LONG_COLUMNS:
        topo = long_columns(meta, length, rng)
        for rows in LONG_COLUMN_ROWS:
            cases.append((f"columns of {length} {rows} rows", meta, topo) + bf16_block_case(
                meta, topo, rows, rng))
    return cases


def lm_kernel_checks() -> dict:
    """Kernel C's bf16 instance against its plain version and ref.bsmm_ref,
    the same bits on three launches, on the route ``fwd_plan`` gives (its
    counters show the route taken and no second pass on the served shapes);
    its All-ReLU store bit-equal to C followed by kernel B's bf16 entry, both
    parities; on the decode route, the first and last rows of a call the
    same alone. Kernel B's bf16 entry bit-equal to its plain version at every
    row count of the main path, both parities, with and without a bias.
    Each kernel's largest |difference| from its plain version, measured, and
    the route each case took."""
    err_c = err_b = 0.0
    routes = {}
    cfg = lm_config()
    for what, meta, topo, t, v, x in lm_kernel_cases():
        def c(**kw):
            return bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n, **kw)

        plan = bsm.fwd_plan(topo.n_blocks, meta.grid_n, x.shape[0], meta.block_m, meta.block_n,
                            bf16=True)
        before = c_sub_counts()
        y = thrice(c, f"kernel C bf16 ({what})")
        taken = {k: n - before[k] for k, n in c_sub_counts().items()}
        check(taken == dict(second_pass=3 * (plan.parts > 1), epilogue=0,
                            decode=3 * (plan.route == "decode"),
                            rows=3 * (plan.route == "rows")),
              f"kernel C bf16 ({what}) counted {taken} on three launches of {plan}")
        if not what.startswith("sweep"):
            check(plan.route in ("decode", "rows") and plan.parts == 1,
                  f"kernel C bf16 ({what}) planned {plan}")
        routes[what] = plan.route
        check(y.dtype == torch.bfloat16, f"kernel C bf16 ({what}) gave {y.dtype}")
        want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n)
        oracle = ref.bsmm_ref(x.float(), v.float(), t.rows, t.cols, grid_m=meta.grid_m,
                              grid_n=meta.grid_n)
        torch.testing.assert_close(y.float(), want.float(), rtol=C_BF16_TOL, atol=C_BF16_TOL)
        torch.testing.assert_close(y.float(), oracle, rtol=C_ORACLE_TOL, atol=C_ORACLE_TOL)
        err_c = max(err_c, float((y.float() - want.float()).abs().max()))
        for layer_index in (1, 2):
            fused = thrice(lambda: c(all_relu=(cfg.sparse_alpha, layer_index)),
                           f"kernel C bf16 with All-ReLU ({what})")
            after = all_relu_fused.bias_all_relu(y, None, alpha=cfg.sparse_alpha,
                                                 layer_index=layer_index)
            check(_bits_equal(fused, after), f"kernel C bf16's All-ReLU store ({what}, layer "
                                             f"{layer_index}) is not C then B bit for bit")
        if plan.route == "decode" and x.shape[0] > 1:
            for r in (0, x.shape[0] - 1):
                alone = bsm.bsmm_fwd(x[r:r + 1].clone(), v, t.rows, t.cols, t.first_col,
                                     grid_n=meta.grid_n)
                check(_bits_equal(alone[0], y[r]), f"kernel C bf16 ({what}): row {r} alone "
                                                   f"is not row {r} within the call")
    rng = np.random.default_rng(SEED)
    for rows in LM_PATH_ROWS:
        x = torch.as_tensor(rng.standard_normal((rows, cfg.d_ff)).astype(np.float32) * 3,
                            device=CARD).to(torch.bfloat16)
        b = torch.as_tensor(rng.standard_normal(cfg.d_ff).astype(np.float32),
                            device=CARD).to(torch.bfloat16)
        for layer_index in (1, 2):
            for bias in (None, b):
                got = thrice(lambda: all_relu_fused.bias_all_relu(
                    x, bias, alpha=cfg.sparse_alpha, layer_index=layer_index),
                    f"kernel B bf16 at {rows} rows")
                want = all_relu_fused.bias_all_relu_plain(x, bias, alpha=cfg.sparse_alpha,
                                                          layer_index=layer_index)
                check(got.dtype == torch.bfloat16 and torch.equal(
                    got.view(torch.int16), want.view(torch.int16)),
                    f"kernel B bf16 at {rows} rows, layer {layer_index}, bias "
                    f"{bias is not None}: not bit-equal to its plain version")
                err_b = max(err_b, float((got.float() - want.float()).abs().max()))
    return {KERNEL_C_BF16["name"]: err_c, KERNEL_B_BF16["name"]: err_b, "routes": routes}


def host_normal(rng: np.random.Generator):
    """Standard normal f32 draws of a shape from numpy's ``rng``, on the card."""
    return lambda shape: torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                         device=CARD)


def card_normal(seed: int):
    """Standard normal f32 draws of a shape from a generator on the card: the
    inputs of recurrentgemma's kernel checks (~10^7 values a case, which
    numpy draws on the host in ~0.2 s)."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=gen, device=CARD)


def ffn_layers(model):
    """Every sparse FFN layer of ``model`` in its topologies' order: (slot,
    repeat, the host (W_in, W_out) topologies, their device arrays, the
    W_in and W_out tiles). A remainder layer's slot is ``rest{i}``, its one
    repeat 0."""
    stacked = model.topo_arrays()
    for slot, topos in model.topologies.items():
        in_stack = slot in model.params["stack"]
        ffn = (model.params["stack"][slot] if in_stack
               else model.params["rest"][int(slot[len("rest"):])])["ffn"]
        for i, pair in enumerate(topos):
            arrays = tuple(sparsity.BlockTopoArrays(*(a[i].contiguous() for a in t))
                           for t in stacked[slot])
            tiles = (ffn["win"][i], ffn["wout"][i]) if in_stack else (ffn["win"], ffn["wout"])
            yield slot, i, pair, arrays, tiles


def lm_layer_checks(model, path_rows=LM_PATH_ROWS, normal=None) -> dict:
    """Kernel C bf16 on every layer's W_in and W_out of the served model
    (each layer draws its own topology, so its own column lengths) at every
    row count of the main path, on the route ``fwd_plan`` gives: within
    C_BF16_TOL of its plain version and, with All-ReLU in its store at the
    layer's parity, bit-equal to C then kernel B; each the same bits on
    three launches. Returns the largest |difference|, the layers checked and
    the longest block-column among them. The inputs come from ``normal``
    (numpy's seeded draws by default)."""
    cfg = model.cfg
    normal = normal or host_normal(np.random.default_rng(SEED))
    err, longest, layers = 0.0, 0, 0
    for slot, i, pair, stacked, tiles in ffn_layers(model):
        layers += 1
        layer_index = layers  # the parity differs from layer to layer
        for host, t, v in zip(pair, stacked, tiles):
            meta = host.meta
            longest = max(longest, int(np.bincount(host.cols, minlength=meta.grid_n).max()))
            for rows in path_rows:
                x = normal((rows, meta.padded_in)).to(torch.bfloat16)

                def c(**kw):
                    return bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                        grid_n=meta.grid_n, **kw)

                what = f"kernel C bf16 ({slot} layer {i}, {meta.in_dim} -> {meta.out_dim}, " \
                       f"{rows} rows)"
                y = thrice(c, what)
                want = bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                          grid_n=meta.grid_n)
                torch.testing.assert_close(y.float(), want.float(), rtol=C_BF16_TOL,
                                           atol=C_BF16_TOL)
                err = max(err, float((y.float() - want.float()).abs().max()))
                fused = thrice(lambda: c(all_relu=(cfg.sparse_alpha, layer_index)),
                               f"{what} with All-ReLU")
                after = all_relu_fused.bias_all_relu(y, None, alpha=cfg.sparse_alpha,
                                                     layer_index=layer_index)
                check(_bits_equal(fused, after), f"{what}: the All-ReLU store is not C "
                                                 "then B bit for bit")
    check(layers == cfg.n_layers, f"{layers} of {cfg.n_layers} layers' sparse FFNs checked")
    return dict(max_abs_err=err, layers=layers, longest_column=longest, rows=list(path_rows))


def lm_served_logits(model, prompts: np.ndarray, steps: np.ndarray) -> torch.Tensor:
    """Prefill ``prompts`` (B, P), then decode ``steps`` (B, T) fed in
    (teacher-forced, all rows at one position): the logits of the prompts'
    last position and of each decode step, (B, 1 + T, vocab), f32 on the
    CPU."""
    dev = model.device
    topo = model.topo_arrays()
    B, P = prompts.shape
    with torch.inference_mode():
        h, pre, _ = model.forward(model.params, torch.as_tensor(prompts, device=dev), topo=topo,
                                  mode="prefill", return_hidden=True)
        outs = [model.logits(model.params, h[:, -1:])]
        caches = model.init_caches(B, P + steps.shape[1])
        for slot, c in pre["stack"].items():
            for name, p in c.items():
                caches["stack"][slot][name][:, :, :P] = p
        for i in range(steps.shape[1]):
            lg, _, _ = model.forward(model.params, torch.as_tensor(steps[:, i:i + 1], device=dev),
                                     topo=topo, positions=torch.tensor([P + i], device=dev),
                                     mode="decode", caches=caches)
            outs.append(lg)
    return torch.cat(outs, 1).float().cpu()


def logits_close(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """``got`` within LM_LOGIT_ATOL + LM_LOGIT_RTOL x |want| of ``want``
    elementwise, finite, and with ``want``'s argmax on every row whose top-2
    margin exceeds LM_LOGIT_ATOL. Returns the error, the logits' scale, the
    argmax agreement over all rows and over the rows held, and the smallest
    margin of a row that parts."""
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: {tuple(got.shape)} logits, not finite or not {tuple(want.shape)}")
    diff = (got - want).abs()
    err = float(diff.max())
    check(bool((diff <= LM_LOGIT_ATOL + LM_LOGIT_RTOL * want.abs()).all()),
          f"{what}: max |diff| {err:.4g} beyond {LM_LOGIT_ATOL} + {LM_LOGIT_RTOL} x |want|")
    top2 = want.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).flatten()
    same = (got.argmax(-1) == want.argmax(-1)).flatten()
    held = margin > LM_LOGIT_ATOL
    check(bool(same[held].all()), f"{what}: {int((~same[held]).sum())} of {int(held.sum())} "
                                  f"rows with a top-2 margin above {LM_LOGIT_ATOL} change argmax")
    parted = margin[~same]
    return dict(max_abs_err=err, logit_scale=float(want.abs().max()),
                argmax_agreement=float(same.float().mean()), rows_held=int(held.sum()),
                rows=int(same.numel()),
                parted_min_margin=float(parted.min()) if parted.numel() else None)


def lm_timing_rows(model) -> list:
    """Kernel C bf16 on the served model's first layer (W_in, W_out) at
    ``LM_TIMED_ROWS``, without and with All-ReLU in its store (the path runs
    W_in with it), on the route ``fwd_plan`` gives; kernel B bf16 at a decode step's 8
    rows and a 4 x 64 prefill's 256. Bounds, plain versions and library
    calls: ``torch.matmul`` against the densified bf16 W for C,
    ``torch.where`` for B."""
    cfg = model.cfg
    ffn = model.params["stack"]["s0_global"]["ffn"]
    topo = model.topo_arrays()["s0_global"]
    t_in = model.topologies["s0_global"][0]
    rows = []
    rng = np.random.default_rng(SEED)
    all_relu = (cfg.sparse_alpha, 1)
    for name, host, t, v in (("win", t_in[0], topo[0], ffn["win"][0]),
                             ("wout", t_in[1], topo[1], ffn["wout"][0])):
        t = sparsity.BlockTopoArrays(*(a[0].contiguous() for a in t))
        meta = host.meta
        dense = ref.blocks_to_dense(v, t.rows, t.cols, meta.grid_m, meta.grid_n)
        used = int(np.unique(host.rows).size)
        for n_rows in LM_TIMED_ROWS:
            x = torch.as_tensor(rng.standard_normal((n_rows, meta.padded_in)).astype(np.float32),
                                device=CARD).to(torch.bfloat16)

            def c(**kw):
                return bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col, grid_n=meta.grid_n, **kw)

            plan = bsm.fwd_plan(host.n_blocks, meta.grid_n, n_rows, meta.block_m, meta.block_n,
                                bf16=True)
            nbytes = 2 * (n_rows * used * meta.block_m + v.numel() + n_rows * meta.padded_out)
            rows.append(dict(
                kernel=KERNEL_C_BF16["name"], weight=name, rows=n_rows,
                shape=[meta.in_dim, meta.out_dim], n_blocks=host.n_blocks, route=plan.route,
                tile=[plan.tile_rows, plan.tile_feat], ms=device_ms(c),
                epilogue_ms=device_ms(lambda: c(all_relu=all_relu)),
                plain_ms=device_ms(lambda: bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                                              grid_n=meta.grid_n)),
                library_ms=library_ms(lambda: torch.matmul(x, dense)),
                **bound_bf16(nbytes, 2 * n_rows * v.numel())))
    slope = ref.scalar_in(ref.slope_for(cfg.sparse_alpha, 1), torch.bfloat16)
    for n_rows in (LM_ENGINE["max_slots"], 256):
        x = torch.as_tensor(rng.standard_normal((n_rows, cfg.d_ff)).astype(np.float32),
                            device=CARD).to(torch.bfloat16)
        rows.append(dict(
            kernel=KERNEL_B_BF16["name"], rows=n_rows, shape=[n_rows, cfg.d_ff], bias=False,
            ms=device_ms(lambda: all_relu_fused.bias_all_relu(x, None, alpha=cfg.sparse_alpha,
                                                              layer_index=1)),
            plain_ms=device_ms(lambda: all_relu_fused.bias_all_relu_plain(
                x, None, alpha=cfg.sparse_alpha, layer_index=1)),
            library_ms=library_ms(lambda: torch.where(x > 0, x, x * slope)),
            **bound(2 * 2 * x.numel(), 2 * x.numel())))
    return rows


def bsmm_infer_host_us(model, calls: int = 200) -> dict:
    """Host time of one ``ops.bsmm_infer`` call at a decode step's W_in
    (max_slots rows, All-ReLU in the store), and of the autograd path the
    serving product took before (``ops.bsmm_kernel`` under
    ``inference_mode``, no All-ReLU): the host clock around ``calls`` calls
    enqueued back to back, which the host's time per call sets (each call's
    device work is a few microseconds)."""
    ffn = model.params["stack"]["s0_global"]["ffn"]
    topo = model.topo_arrays()["s0_global"]
    t = sparsity.BlockTopoArrays(*(a[0].contiguous() for a in topo[0]))
    meta = model.topologies["s0_global"][0][0].meta
    v = ffn["win"][0]
    x = torch.zeros((LM_ENGINE["max_slots"], meta.in_dim), dtype=torch.bfloat16, device=CARD)
    all_relu = (model.cfg.sparse_alpha, 1)
    out = {}
    with torch.inference_mode():
        for name, fn in (("bsmm_infer_host_us", lambda: ops.bsmm_infer(x, v, t, meta,
                                                                        all_relu=all_relu)),
                         ("autograd_path_host_us", lambda: ops.bsmm_kernel(x, v, t, meta))):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name] = (time.perf_counter() - t0) * 1e6 / calls
            torch.cuda.synchronize()
    return out


def lm_warm(engine) -> None:
    """Every prefill bucket and the decode step once, then empty slots."""
    for b in engine.cfg.prefill_buckets:
        engine.prefill([np.zeros(b, np.int32)] * engine.cfg.prefill_batch,
                       list(range(engine.cfg.prefill_batch)))
    engine.decode_step(np.zeros(engine.cfg.max_slots, np.int32),
                       np.full(engine.cfg.max_slots, engine.cfg.max_len - 1))
    engine.reset_slots()


def lm_timings(engine) -> dict:
    """Prefill per bucket (median of 10, ``prefill_batch`` prompts), the
    decode step (median of 30 with quartiles, every slot at position 100),
    and the decode step's profile (device busy time, launches, idle share,
    the twelve kernels with the most device time, the six host operators
    with the most host time)."""
    cfg = engine.cfg
    prefill = {}
    for b in cfg.prefill_buckets:
        prompts = [np.arange(b, dtype=np.int32) + i for i in range(cfg.prefill_batch)]
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            engine.prefill(prompts, list(range(cfg.prefill_batch)))
            ts.append((time.perf_counter() - t0) * 1e3)
        prefill[b] = float(np.median(ts))
    tokens = np.arange(cfg.max_slots, dtype=np.int32)
    pos = np.full(cfg.max_slots, 100)

    def step():
        engine.decode_step(tokens, pos)

    for _ in range(3):
        step()
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        step()
        ts.append((time.perf_counter() - t0) * 1e3)
    q25, q50, q75 = np.percentile(ts, [25, 50, 75])
    prof = profile_train_step(step, float(q50), steps=10)
    engine.reset_slots()
    return dict(prefill_ms_by_bucket=prefill,
                decode_step_ms=dict(median=float(q50), q25=float(q25), q75=float(q75)),
                decode_device_busy_us=prof["device_busy_us"],
                decode_device_idle_share=prof["device_idle_share"],
                decode_launches=prof["device_launches"],
                decode_device_us_top=dict(sorted(prof["device_us_by_name"].items(),
                                                 key=lambda kv: -kv[1])[:12]),
                decode_host_self_us_top=prof["host_self_us_top"][:6])


def lm_serve_checked(engine) -> dict:
    """The LM engine's main path, checked: a warm-up trace and every bucket;
    a prefill and a decode step launching 48 C (W_in with All-ReLU in its
    store, then W_out, a layer; the decode route for a step, the rows route
    for a prefill, no second pass) and nothing else; then 16 Poisson
    requests through ``ContinuousBatcher`` after the warm-up: every request
    completed with its budget of vocabulary ids, no build after warm-up, C
    launched 48 times a call and B never, and the same tokens as
    ``serve_sequential`` on the same engine. Returns the batcher's and the
    sequential run's stats, the trace's launches, C's sub-counts and the
    allocator's peak."""
    cfg = engine.model.cfg
    V = cfg.vocab
    ContinuousBatcher(engine).run(poisson_trace(8, 50.0, vocab=V, prompt_lens=(4, 64),
                                                new_tokens=(2, 4), seed=0))
    lm_warm(engine)
    builds = engine.stats["compiles"]
    per_call = {}
    b = LM_ENGINE["prefill_buckets"][0]
    for what, call in (
            ("prefill", lambda: engine.prefill([np.arange(b, dtype=np.int32)] * 4, [0, 1, 2, 3])),
            ("decode_step", lambda: engine.decode_step(np.zeros(8, np.int32), np.full(8, b)))):
        reset_counts()
        call()
        per_call[what] = dict(read_counts(), **{f"bsmm_fwd.{k}": n
                                               for k, n in c_sub_counts().items()})
        # W_in with All-ReLU in its store and W_out a layer, on the decode
        # route for a step and the rows route for a prefill, no second pass
        route = "decode" if what == "decode_step" else "rows"
        want = dict(NO_LAUNCHES, bsmm_fwd=2 * cfg.n_layers, **{
            "bsmm_fwd.second_pass": 0, "bsmm_fwd.epilogue": cfg.n_layers,
            "bsmm_fwd.decode": 0, "bsmm_fwd.rows": 0, f"bsmm_fwd.{route}": 2 * cfg.n_layers})
        check(per_call[what] == want, f"a {what} launched {per_call[what]}, expected {want}")
    engine.reset_slots()

    # the main path: a Poisson trace through the continuous batcher
    trace = poisson_trace(LM_REQUESTS, vocab=V, seed=1, **LM_TRACE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats = ContinuousBatcher(engine, queue_capacity=64).run(trace)
    launches = read_counts()
    c_sub = c_sub_counts()
    peak = torch.cuda.max_memory_allocated()
    calls = stats.decode_steps + stats.prefill_calls
    check(stats.completed == LM_REQUESTS and stats.rejected == 0,
          f"{stats.completed} of {LM_REQUESTS} requests completed, {stats.rejected} rejected")
    check(all(len(r.tokens) == r.max_new_tokens and all(0 <= t < V for t in r.tokens)
              for r in trace), "a request's tokens are not its budget of vocabulary ids")
    check(engine.stats["compiles"] == builds, f"{engine.stats['compiles'] - builds} builds after "
                                              "warm-up")
    check(set(engine.jit_entry_sizes().values()) == {1}, f"{engine.jit_entry_sizes()}")
    want = dict(NO_LAUNCHES, bsmm_fwd=2 * cfg.n_layers * calls)
    check(launches == want, f"the trace launched {launches}, expected {want}")
    want = dict(second_pass=0, epilogue=cfg.n_layers * calls,
                decode=2 * cfg.n_layers * stats.decode_steps,
                rows=2 * cfg.n_layers * stats.prefill_calls)
    check(c_sub == want, f"the trace's kernel C launches were {c_sub}, expected {want}")
    # one request at a time on the same engine: its calls have the batcher's
    # shapes (prefill_batch rows, max_slots rows), so the same tokens
    seq_trace = poisson_trace(LM_REQUESTS, vocab=V, seed=1, **LM_TRACE)
    seq = serve_sequential(engine, seq_trace)
    same = sum(a.tokens == b.tokens for a, b in zip(trace, seq_trace))
    check(same == LM_REQUESTS, f"continuous batching and one request at a time agree on "
                               f"{same} of {LM_REQUESTS} requests' tokens")
    engine.reset_slots()
    return dict(stats=stats, seq=seq, launches=launches, c_sub=c_sub, peak=peak)


def phase_lm(out: dict) -> str:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    err = lm_kernel_checks()
    cfg = lm_config()
    V = cfg.vocab

    # the card against the CPU (plain versions): full width, 2 layers
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, V, (LM_ENGINE["prefill_batch"], 16))
    steps = rng.integers(0, V, (LM_ENGINE["prefill_batch"], 4))
    short = lm_config(LM_CPU_LAYERS)
    vs_cpu = logits_close(lm_served_logits(PatternLM(short, seed=SEED, device=CARD), prompts, steps),
                          lm_served_logits(PatternLM(short, seed=SEED, device="cpu"), prompts, steps),
                          f"the {LM_CPU_LAYERS}-layer model on the card against the CPU")

    model = PatternLM(cfg, seed=SEED, device=CARD)
    n_params = sum(t.numel() for t in tree_leaves(model.params))
    per_layer = lm_layer_checks(model)
    # decode against the teacher-forced forward, full depth: 2 prompts, 8 steps
    tf_prompts, tf_steps = rng.integers(0, V, (2, 24)), rng.integers(0, V, (2, 8))
    with torch.inference_mode():
        tf, _, _ = model.forward(model.params, torch.as_tensor(
            np.concatenate([tf_prompts, tf_steps], 1), device=CARD), topo=model.topo_arrays())
    tf = tf[:, tf_prompts.shape[1] - 1:].float().cpu()
    vs_tf = logits_close(lm_served_logits(model, tf_prompts, tf_steps), tf,
                         "decode against the teacher-forced forward")

    engine = SparseInferenceEngine(model, engine=EngineConfig(**LM_ENGINE))
    served = lm_serve_checked(engine)
    stats, seq, launches, c_sub, peak = (served[k] for k in ("stats", "seq", "launches",
                                                              "c_sub", "peak"))

    timing = lm_timings(engine)
    timing.update(bsmm_infer_host_us(model))
    rows = lm_timing_rows(model)
    for r in rows:
        print(json.dumps({"kernel_timing": r}))
    timing.update(
        requests=LM_REQUESTS, generated_tokens=stats.generated_tokens,
        decode_steps=stats.decode_steps, prefill_calls=stats.prefill_calls,
        tokens_per_s=stats.throughput_tok_s, latency_p50_ms=stats.latency_p50_ms,
        latency_p95_ms=stats.latency_p95_ms, ttft_p50_ms=stats.ttft_p50_ms,
        wall_s=stats.wall_seconds, sequential_tokens_per_s=seq.throughput_tok_s,
        launches_per_call={"bsmm_fwd": 2 * cfg.n_layers, "bias_all_relu": 0,
                           "bsmm_fwd.second_pass": 0, "bsmm_fwd.epilogue": cfg.n_layers},
        kernel_c_routes=err["routes"], kernel_c_every_layer=per_layer,
        max_memory_allocated=peak, n_params=n_params, vs_cpu=vs_cpu, vs_teacher_forced=vs_tf,
        card=out["smi"])
    print(json.dumps({"lm_timing": timing}))
    for meta, count in ((KERNEL_C_BF16, launches["bsmm_fwd"]),
                        (KERNEL_B_BF16, launches["bias_all_relu"])):
        # one layer's sparse FFN at a decode step's 8 rows: W_in with All-ReLU
        # in its store and W_out for C; B's standalone pass, which the path no
        # longer launches, at (8, d_ff)
        mine = [dict(r, ms=r["epilogue_ms"]) if r.get("weight") == "win" else r
                for r in rows if r["kernel"] == meta["name"] and r["rows"] == 8]
        entry = kernel_entry(meta, mine, count, err[meta["name"]])
        if meta is KERNEL_C_BF16:
            entry["bound_by"] = bound_bf16(sum(r["bytes"] for r in mine),
                                           sum(r["ops"] for r in mine))["bound_by"]
            entry["per"] = "one layer's sparse FFN at a decode step (W_in with All-ReLU, W_out)"
        else:
            entry["per"] = "its pass at (8, d_ff); the LM path runs it in C's store"
        out["kernels"].append(entry)
    return (
        f"{LM_ARCH} full width and depth, sparse FFN, bf16, {n_params} parameters; kernel C "
        f"bf16 within {C_BF16_TOL} of its plain version (max {err[KERNEL_C_BF16['name']]:.3g}) and "
        f"{C_ORACLE_TOL} of ref.bsmm_ref, its All-ReLU store bit-equal to C then B, decode "
        f"rows batch-invariant, columns of up to {max(LONG_COLUMNS)} slots held; on all "
        f"{per_layer['layers']} layers' W_in and W_out at rows {list(LM_PATH_ROWS)} (longest "
        f"column {per_layer['longest_column']} slots) within {C_BF16_TOL} (max "
        f"{per_layer['max_abs_err']:.3g}), the store C then B; B bf16 bit-equal; "
        f"{LM_CPU_LAYERS} layers card vs CPU max "
        f"|diff| {vs_cpu['max_abs_err']:.3g} (scale {vs_cpu['logit_scale']:.3g}, argmax agreement "
        f"{vs_cpu['argmax_agreement']:.3f}, {vs_cpu['rows_held']} of {vs_cpu['rows']} rows held); "
        f"decode vs teacher-forced max |diff| {vs_tf['max_abs_err']:.3g} (argmax agreement "
        f"{vs_tf['argmax_agreement']:.3f}, {vs_tf['rows_held']} of {vs_tf['rows']} rows held); "
        f"{LM_REQUESTS} requests served, "
        f"{stats.generated_tokens} tokens in {stats.decode_steps} decode steps and "
        f"{stats.prefill_calls} prefill calls, {stats.throughput_tok_s:.1f} tok/s; C "
        f"{launches['bsmm_fwd']} launches ({2 * cfg.n_layers} a call, {c_sub['epilogue']} with "
        f"All-ReLU, {c_sub['decode']} decode and {c_sub['rows']} rows route, 0 second passes), "
        f"B 0; 0 builds after warm-up; sequential tokens equal; decode "
        f"step median {timing['decode_step_ms']['median']:.2f} ms, idle share "
        f"{timing['decode_device_idle_share']:.3f}, {timing['decode_launches']:g} launches"
    )


# -- the LM compacted at deployment (the paper's Importance Pruning, Table 6) --

LM_SLOT = "s0_global"  # the served config's one stacked slot (pattern ("global",))
LM_COMPACT_PERCENTILE = SCHEDULE.percentile  # the element serving cell's


def block_counts(model) -> dict:
    """The stacked W_in and W_out block counts of every slot, and per layer
    the blocks holding a nonzero weight."""
    out = {}
    for slot, reps in model.topologies.items():
        ffn = model.params["stack"][slot]["ffn"]
        out[slot] = {name: dict(
            stacked=int(ffn[name].shape[1]),
            live=[int(n) for n in (ffn[name].abs().sum((2, 3)) > 0).sum(1).tolist()])
            for name in ("win", "wout")}
    return out


def zero_wout_blocks(model) -> list:
    """In every layer, zero one W_out block whose block-column holds two or
    more; in odd layers a second one, in a column that still holds two: so
    compaction frees one block everywhere and re-pads the odd layers' 13
    live blocks to the slot's 14 with a zero block at a freed position.
    Returns each layer's zeroed slots."""
    ffn = model.params["stack"][LM_SLOT]["ffn"]
    zeroed = []
    for r, (_, t_out) in enumerate(model.topologies[LM_SLOT]):
        counts = np.bincount(t_out.cols, minlength=t_out.meta.grid_n)
        picks = []
        for _ in range(1 + r % 2):
            col = int(np.argmax(counts))
            check(counts[col] >= 2, f"layer {r}: no W_out block-column holds two blocks")
            picks.append(int(next(i for i in np.flatnonzero(t_out.cols == col)
                                  if i not in picks)))
            counts[col] -= 1
        ffn["wout"][r, picks] = 0
        zeroed.append(picks)
    return zeroed


def phase_lm_compact(out: dict) -> str:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = lm_config()
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (LM_ENGINE["prefill_batch"], 16))
    steps = rng.integers(0, cfg.vocab, (LM_ENGINE["prefill_batch"], 4))

    # (a) zero blocks freed at threshold 0: nothing pruned, the forward's bits kept
    model = PatternLM(cfg, seed=SEED, device=CARD)
    zeroed = zero_wout_blocks(model)
    before = block_counts(model)
    check(before[LM_SLOT]["win"]["stacked"] == 22 and before[LM_SLOT]["wout"]["stacked"] == 15,
          f"the full-width sparse FFN's tile counts {before}")
    want = lm_served_logits(model, prompts, steps)
    engine = SparseInferenceEngine(model, engine=EngineConfig(**LM_ENGINE),
                                   compaction=PruningSchedule(tau=0, period=1, threshold=0.0))
    freed = block_counts(engine.model)[LM_SLOT]
    check(freed["win"]["stacked"] == 22 and freed["wout"]["stacked"] == 14,
          f"freeing the zero blocks left {freed}")
    repadded = [r for r, live in enumerate(freed["wout"]["live"]) if live == 13]
    check(repadded == list(range(1, cfg.n_layers, 2)), f"re-padded layers {repadded}")
    check(engine.report.pruned_neurons == 0
          and engine.report.params_after == engine.report.params_before,
          f"threshold 0 changed the model: {engine.report}")
    got = lm_served_logits(engine.model, prompts, steps)
    # a removed zero block adds exact zeros, and neither route depends on the
    # slot count (each slot's 8 k-steps are dealt to the same warps)
    check(torch.equal(got, want), "freeing zero blocks changed the logits: max |diff| "
                                  f"{float((got - want).abs().max()):.4g}")
    freed_checks = lm_layer_checks(engine.model)
    del model, engine
    torch.cuda.empty_cache()

    # (b) compacted at the 30th percentile, the element serving cell's
    model = PatternLM(cfg, seed=SEED, device=CARD)
    counts_before = block_counts(model)
    engine = SparseInferenceEngine(model, engine=EngineConfig(**LM_ENGINE),
                                   compaction=PruningSchedule(tau=0, period=1,
                                                              percentile=LM_COMPACT_PERCENTILE))
    report = dataclasses.asdict(engine.report)
    counts_after = block_counts(engine.model)
    check(0 < engine.report.params_after < engine.report.params_before
          and engine.report.pruned_neurons > 0, f"compaction at the 30th percentile: {report}")
    print(json.dumps({"lm_compaction": dict(percentile=LM_COMPACT_PERCENTILE, report=report,
                                            blocks_before=counts_before,
                                            blocks_after=counts_after, zero_blocks=dict(
                                                zeroed=zeroed, freed=freed,
                                                logits_bit_equal=True))}))

    # (c) the compacted model's kernels and main path
    per_layer = lm_layer_checks(engine.model)
    served = lm_serve_checked(engine)
    stats = served["stats"]
    timing = lm_timings(engine)
    timing.update(bsmm_infer_host_us(engine.model))
    timing.update(
        requests=LM_REQUESTS, generated_tokens=stats.generated_tokens,
        decode_steps=stats.decode_steps, prefill_calls=stats.prefill_calls,
        tokens_per_s=stats.throughput_tok_s, latency_p50_ms=stats.latency_p50_ms,
        latency_p95_ms=stats.latency_p95_ms, ttft_p50_ms=stats.ttft_p50_ms,
        wall_s=stats.wall_seconds, sequential_tokens_per_s=served["seq"].throughput_tok_s,
        c_launches_per_decode_step=2 * cfg.n_layers,
        trace_launches=served["launches"], kernel_c_routes=served["c_sub"],
        kernel_c_every_layer=per_layer, kernel_c_every_layer_freed=freed_checks,
        max_memory_allocated=served["peak"], card=out["smi"])
    print(json.dumps({"lm_compact_timing": timing}))
    r = engine.report
    return (
        f"(a) one W_out block zeroed a layer (two in odd layers) and freed at threshold 0: "
        f"W_out 15 -> 14 blocks, odd layers re-padded, logits bit-equal, C bf16 on all "
        f"{freed_checks['layers']} layers within {C_BF16_TOL} (max "
        f"{freed_checks['max_abs_err']:.3g}); (b) percentile {LM_COMPACT_PERCENTILE}: "
        f"{r.params_before} -> {r.params_after} live FFN params ({100 * r.shrink:.1f}% freed), "
        f"{r.pruned_neurons} neurons pruned, W_in {counts_before[LM_SLOT]['win']['stacked']} -> "
        f"{counts_after[LM_SLOT]['win']['stacked']}, W_out "
        f"{counts_before[LM_SLOT]['wout']['stacked']} -> "
        f"{counts_after[LM_SLOT]['wout']['stacked']} blocks; (c) C bf16 on all "
        f"{per_layer['layers']} layers within {C_BF16_TOL} (max {per_layer['max_abs_err']:.3g}), "
        f"its store C then B; {LM_REQUESTS} requests, {stats.generated_tokens} tokens, "
        f"{stats.throughput_tok_s:.1f} tok/s, latency p50/p95 {stats.latency_p50_ms:.0f}/"
        f"{stats.latency_p95_ms:.0f} ms, TTFT p50 {stats.ttft_p50_ms:.0f} ms, C "
        f"{2 * cfg.n_layers} a decode step; one bsmm_infer {timing['bsmm_infer_host_us']:.1f} us "
        f"host; decode step median {timing['decode_step_ms']['median']:.2f} ms"
    )


# -- the bfloat16 LM trained: Qwen1.5-0.5B with the paper's sparse FFN --------

# The served model (lm_config: full width and depth, bf16, remat="block") trained
# through examples/train_lm_torch.py's loop on its Zipf stream: 8 x 257 tokens a
# step (2,048 token rows in each sparse product), make_train_step's step (lr
# 1e-2, momentum 0.9), host SET every 2 steps: 2 steps, SET, 2 more steps on
# the new topology, SET (the loop's rule: after every 2nd step), a checkpoint.
LM_TRAIN = dict(batch=8, seq=256, lr=1e-2, evolve_every=2, zeta=0.3)
LM_TRAIN_STEPS = 4
LM_TRAIN_ROWS = LM_TRAIN["batch"] * LM_TRAIN["seq"]
LM_TRAIN_TIMED_STEPS = 10
# The kernel path's gradients against the same step through bsmm_xla (the
# reference's plain autograd formulation) on the card: relative L2 per leaf,
# the reference's bf16 tolerance (tests/test_kernels.py:57).
LM_GRAD_RTOL = 5e-2
KERNEL_D_BF16 = dict(
    name="bsmm_dx.bf16", route="cuda", source="src/repro_torch/csrc/bsmm_dx.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:127",
)
KERNEL_E_BF16 = dict(
    name="bsmm_dw.bf16", route="cuda", source="src/repro_torch/csrc/bsmm_dw.cu",
    replaces="src/repro/kernels/block_sparse_matmul.py:186",
)


def train_lm_example():
    """examples/train_lm_torch.py, the twin of the reference's LM training
    example, as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def de_second_passes() -> dict:
    """Kernels D's and E's second passes (the sums of split runs)."""
    return {"bsmm_dx.second_pass": bsm.bsmm_dx.second_pass_launches,
            "bsmm_dw.second_pass": bsm.bsmm_dw.second_pass_launches}


def de_bf16_case(what: str, meta, t, rows: int, normal) -> tuple:
    """Kernels D and E bf16 on one topology at ``rows`` rows, random tiles
    and operands from ``normal``: within C_BF16_TOL + C_BF16_TOL x |want|
    of their plain versions, the same bits on three launches, dx's
    uncovered block-rows exactly 0. Returns their largest |difference|."""
    nb = t.rows.numel()
    v = (normal((nb, meta.block_m, meta.block_n)) * 0.05).to(torch.bfloat16)
    x = normal((rows, meta.padded_in)).to(torch.bfloat16)
    dy = normal((rows, meta.padded_out)).to(torch.bfloat16)
    dx = thrice(lambda: bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                    grid_m=meta.grid_m), f"kernel D bf16 ({what})")
    dw = thrice(lambda: bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                    block_n=meta.block_n), f"kernel E bf16 ({what})")
    want_dx = bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                grid_m=meta.grid_m)
    want_dw = bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=meta.block_m,
                                block_n=meta.block_n)
    errs = []
    for name, got, want in (("D", dx, want_dx), ("E", dw, want_dw)):
        check(got.dtype == torch.bfloat16, f"kernel {name} bf16 ({what}) gave {got.dtype}")
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= C_BF16_TOL + C_BF16_TOL * want.float().abs()).all()),
              f"kernel {name} bf16 ({what}): max |diff| {float(diff.max()):.4g} beyond "
              f"{C_BF16_TOL} + {C_BF16_TOL} x |want|")
        errs.append(float(diff.max()))
    covered = torch.zeros(meta.grid_m, dtype=torch.bool, device=CARD)
    covered[t.rows.long()] = True
    uncovered = ~covered.repeat_interleave(meta.block_m)
    check(bool((dx[:, uncovered] == 0).all()), f"kernel D bf16 ({what}): an uncovered "
                                               "block-row is not exactly 0")
    return tuple(errs)


def de_bf16_checks(model, when: str, rng: np.random.Generator,
                   path_rows=(LM_TRAIN_ROWS,), normal=None) -> dict:
    """Kernels D and E bf16 (``de_bf16_case``) on every layer's W_in and
    W_out topology at each of ``path_rows`` (the step's 2,048 rows); before
    the evolution also on W_in's grid with columns of LONG_COLUMNS slots
    (block-rows of LONG_COLUMNS x grid_n / grid_m slots, longer than D's
    ring). Returns the largest differences and the longest block-row. The
    long columns' topologies come from ``rng``, the inputs from ``normal``
    (``rng``'s draws by default)."""
    normal = normal or host_normal(rng)
    err_d = err_e = 0.0
    longest, layers = 0, 0
    for slot, i, pair, stacked, _ in ffn_layers(model):
        layers += 1
        for host, t in zip(pair, stacked):
            longest = max(longest, int(np.bincount(host.rows, minlength=host.meta.grid_m).max()))
            for rows in path_rows:
                d, e = de_bf16_case(f"{when}, {slot} layer {i}, {host.meta.in_dim} -> "
                                    f"{host.meta.out_dim}, {rows} rows", host.meta, t, rows,
                                    normal)
                err_d, err_e = max(err_d, d), max(err_e, e)
    check(layers == model.cfg.n_layers, f"{layers} of {model.cfg.n_layers} layers checked")
    if when == "before the evolution":
        meta = sparsity.BlockMeta(model.cfg.d_model, model.cfg.d_ff, model.cfg.sparse_block,
                                  model.cfg.sparse_block)
        for length in LONG_COLUMNS:
            host = long_columns(meta, length, rng)
            longest = max(longest, int(np.bincount(host.rows, minlength=meta.grid_m).max()))
            d, e = de_bf16_case(f"columns of {length}", meta, host.device_arrays(CARD),
                                LM_TRAIN_ROWS, normal)
            err_d, err_e = max(err_d, d), max(err_e, e)
    return {KERNEL_D_BF16["name"]: err_d, KERNEL_E_BF16["name"]: err_e, "layers": layers,
            "longest_row": longest}


def lm_grad_vs_xla(model, batch) -> dict:
    """One full-depth step's gradients on the kernel path (C, D, E bf16)
    against the same step with the sparse FFN on ``bsmm_xla`` (the
    reference's plain autograd formulation), on the card: relative L2 per
    leaf within LM_GRAD_RTOL, and the launches of each."""
    from repro_torch.launch import steps as lm_steps
    from repro_torch.tree import tree_flatten_with_names

    topo = model.topo_arrays()
    grads, launches = {}, {}
    for impl in ("kernel", "xla"):
        model.sparse_impl = impl
        reset_counts()
        _, loss, g = lm_steps._microbatched_grad(lm_steps.lm_loss_fn(model, topo), model.params,
                                                 batch, 1)
        torch.cuda.synchronize()
        launches[impl] = {k: n for k, n in read_counts().items() if n}
        grads[impl] = (float(loss), tree_flatten_with_names(g)[0])
    model.sparse_impl = "kernel"
    check(launches["xla"] == {}, f"the bsmm_xla step launched {launches['xla']}")
    errs = {}
    for (name, a), (_, b) in zip(grads["kernel"][1], grads["xla"][1]):
        check(bool(torch.isfinite(a).all()), f"gradient {name} is not finite")
        errs[name] = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
    worst = max(errs, key=errs.get)
    check(errs[worst] <= LM_GRAD_RTOL, f"gradient {worst}: relative L2 {errs[worst]:.4g} from "
                                       f"bsmm_xla's, beyond {LM_GRAD_RTOL}")
    return dict(loss_kernel=grads["kernel"][0], loss_xla=grads["xla"][0],
                worst_leaf=worst, worst_rel_l2=errs[worst],
                rel_l2_by_leaf=dict(sorted(errs.items(), key=lambda kv: -kv[1])[:8]),
                launches_kernel=launches["kernel"])


def lm_train_timing_rows(model, batches=(LM_TRAIN_ROWS,)) -> list:
    """Kernels C (on the route ``fwd_plan`` gives, no store), D and E bf16
    on the trained model's first layer (W_in, W_out) at each of
    ``batches`` rows (the step's 2,048), beside their bounds (bytes: each
    input read once, x and dy only at the block-rows and -columns a tile
    touches, the output written once; flops at the bf16 tensor rate), plain
    versions and one library call: ``torch.matmul`` against the densified W
    for C and W^T for D, ``torch.bmm`` on the tiles gathered beforehand for
    E. D's rows carry its runs P, E's its runs S."""
    _, _, pair, arrays, weights = next(ffn_layers(model))
    cases = list(zip(("win", "wout"), pair, arrays, weights))
    rng = np.random.default_rng(SEED)
    rows = []
    for B, (name, host, t, v) in [(B, case) for B in batches for case in cases]:
        meta = host.meta
        bm, bn = meta.block_m, meta.block_n
        x = torch.as_tensor(rng.standard_normal((B, meta.padded_in)).astype(np.float32),
                            device=CARD).to(torch.bfloat16)
        dy = torch.as_tensor(rng.standard_normal((B, meta.padded_out)).astype(np.float32),
                             device=CARD).to(torch.bfloat16)
        dense = ref.blocks_to_dense(v, t.rows, t.cols, meta.grid_m, meta.grid_n)
        xg = x.reshape(B, meta.grid_m, bm)[:, t.rows.long()].permute(1, 2, 0).contiguous()
        dyg = dy.reshape(B, meta.grid_n, bn)[:, t.cols.long()].transpose(0, 1).contiguous()
        rows_used = int(np.unique(host.rows).size)
        cols_used = int(np.unique(host.cols).size)
        tiles, idx = 2 * v.numel(), 4 * 3 * host.n_blocks
        flops = 2 * B * v.numel()
        common = dict(weight=name, rows=B, shape=[meta.in_dim, meta.out_dim],
                      n_blocks=host.n_blocks)
        plan = bsm.fwd_plan(host.n_blocks, meta.grid_n, B, bm, bn, bf16=True)
        rows.append(dict(
            kernel=KERNEL_C_BF16["name"], **common, route=plan.route,
            tile=[plan.tile_rows, plan.tile_feat],
            ms=device_ms(lambda: bsm.bsmm_fwd(x, v, t.rows, t.cols, t.first_col,
                                              grid_n=meta.grid_n)),
            plain_ms=device_ms(lambda: bsm.bsmm_fwd_plain(x, v, t.rows, t.cols, t.first_col,
                                                          grid_n=meta.grid_n), 10),
            library_ms=library_ms(lambda: torch.matmul(x, dense)),
            **bound_bf16(2 * B * rows_used * bm + tiles + idx + 8 * (meta.grid_n + 1)
                         + 2 * B * meta.padded_out, flops)))
        rows.append(dict(
            kernel=KERNEL_D_BF16["name"], **common,
            longest_block_row=int(np.bincount(host.rows, minlength=meta.grid_m).max()),
            ms=device_ms(lambda: bsm.bsmm_dx(dy, v, t.rows_r, t.cols_r, t.first_row, t.perm_r,
                                             grid_m=meta.grid_m)),
            plain_ms=device_ms(lambda: bsm.bsmm_dx_plain(dy, v, t.rows_r, t.cols_r, t.first_row,
                                                         t.perm_r, grid_m=meta.grid_m), 10),
            library_ms=library_ms(lambda: torch.matmul(dy, dense.t())),
            **bound_bf16(2 * B * cols_used * bn + tiles + idx + 8 * (meta.grid_m + 1)
                         + 2 * B * meta.padded_in, flops)))
        rows.append(dict(
            kernel=KERNEL_E_BF16["name"], **common,
            splits=bsm.dw_splits_bf16(host.n_blocks, B),
            ms=device_ms(lambda: bsm.bsmm_dw(x, dy, t.rows, t.cols, block_m=bm, block_n=bn)),
            plain_ms=device_ms(lambda: bsm.bsmm_dw_plain(x, dy, t.rows, t.cols, block_m=bm,
                                                         block_n=bn), 10),
            # the tiles gathered beforehand: the gather is not timed
            library_ms=library_ms(lambda: torch.bmm(xg, dyg)),
            **bound_bf16(2 * B * rows_used * bm + 2 * B * cols_used * bn + idx + tiles,
                         flops)))
    return rows


def time_lm_train_step(model, example) -> dict:
    """The trained model's step on the stream's next batches: the median of
    LM_TRAIN_TIMED_STEPS host-clock steps that end in a synchronise, after 2
    warm-up steps, then its profile over 3 steps (device busy, idle share,
    launches, kernels by device time)."""
    from repro_torch.launch.steps import make_train_step

    step, opt = make_train_step(model, lr=LM_TRAIN["lr"])
    stream = example.synthetic_stream(np.random.default_rng(1), model.cfg.vocab,
                                      LM_TRAIN["batch"], LM_TRAIN["seq"] + 1)
    batches = []
    for _ in range(4):
        tokens = torch.as_tensor(next(stream), device=CARD).long()
        batches.append({"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    topo = model.topo_arrays()
    state = {"p": model.params, "s": opt.init(model.params), "i": 0}

    def one_step():
        b = batches[state["i"] % len(batches)]
        state["i"] += 1
        state["p"], state["s"], m = step(state["p"], state["s"], b, topo)
        return m

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    ts = []
    for _ in range(LM_TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    q25, q50, q75 = np.percentile(ts, [25, 50, 75])
    prof = profile_train_step(one_step, float(q50), steps=3)
    return dict(step_ms=dict(median=float(q50), q25=float(q25), q75=float(q75)),
                device_busy_us=prof["device_busy_us"],
                device_idle_share=prof["device_idle_share"],
                device_launches=prof["device_launches"],
                device_us_top=dict(sorted(prof["device_us_by_name"].items(),
                                          key=lambda kv: -kv[1])[:12]),
                host_self_us_top=prof["host_self_us_top"][:6])


def phase_lm_train(out: dict) -> str:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    example = train_lm_example()
    cfg = lm_config()
    check(cfg.dtype == "bfloat16" and cfg.remat == "block", f"{cfg.dtype}, remat {cfg.remat}")
    model = PatternLM(cfg, seed=SEED, device=CARD)
    rng = np.random.default_rng(SEED)
    splits = {}
    for name, host in zip(("W_in", "W_out"), model.topologies["s0_global"][0]):
        meta = host.meta
        splits[name] = dict(n_blocks=host.n_blocks, grid=[meta.grid_m, meta.grid_n],
                            rows=LM_TRAIN_ROWS,
                            D_longest_block_row=int(np.bincount(
                                host.rows, minlength=meta.grid_m).max()),
                            E_splits=bsm.dw_splits_bf16(host.n_blocks, LM_TRAIN_ROWS))
    print(json.dumps({"lm_train_splits": splits}), flush=True)
    before = de_bf16_checks(model, "before the evolution", rng)
    start_topos = {slot: list(pairs) for slot, pairs in model.topologies.items()}

    def counts() -> dict:
        return dict(read_counts(), **de_second_passes(), **c_sub_counts())

    # the main path: the example's loop, 2 steps, host SET, 2 steps, a checkpoint
    per_step, snaps = [], []

    def on_step(i, params, metrics):
        snap = counts()
        per_step.append(dict(loss=float(metrics["loss"]), **{
            k: n - snaps[-1][k] for k, n in snap.items() if n - snaps[-1][k]}))
        snaps.append(snap)

    ckpt = Path(tempfile.mkdtemp(prefix="lm_train_ckpt_"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    snaps.append(counts())
    t0 = time.perf_counter()
    run = example.train(model, steps=LM_TRAIN_STEPS, ckpt_dir=ckpt, meta={"arch": LM_ARCH},
                        on_step=on_step, verbose=False, **LM_TRAIN)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    # a step: C twice a layer in the forward and again in remat's recompute
    # (rows route, no store, no second pass), D and E bf16 twice a layer, one
    # launch each (D sums a block-row whole, E's runs meet in the clusters'
    # shared memory: no second pass), nothing else
    want_step = {"bsmm_fwd": 4 * L, "rows": 4 * L, "bsmm_dx": 2 * L, "bsmm_dx.bf16": 2 * L,
                 "bsmm_dw": 2 * L, "bsmm_dw.bf16": 2 * L}
    for i, s in enumerate(per_step):
        got = {k: n for k, n in s.items() if k != "loss"}
        check(got == want_step, f"step {i} launched {got}, expected {want_step}")
        check(np.isfinite(s["loss"]), f"step {i}'s loss is {s['loss']}")
    check(launches == dict(NO_LAUNCHES, **{k: LM_TRAIN_STEPS * n for k, n in want_step.items()
                                           if k in NO_LAUNCHES}),
          f"the run launched {launches}")
    n_evolved = LM_TRAIN_STEPS // LM_TRAIN["evolve_every"]
    check(len(run["evolved"]) == n_evolved, f"{len(run['evolved'])} evolutions, expected "
                                            f"{n_evolved}")
    # SET keeps every block-column covered: W_in's 22 columns hold one tile
    # each, so only W_out's tiles move
    moved = [int(not (np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols)))
             for slot, pairs in model.topologies.items()
             for pa, pb in zip(pairs, start_topos[slot]) for a, b in zip(pa, pb)]
    check(sum(moved) > 0, "the evolutions moved no tile")
    mgr = CheckpointManager(str(ckpt))
    check(mgr.latest_step() == LM_TRAIN_STEPS, f"checkpoint step {mgr.latest_step()}")
    after = de_bf16_checks(model, "after the evolution", rng)

    stream = example.synthetic_stream(np.random.default_rng(2), cfg.vocab, LM_TRAIN["batch"],
                                      LM_TRAIN["seq"] + 1)
    tokens = torch.as_tensor(next(stream), device=CARD).long()
    vs_xla = lm_grad_vs_xla(model, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    timing = time_lm_train_step(model, example)
    rows = lm_train_timing_rows(model)
    for r in rows:
        print(json.dumps({"kernel_timing": r}))
    err = {k: max(before[k], after[k]) for k in (KERNEL_D_BF16["name"], KERNEL_E_BF16["name"])}
    timing.update(losses=run["losses"], run_s=run_s, per_step_launches=per_step,
                  weights_moved_by_set=sum(moved),
                  max_memory_allocated=peak, vs_xla=vs_xla, de_checks=dict(
                      before=before, after=after), card=out["smi"])
    print(json.dumps({"lm_train_timing": timing}))
    for meta in (KERNEL_D_BF16, KERNEL_E_BF16):
        mine = [r for r in rows if r["kernel"] == meta["name"]]
        entry = kernel_entry(meta, mine, launches[meta["name"]], err[meta["name"]])
        entry["bound_by"] = bound_bf16(sum(r["bytes"] for r in mine),
                                       sum(r["ops"] for r in mine))["bound_by"]
        entry["per"] = "one layer's sparse FFN backward at 2,048 rows (W_in, W_out)"
        out["kernels"].append(entry)
    return (
        f"{LM_ARCH} full width and depth, sparse FFN, bf16, remat block: {LM_TRAIN_STEPS} steps "
        f"of {LM_TRAIN['batch']} x {LM_TRAIN['seq'] + 1} tokens through the example's loop, "
        f"host SET (zeta {LM_TRAIN['zeta']}) after steps 2 and 4, losses "
        f"{[round(v, 4) for v in run['losses']]}, tiles moved in {sum(moved)} of {len(moved)} "
        f"weights, checkpoint at step {mgr.latest_step()}; a "
        f"step launched {want_step}; D and E bf16 "
        f"within {C_BF16_TOL} of their plain versions on all {before['layers']} layers' W_in "
        f"and W_out before and after the evolution and on columns of {list(LONG_COLUMNS)} "
        f"slots (longest block-row {before['longest_row']}; max D "
        f"{err[KERNEL_D_BF16['name']]:.3g}, E {err[KERNEL_E_BF16['name']]:.3g}), the same bits "
        f"on three launches; gradients vs bsmm_xla worst {vs_xla['worst_leaf']} "
        f"{vs_xla['worst_rel_l2']:.3g} (<= {LM_GRAD_RTOL}); step median "
        f"{timing['step_ms']['median']:.1f} ms, idle share {timing['device_idle_share']:.3f}, "
        f"{timing['device_launches']:g} launches; peak {peak} B"
    )


# -- the architecture zoo: RG-LRU, Mamba-1 and MoE blocks ----------------------

# recurrentgemma-2b at full width and depth (configs/recurrentgemma_2b.py: 26
# layers of rglru/rglru/local, d_model and d_rnn 2,560, 10 heads, kv 1, window
# 2,048, vocab 256,000, tied) with the paper's sparse FFN at the reference's
# defaults (128 x 128 tiles, epsilon 64, All-ReLU alpha 0.6) in bf16, remat
# "block": the model the reference's serving demo and LM example run for
# --arch recurrentgemma-2b with the sparse FFN. Its FFN puts kernels C, D and E
# bf16 on grids no other phase runs: W_in 20 x 60 (60 tiles, block-rows of up
# to 5), W_out 60 x 20 (40 tiles, columns of up to 6).
RG_ARCH = "recurrentgemma-2b"
RG_TILES = (60, 40)  # W_in, W_out at epsilon 64, seed 0 (BlockTopology.from_epsilon)
RG_TRAIN_STEPS = 3  # host SET after the last: the kernels are held before and after
RG_KERNEL_ROWS = (8, LM_TRAIN_ROWS)  # a decode step's 8 rows, a train step's 2,048
# The prompts every arch is driven with: 8 of the lm_train phase's Zipf stream,
# 64 tokens each (a decode step: 8 rows, kernel C's decode route)
ARCH_BATCH = 8
ARCH_PROMPT = 64
ARCH_TIMED = 10  # timed calls of a forward, a decode step, a train step
# falcon-mamba-7b at full width and depth (64 layers, d_model 4,096, d_inner
# 8,192, d_state 16, vocab 65,024, untied), bf16: no hand kernel on its path.
# Its train step runs at full width on a cut of MAMBA_CUT_LAYERS layers in f32,
# card against CPU (all 64 layers' f32 gradients and velocity would not fit
# beside the weights): logits within rtol = atol = MAMBA_RTOL, gradients within
# MAMBA_RTOL relative L2 a leaf (f32 sums in other orders).
MAMBA_ARCH = "falcon-mamba-7b"
# Its decode in bf16 at 64 layers parts from its bf16 forward by more than
# the lm phase's LM_LOGIT_ATOL + LM_LOGIT_RTOL x |want| (0.352 on an H100
# against 0.1 + 0.05 x |want|): two bf16 roundings of one function, 64 layers deep. So the decode is
# held through the f32 twin of the same weights (vs_f32_twin): the twin's
# decode within the reference's f32 decode tolerance of its forward, and the
# bf16 decode within DECODE_BF16_SPREAD times the bf16 forward's own distance
# from the twin's forward.
DECODE_F32_TOL = 5e-3
DECODE_BF16_SPREAD = 2.0
MAMBA_CUT_LAYERS = 2
MAMBA_CUT_BATCH = dict(batch=2, seq=32)
MAMBA_RTOL = 1e-4
# qwen3-moe-30b-a3b at full width (d_model 2,048, 128 experts, top-8, expert
# d_ff 768, vocab 151,936, untied), bf16, depth cut from 48 to MOE_LAYERS.
# The dispatch invariants' combine is held against a loop over each token's
# kept experts within MOE_TOL + MOE_TOL x |want|: three bf16 products, each
# rounded once by cuBLAS kernels of other shapes, a few bf16 ulps (2**-8) apart.
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 4
MOE_TOL = 2e-2


def arch_prompts(vocab: int, batch: int = ARCH_BATCH, seq: int = ARCH_PROMPT) -> torch.Tensor:
    """``batch`` x (``seq`` + 1) tokens of the example's Zipf stream (seed 2)."""
    stream = train_lm_example().synthetic_stream(np.random.default_rng(2), vocab, batch, seq + 1)
    return torch.as_tensor(next(stream), device=CARD).long()


def drawn_model(cfg: ModelConfig, device=None) -> tuple:
    """``PatternLM(cfg)`` from the seed on ``device`` (None: the card), its
    parameter count and the host seconds of drawing its weights (the dense
    draws come from the CPU generator, then move)."""
    t0 = time.perf_counter()
    model = PatternLM(cfg, seed=SEED, device=CARD if device is None else device)
    torch.cuda.synchronize()
    return model, sum(a.numel() for a in tree_leaves(model.params)), time.perf_counter() - t0


def median_ms(fn, reps: int = ARCH_TIMED) -> dict:
    """Host-clock milliseconds of ``fn`` ending in a synchronise: the median
    and quartiles of ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    q25, q50, q75 = np.percentile(ts, [25, 50, 75])
    return dict(median=float(q50), q25=float(q25), q75=float(q75))


def decode_logits(model, tokens: torch.Tensor, what: str) -> tuple:
    """The teacher-forced forward's logits over ``tokens`` (B, P) and the
    logits of decoding them token by token from ``init_caches(B, P)`` (in
    the model's dtype: attention's K/V or ring, the recurrent states), in
    ``torch.inference_mode``; both finite, (B, P, vocab). Also the caches
    and the decode steps' kernel launches."""
    B, P = tokens.shape
    topo = model.topo_arrays()
    with torch.inference_mode():
        want, _, _ = model.forward(model.params, tokens, topo=topo)
        caches = model.init_caches(B, P, dtype=getattr(torch, model.cfg.dtype))
        torch.cuda.synchronize()
        reset_counts()
        outs = []
        for i in range(P):
            lg, caches, _ = model.forward(model.params, tokens[:, i:i + 1], topo=topo,
                                          positions=torch.tensor([i], device=CARD),
                                          mode="decode", caches=caches)
            outs.append(lg)
        torch.cuda.synchronize()
        launches = dict(read_counts(), **c_sub_counts())
        got = torch.cat(outs, 1)
    check(got.shape == want.shape == (B, P, model.cfg.vocab)
          and bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{what}: decode logits {tuple(got.shape)}, forward {tuple(want.shape)}, "
          "not finite or not (batch, prompt, vocab)")
    return want, got, caches, launches


def f32_twin(model):
    """The same model with its weights (bf16-exact) in f32."""
    twin = copy.copy(model)
    twin.cfg = dataclasses.replace(model.cfg, dtype="float32")
    twin.params = tree_map(lambda a: a.float(), model.params)
    return twin


def vs_f32_twin(model, tokens: torch.Tensor, fwd: torch.Tensor, dec: torch.Tensor,
                what: str) -> dict:
    """A bf16 model's decode held through its f32 twin (``f32_twin``): the
    twin's decode within the reference's f32 decode tolerance
    (DECODE_F32_TOL) of its teacher-forced forward, and the bf16 decode
    ``dec`` no further from the twin's forward than DECODE_BF16_SPREAD times
    the bf16 forward ``fwd`` is: both are bf16 roundings of one function
    (cuBLAS sums a decode step's 8 rows and a forward's 512 in other
    orders), and a decode fault would part from it by the logits' scale."""
    twin = f32_twin(model)
    fwd32, dec32, _, _ = decode_logits(twin, tokens, f"{what} in f32")
    del twin
    torch.testing.assert_close(dec32, fwd32, rtol=DECODE_F32_TOL, atol=DECODE_F32_TOL)
    e_fwd = float((fwd.float() - fwd32).abs().max())
    e_dec = float((dec.float() - fwd32).abs().max())
    check(e_dec <= DECODE_BF16_SPREAD * e_fwd,
          f"{what}: the bf16 decode is {e_dec:.4g} from the f32 forward, beyond "
          f"{DECODE_BF16_SPREAD} x the bf16 forward's {e_fwd:.4g}")
    same = (dec.float().argmax(-1) == fwd32.argmax(-1)).float().mean()
    return dict(f32_decode_max_abs_err=float((dec32 - fwd32).abs().max()),
                bf16_forward_vs_f32=e_fwd, bf16_decode_vs_f32=e_dec,
                max_abs_err=float((dec.float() - fwd.float()).abs().max()),
                logit_scale=float(fwd32.abs().max()), argmax_agreement_vs_f32=float(same))


def decoded_vs_forward(model, tokens: torch.Tensor, what: str, compare: str = "bf16") -> dict:
    """``decode_logits``, the decode held to the forward: directly
    (``logits_close``, ``compare="bf16"``), through the f32 twin
    (``vs_f32_twin``, ``"f32"``) or not at all (None). Returns the
    comparison, the decode steps' kernel launches, the forward's tokens/s
    and a decode step's median, device busy, idle share and launches
    (``torch.profiler``)."""
    B, P = tokens.shape
    want, got, caches, launches = decode_logits(model, tokens, what)
    close = None
    if compare == "bf16":
        close = logits_close(got.float(), want.float(), f"{what}: decode vs teacher-forced")
    elif compare == "f32":
        close = vs_f32_twin(model, tokens, want, got, what)
    del got, want
    topo = model.topo_arrays()
    pos = torch.tensor([P - 1], device=CARD)
    with torch.inference_mode():
        fwd = median_ms(lambda: model.forward(model.params, tokens, topo=topo))

        def step():
            model.forward(model.params, tokens[:, -1:], topo=topo, positions=pos,
                          mode="decode", caches=caches)

        dec = median_ms(step)
        prof = profile_train_step(step, dec["median"], steps=5)
    return dict(vs_forward=close, decode_launches=launches,
                forward_ms=fwd, forward_tokens_per_s=B * P / (fwd["median"] * 1e-3),
                decode_step_ms=dec, decode_device_busy_us=prof["device_busy_us"],
                decode_device_idle_share=prof["device_idle_share"],
                decode_device_launches=prof["device_launches"],
                decode_device_us_top=dict(sorted(prof["device_us_by_name"].items(),
                                                 key=lambda kv: -kv[1])[:8]))


def rg_splits(model) -> dict:
    """Kernel E bf16's batch runs S (``dw_splits_bf16``, tuned on Qwen's
    W_in grid) on recurrentgemma's W_in and W_out at the train step's 2,048
    rows: legal (1 <= S <= CLUSTER_MAX, the nb x S CTAs of the clusters in
    one wave of the SMs) and every CTA of a cluster given a run of whole
    64-row chunks that is not empty; and the grids' longest block-row (D's
    loop) and block-column (C's)."""
    splits = {}
    for name, host in zip(("W_in", "W_out"), model.topologies["s0_rglru"][0]):
        meta, nb = host.meta, host.n_blocks
        S = bsm.dw_splits_bf16(nb, LM_TRAIN_ROWS)
        runs = bsm.dw_batch_runs(LM_TRAIN_ROWS, S, bsm.DW_CHUNK_BF16)
        check(1 <= S <= bsm.CLUSTER_MAX and nb * S <= bsm.SMS,
              f"E bf16 on {name} ({nb} tiles): S = {S} is not a legal cluster in one wave")
        check(runs[0][0] == 0 and runs[-1][1] == LM_TRAIN_ROWS
              and all(b > a and a % bsm.DW_CHUNK_BF16 == 0 for a, b in runs)
              and all(r0[1] == r1[0] for r0, r1 in zip(runs, runs[1:])),
              f"E bf16 on {name}: the runs {runs} leave a CTA of a cluster empty")
        splits[name] = dict(n_blocks=nb, grid=[meta.grid_m, meta.grid_n], rows=LM_TRAIN_ROWS,
                            E_splits=S, E_runs=runs, E_ctas=nb * S,
                            longest_block_row=int(np.bincount(host.rows,
                                                              minlength=meta.grid_m).max()),
                            longest_column=int(np.bincount(host.cols,
                                                           minlength=meta.grid_n).max()))
    return splits


def lm_arch_recurrentgemma(out: dict) -> dict:
    """(a) recurrentgemma-2b, full width and depth, bf16, the sparse FFN:
    kernels C (with and without its store), D and E bf16 on every layer at
    RG_KERNEL_ROWS before and after a host SET; the main path, 3 steps of
    the example's loop (``make_train_step``, remat "block") with host SET
    after the third, each step's launches counted; one step's gradients
    against ``bsmm_xla``'s; decode against the teacher-forced forward."""
    example = train_lm_example()
    cfg = dataclasses.replace(get_spec(RG_ARCH).config, ffn="sparse")
    check(cfg.dtype == "bfloat16" and cfg.remat == "block", f"{cfg.dtype}, remat {cfg.remat}")
    torch.cuda.reset_peak_memory_stats()
    model, n_params, draw_s = drawn_model(cfg)
    print(json.dumps({"lm_archs_params": {RG_ARCH: n_params}}), flush=True)
    first = model.topologies["s0_rglru"][0]
    check((first[0].n_blocks, first[1].n_blocks) == RG_TILES,
          f"{RG_ARCH}'s sparse FFN tiles {(first[0].n_blocks, first[1].n_blocks)}, "
          f"expected {RG_TILES}")
    splits = rg_splits(model)
    print(json.dumps({"lm_archs_splits": splits}), flush=True)
    rng, normal = np.random.default_rng(SEED), card_normal(SEED)
    c_before = lm_layer_checks(model, RG_KERNEL_ROWS, normal)
    de_before = de_bf16_checks(model, "before the evolution", rng, RG_KERNEL_ROWS, normal)

    def counts() -> dict:
        return dict(read_counts(), **de_second_passes(), **c_sub_counts())

    per_step, snaps = [], []

    def on_step(i, params, metrics):
        snap = counts()
        per_step.append(dict(loss=float(metrics["loss"]), **{
            k: n - snaps[-1][k] for k, n in snap.items() if n - snaps[-1][k]}))
        snaps.append(snap)

    # the main path: the example's loop, 3 steps, host SET after the third
    torch.cuda.synchronize()
    reset_counts()
    snaps.append(counts())
    t0 = time.perf_counter()
    run = example.train(model, steps=RG_TRAIN_STEPS, batch=LM_TRAIN["batch"],
                        seq=LM_TRAIN["seq"], lr=LM_TRAIN["lr"], evolve_every=RG_TRAIN_STEPS,
                        zeta=LM_TRAIN["zeta"], on_step=on_step, verbose=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    L = cfg.n_layers
    remat_layers = cfg.n_rep * len(cfg.pattern)  # the remainder layers run without remat
    # a step: C twice a layer in the forward and again in remat's recompute of
    # the stacked layers (rows route, no store, no second pass), D and E bf16
    # twice a layer, one launch each, nothing else
    want_step = {"bsmm_fwd": 2 * (L + remat_layers), "rows": 2 * (L + remat_layers),
                 "bsmm_dx": 2 * L, "bsmm_dx.bf16": 2 * L, "bsmm_dw": 2 * L,
                 "bsmm_dw.bf16": 2 * L}
    for i, s in enumerate(per_step):
        got = {k: n for k, n in s.items() if k != "loss"}
        check(got == want_step, f"{RG_ARCH} step {i} launched {got}, expected {want_step}")
        check(np.isfinite(s["loss"]), f"{RG_ARCH} step {i}'s loss is {s['loss']}")
    check(launches == dict(NO_LAUNCHES, **{k: RG_TRAIN_STEPS * n for k, n in want_step.items()
                                           if k in NO_LAUNCHES}),
          f"{RG_ARCH}'s run launched {launches}")
    check(len(run["evolved"]) == 1, f"{len(run['evolved'])} evolutions, expected 1")
    del run
    c_after = lm_layer_checks(model, RG_KERNEL_ROWS, normal)
    de_after = de_bf16_checks(model, "after the evolution", rng, RG_KERNEL_ROWS, normal)
    tokens = arch_prompts(cfg.vocab, LM_TRAIN["batch"], LM_TRAIN["seq"])
    vs_xla = lm_grad_vs_xla(model, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
    decode = decoded_vs_forward(model, arch_prompts(cfg.vocab)[:, :-1], RG_ARCH)
    per_call = decode["decode_launches"]
    want_decode = dict(NO_LAUNCHES, bsmm_fwd=2 * L * ARCH_PROMPT)
    check({k: per_call[k] for k in NO_LAUNCHES} == want_decode
          and per_call["epilogue"] == L * ARCH_PROMPT
          and per_call["decode"] == 2 * L * ARCH_PROMPT
          and per_call["rows"] == per_call["second_pass"] == 0,
          f"{RG_ARCH}'s {ARCH_PROMPT} decode steps launched {per_call}: expected {2 * L} C "
          f"a step ({L} with All-ReLU in the store, decode route) and no B")
    train = time_lm_train_step(model, example)
    peak = torch.cuda.max_memory_allocated()
    rows = [dict(r, arch=RG_ARCH) for r in lm_train_timing_rows(model, RG_KERNEL_ROWS)]
    for r in rows:
        print(json.dumps({"kernel_timing": r}))
    errs = {KERNEL_C_BF16["name"]: max(c_before["max_abs_err"], c_after["max_abs_err"]),
            **{k: max(de_before[k], de_after[k])
               for k in (KERNEL_D_BF16["name"], KERNEL_E_BF16["name"])}}
    for meta in (KERNEL_C_BF16, KERNEL_D_BF16, KERNEL_E_BF16):
        mine = [r for r in rows if r["kernel"] == meta["name"] and r["rows"] == LM_TRAIN_ROWS]
        # every C launch of the run is bf16: the wrapper's count is C bf16's
        count = launches["bsmm_fwd" if meta is KERNEL_C_BF16 else meta["name"]]
        entry = kernel_entry(dict(meta, name=f"{meta['name']}@{RG_ARCH}"), mine, count,
                             errs[meta["name"]])
        entry["bound_by"] = bound_bf16(sum(r["bytes"] for r in mine),
                                       sum(r["ops"] for r in mine))["bound_by"]
        entry["per"] = (f"one {RG_ARCH} layer's sparse FFN at {LM_TRAIN_ROWS:,} rows (W_in, "
                        "W_out), forward for C, backward for D and E")
        out["kernels"].append(entry)
    result = dict(arch=RG_ARCH, n_params=n_params, draw_s=draw_s, losses=[
        s["loss"] for s in per_step], run_s=run_s, per_step_launches=want_step,
        kernel_checks=dict(C_before=c_before, C_after=c_after, DE_before=de_before,
                           DE_after=de_after),
        vs_xla=vs_xla, **decode, train_step_ms=train["step_ms"],
        train_device_idle_share=train["device_idle_share"],
        train_device_launches=train["device_launches"],
        train_device_us_top=dict(list(train["device_us_top"].items())[:8]),
        train_host_self_us_top=train["host_self_us_top"], max_memory_allocated=peak,
        card=out["smi"])
    del model
    torch.cuda.empty_cache()
    return result


def lm_arch_mamba(out: dict) -> dict:
    """(b) falcon-mamba-7b, full width and depth, bf16: decode against the
    teacher-forced forward, no kernel launched; then its train step at full
    width on MAMBA_CUT_LAYERS layers in f32, card against CPU."""
    from repro_torch.launch import steps as lm_steps
    from repro_torch.tree import tree_flatten_with_names

    cfg = get_spec(MAMBA_ARCH).config
    check(cfg.dtype == "bfloat16", cfg.dtype)
    torch.cuda.reset_peak_memory_stats()
    model, n_params, draw_s = drawn_model(cfg)
    print(json.dumps({"lm_archs_params": {MAMBA_ARCH: n_params}}), flush=True)
    decode = decoded_vs_forward(model, arch_prompts(cfg.vocab)[:, :-1], MAMBA_ARCH, "f32")
    check({k: decode["decode_launches"][k] for k in NO_LAUNCHES} == NO_LAUNCHES,
          f"{MAMBA_ARCH}'s decode launched {decode['decode_launches']}")
    peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=MAMBA_CUT_LAYERS, dtype="float32")
    cpu, cut_params, cut_draw_s = drawn_model(cut, "cpu")
    card = copy.copy(cpu).to(CARD)
    tokens = arch_prompts(cut.vocab, MAMBA_CUT_BATCH["batch"], MAMBA_CUT_BATCH["seq"])
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    got, want = {}, {}
    for m, b, res in ((card, batch, got), (cpu, cpu_batch, want)):
        with torch.no_grad():
            res["logits"] = m.forward(m.params, b["tokens"])[0].cpu()
        _, loss, grads = lm_steps._microbatched_grad(lm_steps.lm_loss_fn(m, None), m.params, b, 1)
        res["loss"] = float(loss)
        res["grads"] = [(n, g.cpu()) for n, g in tree_flatten_with_names(grads)[0]]
    torch.testing.assert_close(got["logits"], want["logits"], rtol=MAMBA_RTOL, atol=MAMBA_RTOL)
    rel = {n: float((a - b).norm() / b.norm().clamp(min=1e-30))
           for (n, a), (_, b) in zip(got["grads"], want["grads"])}
    worst = max(rel, key=rel.get)
    check(rel[worst] <= MAMBA_RTOL, f"{MAMBA_ARCH} cut: gradient {worst} relative L2 "
                                    f"{rel[worst]:.3g} from the CPU's, beyond {MAMBA_RTOL}")
    step, opt = lm_steps.make_train_step(card, lr=LM_TRAIN["lr"])
    state = {"p": card.params, "s": opt.init(card.params)}

    def one_step():
        state["p"], state["s"], m = step(state["p"], state["s"], batch, None)
        return m

    reset_counts()
    m = one_step()
    torch.cuda.synchronize()
    check(np.isfinite(float(m["loss"])) and read_counts() == NO_LAUNCHES,
          f"{MAMBA_ARCH} cut's train step: loss {float(m['loss'])}, launches {read_counts()}")
    train = median_ms(one_step)
    del card, cpu, state
    torch.cuda.empty_cache()
    return dict(arch=MAMBA_ARCH, n_params=n_params, draw_s=draw_s, **decode,
                max_memory_allocated=peak,
                cut=dict(layers=MAMBA_CUT_LAYERS, dtype="float32", n_params=cut_params,
                         draw_s=cut_draw_s, **MAMBA_CUT_BATCH,
                         logits_max_abs_err=float((got["logits"] - want["logits"]).abs().max()),
                         loss_card=got["loss"], loss_cpu=want["loss"], worst_leaf=worst,
                         worst_rel_l2=rel[worst], train_step_ms=train),
                card=out["smi"])


def moe_invariants(model) -> dict:
    """The dispatch invariants of tests/test_model_numerics.py on the card,
    at full width, on the first layer's MoE FFN and ARCH_BATCH x ARCH_PROMPT
    random token rows: every kept entry in a slot of its own (the dropped
    ones in the scratch row), each token K entries, at most C an expert;
    the combine within MOE_TOL of a loop over each token's kept experts
    (batched by expert: plain matmuls, no capacity buffers), summed over k in
    order; the same bits on two runs."""
    from repro_torch.models import moe as moe_mod

    cfg = model.cfg
    mcfg = cfg.moe_cfg()
    p = {k: v[0] for k, v in model.params["stack"]["s0_global"]["ffn"].items()}
    T, E, K, d = ARCH_BATCH * ARCH_PROMPT, mcfg.n_experts, mcfg.top_k, cfg.d_model
    C = max(1, int(np.ceil(T * K * mcfg.capacity_factor / E)))
    gen = torch.Generator(device=CARD).manual_seed(SEED)
    x = torch.randn((T, d), generator=gen, device=CARD).to(torch.bfloat16)
    with torch.inference_mode():
        _, slot, st, sg, keep, order = moe_mod._dispatch(p, x[None], mcfg, C)
        slot, st, sg, keep, order = slot[0], st[0], sg[0], keep[0], order[0]
        kept = slot[keep]
        check(kept.unique().numel() == kept.numel(), "MoE: two kept entries share a slot")
        check(bool((slot[~keep] == E * C).all()), "MoE: a dropped entry outside the scratch row")
        check(bool((torch.bincount(st, minlength=T) == K).all()), "MoE: a token without K entries")
        per_expert = torch.bincount(torch.div(kept, C, rounding_mode="floor"), minlength=E)
        check(int(per_expert.max()) <= C, f"MoE: an expert holds {int(per_expert.max())} > {C}")
        y1, aux1 = moe_mod.moe_fwd(p, x, mcfg)
        y2, aux2 = moe_mod.moe_fwd(p, x, mcfg)
        check(_bits_equal(y1, y2) and _bits_equal(aux1, aux2), "MoE: two runs differ")
        contrib = torch.zeros((T * K, d), dtype=x.dtype, device=CARD)
        expert = torch.div(slot, C, rounding_mode="floor")
        for e in range(E):
            j = torch.nonzero(keep & (expert == e)).flatten()
            xe = x[st[j]]
            h = F.silu(xe @ p["wi_gate"][e]) * (xe @ p["wi_up"][e])
            contrib[j] = (h @ p["wo"][e]) * sg[j].to(x.dtype)[:, None]
        per_k = contrib[torch.argsort(order)].reshape(T, K, d)
        want = per_k[:, 0]
        for k in range(1, K):
            want = want + per_k[:, k]
    diff = (y1.float() - want.float()).abs()
    check(bool((diff <= MOE_TOL + MOE_TOL * want.float().abs()).all()),
          f"MoE: the combine is {float(diff.max()):.4g} from the per-token loop, beyond "
          f"{MOE_TOL} + {MOE_TOL} x |want|")
    return dict(tokens=T, capacity=C, kept=int(keep.sum()), dropped=int((~keep).sum()),
                fullest_expert=int(per_expert.max()), aux=float(aux1),
                combine_max_abs_err=float(diff.max()))


def lm_arch_moe(out: dict) -> dict:
    """(c) qwen3-moe-30b-a3b at full width, depth cut to MOE_LAYERS, bf16:
    the dispatch invariants, a forward, one train step whose total carries
    the auxiliary loss, and decode steps (capacity is per call, so a decode
    step's dispatch differs from the forward's: finite, not compared)."""
    from repro_torch.launch.steps import make_train_step

    cfg = dataclasses.replace(get_spec(MOE_ARCH).config, n_layers=MOE_LAYERS)
    check(cfg.dtype == "bfloat16" and cfg.ffn == "moe", f"{cfg.dtype}, {cfg.ffn}")
    torch.cuda.reset_peak_memory_stats()
    model, n_params, draw_s = drawn_model(cfg)
    print(json.dumps({"lm_archs_params": {MOE_ARCH: n_params}}), flush=True)
    inv = moe_invariants(model)
    decode = decoded_vs_forward(model, arch_prompts(cfg.vocab)[:, :-1], MOE_ARCH, None)
    check({k: decode["decode_launches"][k] for k in NO_LAUNCHES} == NO_LAUNCHES,
          f"{MOE_ARCH}'s decode launched {decode['decode_launches']}")
    step, opt = make_train_step(model, lr=LM_TRAIN["lr"])
    tokens = arch_prompts(cfg.vocab)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    state = {"p": model.params, "s": opt.init(model.params)}

    def one_step():
        state["p"], state["s"], m = step(state["p"], state["s"], batch, None)
        return m

    reset_counts()
    m = one_step()
    torch.cuda.synchronize()
    loss, total = float(m["loss"]), float(m["total"])
    check(np.isfinite(total) and total > loss and read_counts() == NO_LAUNCHES,
          f"{MOE_ARCH}'s train step: loss {loss}, total with the aux loss {total}, launches "
          f"{read_counts()}")
    train = median_ms(one_step)
    peak = torch.cuda.max_memory_allocated()
    del model, state
    torch.cuda.empty_cache()
    return dict(arch=MOE_ARCH, layers=MOE_LAYERS, n_params=n_params, draw_s=draw_s,
                invariants=inv, **decode, train_loss=loss, train_aux=total - loss,
                train_step_ms=train, max_memory_allocated=peak, card=out["smi"])


def phase_lm_archs(out: dict) -> str:
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    res = {}
    for fn in (lm_arch_recurrentgemma, lm_arch_mamba, lm_arch_moe):
        t0 = time.perf_counter()
        r = fn(out)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps({"lm_archs_timing": r}), flush=True)
        res[r["arch"]] = r
    rg, mb, mo = res[RG_ARCH], res[MAMBA_ARCH], res[MOE_ARCH]
    ck = rg["kernel_checks"]
    return (
        f"{RG_ARCH} full width and depth, sparse FFN, bf16, {rg['n_params']} parameters (drawn "
        f"in {rg['draw_s']:.1f} s): {RG_TRAIN_STEPS} steps of {LM_TRAIN['batch']} x "
        f"{LM_TRAIN['seq'] + 1} tokens, losses {[round(v, 4) for v in rg['losses']]}, a step "
        f"launched {rg['per_step_launches']}; C, D and E bf16 on all {ck['C_before']['layers']} "
        f"layers at rows {list(RG_KERNEL_ROWS)} before and after host SET within {C_BF16_TOL} "
        f"(max C {max(ck['C_before']['max_abs_err'], ck['C_after']['max_abs_err']):.3g}, D "
        f"{max(ck['DE_before'][KERNEL_D_BF16['name']], ck['DE_after'][KERNEL_D_BF16['name']]):.3g}"
        f", E {max(ck['DE_before'][KERNEL_E_BF16['name']], ck['DE_after'][KERNEL_E_BF16['name']]):.3g}"
        f"); gradients vs bsmm_xla worst {rg['vs_xla']['worst_leaf']} "
        f"{rg['vs_xla']['worst_rel_l2']:.3g}; decode vs teacher-forced max |diff| "
        f"{rg['vs_forward']['max_abs_err']:.3g}; train step {rg['train_step_ms']['median']:.1f} "
        f"ms, decode step {rg['decode_step_ms']['median']:.2f} ms; "
        f"{MAMBA_ARCH} full width and depth, {mb['n_params']} parameters (drawn in "
        f"{mb['draw_s']:.1f} s): decode vs teacher-forced max |diff| "
        f"{mb['vs_forward']['max_abs_err']:.3g}, decode step {mb['decode_step_ms']['median']:.2f} "
        f"ms; {MAMBA_CUT_LAYERS}-layer f32 cut card vs CPU logits {mb['cut']['logits_max_abs_err']:.3g}, "
        f"gradients worst {mb['cut']['worst_rel_l2']:.3g}; {MOE_ARCH} {MOE_LAYERS} layers, "
        f"{mo['n_params']} parameters: dispatch invariants held (capacity "
        f"{mo['invariants']['capacity']}, {mo['invariants']['dropped']} dropped, combine "
        f"{mo['invariants']['combine_max_abs_err']:.3g}), aux {mo['train_aux']:.4g}, train step "
        f"{mo['train_step_ms']['median']:.1f} ms"
    )


# -- Whisper-medium: the encoder-decoder at full width and depth ---------------

# configs/whisper_medium.py's FULL config: 24 + 24 layers, d_model 1,024, 16
# heads, d_ff 4,096, vocab 51,865, a 32,768-row position table, bf16, remat
# "block"; random weights from the seed, drawn on the card. Its FFN is the
# plain GELU MLP: the path runs no kernel of the port (dense products).
WHISPER_ARCH = "whisper-medium"
WHISPER_PARAMS = 792_024_064  # the reference's eval_shape count of FULL
WHISPER_TRAIN = dict(batch=4, frames=1500, tokens=448)  # a 30 s window, 448 text tokens
WHISPER_TRAIN_STEPS = 3
# the card against the CPU: full width, 2 + 2 layers, f32, 1 x 64 frames, 16 tokens
WHISPER_CUT = dict(layers=2, frames=64, tokens=16)
WHISPER_CUT_RTOL = 1e-4
# decode: 8 rows over 1,500 encoded frames, 64 tokens teacher-forced from
# position 0 into init_caches(8, 448); prefill of the first 32
WHISPER_DECODE = dict(batch=8, frames=1500, tokens=64, max_len=448, prefill=32)
WHISPER_TIMED = 3


def whisper_frames(batch: int, frames: int, d_model: int, dtype: torch.dtype, seed: int,
                   device=None) -> torch.Tensor:
    """Frame embeddings (the stubbed frontend's output): seeded normals drawn
    on the card, cast to ``dtype``."""
    gen = torch.Generator(device=CARD).manual_seed(seed)
    x = torch.randn((batch, frames, d_model), generator=gen, device=CARD).to(dtype)
    return x if device is None else x.to(device)


def whisper_cut_vs_cpu(cfg) -> dict:
    """The model cut to WHISPER_CUT's layers in f32, its weights drawn on the
    card and copied to the CPU: logits within WHISPER_CUT_RTOL, each
    gradient leaf within WHISPER_CUT_RTOL relative L2, the cross
    attention's bias gradients exact zeros, on both."""
    from repro_torch.interop import whisper_from_numpy
    from repro_torch.launch import steps as lsteps
    from repro_torch.models.whisper import WhisperModel
    from repro_torch.tree import tree_flatten_with_names

    cut = dataclasses.replace(cfg, n_layers=WHISPER_CUT["layers"], dtype="float32")
    card = WhisperModel(cut, seed=SEED, device=CARD)
    cpu = whisper_from_numpy(dataclasses.asdict(cut),
                             tree_map(lambda a: a.cpu().numpy(), card.params), device="cpu")
    frames = whisper_frames(1, WHISPER_CUT["frames"], cut.d_model, torch.float32, SEED + 1,
                            device="cpu")
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cut.vocab, (1, WHISPER_CUT["tokens"] + 1)))
    res = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = model.device
        batch = {"frames": frames.to(dev), "tokens": toks[:, :-1].to(dev),
                 "labels": toks[:, 1:].to(dev)}
        _, loss, g = lsteps._microbatched_grad(lsteps.whisper_loss_fn(model), model.params,
                                               batch, 1)
        with torch.no_grad():
            logits = model.logits(model.params, model.decode_train(
                model.params, batch["tokens"], model.encode(model.params, batch["frames"])))
        res[name] = (logits.cpu(), float(loss),
                     [(n, a.cpu()) for n, a in tree_flatten_with_names(g)[0]])
    (l0, s0, g0), (l1, s1, g1) = res["cpu"], res["card"]
    torch.testing.assert_close(l1, l0, rtol=WHISPER_CUT_RTOL, atol=WHISPER_CUT_RTOL)
    check(abs(s1 - s0) <= WHISPER_CUT_RTOL * abs(s0), f"whisper cut: loss {s1} vs CPU {s0}")
    worst, zeros = ("", 0.0), 0
    for (name, a), (_, b) in zip(g1, g0):
        if "cross_attn" in name and name.endswith(("bq", "bk", "bv")):
            check(not a.any() and not b.any(), f"whisper cut: {name}'s gradient is not zero")
            zeros += 1
            continue
        rel = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        worst = max(worst, (name, rel), key=lambda t: t[1])
    check(worst[1] <= WHISPER_CUT_RTOL, f"whisper cut: gradient {worst[0]} rel L2 {worst[1]:.3g}")
    check(zeros == 3, f"whisper cut: {zeros} cross-attention bias gradients, expected 3")
    return dict(logits_max_abs_err=float((l1 - l0).abs().max()), loss=s1, loss_cpu=s0,
                worst_leaf=worst[0], worst_rel_l2=worst[1], leaves=len(g1))


def phase_whisper(out: dict) -> str:
    from repro_torch.launch import steps as lsteps
    from repro_torch.models.whisper import WhisperModel

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_spec(WHISPER_ARCH).config
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab, cfg.max_text, cfg.dtype)
          == (24, 1024, 16, 4096, 51865, 32768, "bfloat16"), f"whisper config {cfg}")
    dtype = torch.bfloat16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = WhisperModel(cfg, seed=SEED, device=CARD)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    check(model.n_params == WHISPER_PARAMS, f"{model.n_params} parameters, expected "
                                            f"{WHISPER_PARAMS}")
    # training: the Zipf stream of the lm_train phase, seeded frames
    B, S = WHISPER_TRAIN["batch"], WHISPER_TRAIN["tokens"]
    stream = train_lm_example().synthetic_stream(np.random.default_rng(SEED), cfg.vocab, B, S + 1)
    train_step, opt = lsteps.make_train_step(model)
    params, state = model.params, opt.init(model.params)
    batches = []
    for i in range(WHISPER_TRAIN_STEPS):
        toks = torch.as_tensor(next(stream), device=CARD).long()
        batches.append({"frames": whisper_frames(B, WHISPER_TRAIN["frames"], cfg.d_model, dtype,
                                                 SEED + i),
                        "tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = []
    for batch in batches:
        params, state, met = train_step(params, state, batch)
        losses.append(float(met["loss"]))
    launches = read_counts()
    train_peak = torch.cuda.max_memory_allocated()
    check(launches == NO_LAUNCHES, f"whisper's train steps launched {launches}: its path is "
                                   "dense, no kernel of the port")
    check(bool(np.isfinite(losses).all()), f"whisper losses {losses}")
    step_ms = median_ms(lambda: train_step(params, state, batches[-1]), reps=WHISPER_TIMED)
    del state, batches
    cut = whisper_cut_vs_cpu(cfg)

    # decode, teacher-forced: the decode steps against decode_train's logits
    D = WHISPER_DECODE
    decode = lsteps.make_decode_step(model)
    prefill = lsteps.make_prefill_step(model)
    frames = whisper_frames(D["batch"], D["frames"], cfg.d_model, dtype, SEED + 7)
    toks = torch.as_tensor(next(train_lm_example().synthetic_stream(
        np.random.default_rng(SEED + 2), cfg.vocab, D["batch"], D["tokens"])), device=CARD).long()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        enc_ms = median_ms(lambda: model.encode(params, frames), reps=WHISPER_TIMED)
        memory = model.encode(params, frames)
        want = model.logits(params, model.decode_train(params, toks, memory))
        caches = model.init_caches(D["batch"], D["max_len"])
        torch.cuda.synchronize()
        reset_counts()
        outs = [decode(params, {"tokens": toks[:, i:i + 1], "position": i, "caches": caches,
                                "memory": memory})[0] for i in range(D["tokens"])]
        torch.cuda.synchronize()
        dec_launches = read_counts()
        got = torch.cat(outs, 1)
        pre = prefill(params, {"frames": frames, "tokens": toks[:, :D["prefill"]]})
    check(dec_launches == NO_LAUNCHES, f"whisper's decode steps launched {dec_launches}")
    vs_forward = logits_close(got.float(), want.float(), "whisper decode vs teacher-forced")
    vs_prefill = logits_close(pre.float(), want[:, D["prefill"] - 1:D["prefill"]].float(),
                              "whisper prefill vs teacher-forced")
    del got, outs, want
    last = {"tokens": toks[:, -1:], "position": D["tokens"] - 1, "caches": caches,
            "memory": memory}
    with torch.inference_mode():
        dec_ms = median_ms(lambda: decode(params, last))
        prof = profile_train_step(lambda: decode(params, last), dec_ms["median"], steps=5)
    peak = max(train_peak, torch.cuda.max_memory_allocated())
    # a decode step's cross attention recomputes the memory's K and V in
    # every layer: 2 products of (B x frames, d) x (d, d) a layer
    cross_kv_flops = 2 * 2 * D["batch"] * D["frames"] * cfg.d_model * cfg.d_model * cfg.n_layers
    timing = dict(arch=WHISPER_ARCH, n_params=model.n_params, draw_s=draw_s, losses=losses,
                  train=dict(WHISPER_TRAIN), train_step_ms=step_ms, train_peak_bytes=train_peak,
                  encode=dict(batch=D["batch"], frames=D["frames"]), encode_ms=enc_ms,
                  decode_step_ms=dec_ms, decode_device_busy_us=prof["device_busy_us"],
                  decode_device_idle_share=prof["device_idle_share"],
                  decode_device_launches=prof["device_launches"],
                  decode_device_us_top=dict(sorted(prof["device_us_by_name"].items(),
                                                   key=lambda kv: -kv[1])[:8]),
                  decode_cross_kv_tflop=cross_kv_flops / 1e12,
                  max_memory_allocated=peak, vs_forward=vs_forward, vs_prefill=vs_prefill,
                  cut_vs_cpu=cut, card=out["smi"])
    print(json.dumps({"whisper_timing": timing}), flush=True)
    out["whisper"] = timing
    return (
        f"{WHISPER_ARCH} full width and depth (24 + 24 layers), bf16, {model.n_params} "
        f"parameters (drawn on the card in {draw_s:.1f} s): {WHISPER_TRAIN_STEPS} train steps of "
        f"{B} x {WHISPER_TRAIN['frames']} frames + {S} tokens, losses "
        f"{[round(v, 4) for v in losses]}, no port kernel launched (dense path), step median "
        f"{step_ms['median']:.1f} ms, peak {peak} B; {WHISPER_CUT['layers']}+"
        f"{WHISPER_CUT['layers']}-layer f32 cut card vs CPU logits {cut['logits_max_abs_err']:.3g}, "
        f"gradients worst {cut['worst_leaf']} {cut['worst_rel_l2']:.3g}, cross-attention bias "
        f"gradients 0; decode of {D['tokens']} tokens x {D['batch']} rows vs teacher-forced max "
        f"|diff| {vs_forward['max_abs_err']:.3g} (argmax agreement "
        f"{vs_forward['argmax_agreement']:.3f}), prefill vs teacher-forced "
        f"{vs_prefill['max_abs_err']:.3g}; encode {enc_ms['median']:.1f} ms, decode step "
        f"{dec_ms['median']:.2f} ms (device busy {prof['device_busy_us']:.0f} us, idle share "
        f"{prof['device_idle_share']:.3f})"
    )


# -- obs: the observability layer on the paper's main path ---------------------

OBS_TIMED = 5  # interleaved runs of each variant
OBS_LM_STEPS = 2
OBS_SERVE_BURST = (1, 128, 1, 128, 1)  # classify calls: buckets 1 and 128, each new once


def obs_trainer(probe: bool) -> SequentialTrainer:
    """The element_train phase's data and settings with device SET (the
    trainer's default: its churn is probed) and ``probe``."""
    return SequentialTrainer(element_model(CARD), load("cifar10", scale=TRAIN_SCALE),
                             dataclasses.replace(train_config(device_evolution=True),
                                                 probe=probe))


def probe_launches(cfg) -> dict:
    """One probe's launches on the element model: a forward keeping z + bias
    (A with the bias epilogue a layer, B's All-ReLU on each hidden layer)
    and a backward (F with the bias's gradient a layer, G standalone on
    each hidden layer, A's dX on all but layer 0)."""
    L = cfg.n_layers
    return {"coo_matmul_T": 2 * L - 1, "coo_matmul_T.epilogue": L, "bias_all_relu": L - 1,
            "bias_all_relu.T": L - 1, "coo_dw": L, "coo_dw.epilogue": L, "all_relu_bwd": L - 1}


def probe_oracle(snaps: list, seen: list) -> float:
    """Each snapshot's stats against numpy over the tensors the probe read
    (copied to the host by a spy on ``probes.segment_probe``), at
    tests/test_probes.py's tolerances: value L2 rtol 1e-4, fractions 1e-6
    absolute, quantiles rtol 1e-4, histograms exact. Returns the largest
    relative error."""
    worst = 0.0
    for snap, (values, grads, rows, cols, preacts, dims) in zip(snaps, seen):
        for l, st in enumerate(snap["layers"]):
            v, g = values[l].astype(np.float64), grads[l].astype(np.float64)
            imp = np.bincount(cols[l], weights=np.abs(v), minlength=dims[l + 1])
            q = np.quantile(imp, (0.1, 0.5, 0.9))
            rel = {"value_l2": np.sqrt(np.sum(v * v)), "grad_l2": np.sqrt(np.sum(g * g)),
                   "imp_q10": q[0], "imp_q50": q[1], "imp_q90": q[2]}
            for k, want in rel.items():
                err = abs(st[k] - want) / max(abs(want), 1e-30)
                check(err <= 1e-4, f"probe {k} layer {l}: {st[k]} vs numpy {want}")
                worst = max(worst, err)
            frac = {"value_zero_frac": np.mean(v == 0), "grad_zero_frac": np.mean(g == 0),
                    "saturation": np.mean(preacts[l] <= 0),
                    "dead_out_frac": np.mean(np.bincount(cols[l], minlength=dims[l + 1]) == 0),
                    "dead_in_frac": np.mean(np.bincount(rows[l], minlength=dims[l]) == 0)}
            for k, want in frac.items():
                check(abs(st[k] - want) <= 1e-6, f"probe {k} layer {l}: {st[k]} vs {want}")
            for k, idx, dim in (("in_deg_hist", cols[l], dims[l + 1]),
                                ("out_deg_hist", rows[l], dims[l])):
                deg = np.bincount(idx, minlength=dim)
                b = np.where(deg == 0, 0, 1 + np.floor(np.log2(np.maximum(deg, 1))).astype(int))
                want = np.bincount(np.clip(b, 0, 7), minlength=8).tolist()
                check(st[k] == want, f"probe {k} layer {l}: {st[k]} vs {want}")
    return worst


def obs_element_run(work: Path) -> dict:
    """(a): the probed, traced element run against the unprobed one under
    ``obs.disabled()``, its launches, its snapshots against numpy, the
    monitor, the seeded dead layer and the CLI's report."""
    from repro_torch import obs
    from repro_torch.obs import detect, probes, timeline

    seen = []
    real_probe = probes.segment_probe

    def spy(params, grads, topo_arrays, preacts, layer_dims):
        seen.append(([a.cpu().numpy() for a in params["values"]],
                     [a.cpu().numpy() for a in grads["values"]],
                     [t.rows.cpu().numpy() for t in topo_arrays],
                     [t.cols.cpu().numpy() for t in topo_arrays],
                     [z.cpu().numpy() for z in preacts], tuple(layer_dims)))
        return real_probe(params, grads, topo_arrays, preacts, layer_dims)

    probed = obs_trainer(True)
    cfg = probed.model.config
    trace, tl = work / "train.jsonl", work / "train_timeline.jsonl"
    monitor = detect.configure(detect.AnomalyMonitor())
    probes.segment_probe = spy
    try:
        reset_counts()
        with obs.trace_to(str(trace), meta={"phase": "obs"}), \
                timeline.timeline_to(tl, run_id="element_probe"):
            hist = probed.run()
        launches = read_counts()
    finally:
        probes.segment_probe = real_probe
        detect.configure(None)
    plain = obs_trainer(False)
    reset_counts()
    with obs.disabled():
        plain_hist = plain.run()
    plain_launches = read_counts()
    steps, evals = run_steps(plain)
    want = element_launches(cfg, steps, evals)
    check(plain_launches == want, f"unprobed run launched {plain_launches}, expected {want}")
    extra = probe_launches(cfg)
    want_probed = {k: n + TRAIN_EPOCHS * extra.get(k, 0) for k, n in want.items()}
    check(launches == want_probed, f"probed run launched {launches}, expected {want_probed}")
    # a probe reads and never writes: the runs are the same bits
    np.testing.assert_equal({k: v for k, v in hist.items() if k != "epoch_seconds"},
                            {k: v for k, v in plain_hist.items() if k != "epoch_seconds"})
    for a, b in zip(probed.model.topos, plain.model.topos):
        check(np.array_equal(a.rows, b.rows) and np.array_equal(a.cols, b.cols),
              "probed and unprobed topologies differ")
    for a, b in zip(probed.model.values + probed.model.biases,
                    plain.model.values + plain.model.biases):
        check(torch.equal(a, b), "probed and unprobed weights differ")
    events = obs.read_events(str(trace))
    check(obs.validate_events(events) == [], f"trace: {obs.validate_events(events)[:3]}")
    spans = [e for e in events if e["ev"] == "span"]
    names = {e["name"] for e in spans}
    check({"train.run", "train.epoch", "train.segment"} <= names, f"spans {names}")
    run_span = next(e for e in spans if e["name"] == "train.run")
    epochs = [e for e in spans if e["name"] == "train.epoch"]
    check(len(epochs) == TRAIN_EPOCHS and all(e["parent"] == run_span["id"] for e in epochs),
          "train.epoch spans are not the run's children")
    points = sorted({e["name"] for e in events if e["ev"] == "point"})
    tev = timeline.read_timeline(tl)
    check(timeline.validate_timeline(tev) == [], f"timeline: {timeline.validate_timeline(tev)}")
    snaps = timeline.snapshots(tev, "train")
    check(len(snaps) == TRAIN_EPOCHS == len(seen), f"{len(snaps)} snapshots, {len(seen)} probes")
    keys = {"grad_l2", "grad_zero_frac", "value_l2", "value_zero_frac", "saturation", "imp_q10",
            "imp_q50", "imp_q90", "dead_out_frac", "dead_in_frac", "in_deg_hist", "out_deg_hist"}
    for s in snaps:
        check(len(s["layers"]) == cfg.n_layers and all(keys <= set(st) for st in s["layers"]),
              f"snapshot at step {s['step']} lacks stats")
    check(all("churn_frac" in st for s in snaps[:-1] for st in s["layers"]),
          "the device SET's churn is missing")
    worst = probe_oracle(snaps, seen)
    check(timeline.alerts(tev) == [] and monitor.active_alerts == [],
          f"the healthy run raised {timeline.alerts(tev)}")
    # the seeded dead layer: the run's snapshots recorded again through a
    # fresh monitor with layer 1 zeroed
    sick = work / "sick_timeline.jsonl"
    detect.configure(detect.AnomalyMonitor())
    probes.set_snapshot_transform(probes.zero_layer_transform(layer=1))
    try:
        with timeline.timeline_to(sick, run_id="sick"):
            for s in snaps:
                probes.record_snapshot(s["step"], "train", layers=s["layers"], extra=s["extra"])
    finally:
        probes.set_snapshot_transform(None)
        detect.configure(None)
    alerts = sorted({(a["rule"], a["layer"]) for a in timeline.alerts(timeline.read_timeline(sick))})
    check(alerts == [("dead_layer", 1)], f"the seeded dead layer raised {alerts}")
    rep = subprocess.run([sys.executable, "-m", "repro_torch.obs", "report", str(tl)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(PYTHONPATH=str(Path(__file__).resolve().parent / "src"),
                                  PATH="/usr/bin:/bin:/usr/local/bin"))
    check(rep.returncode == 0 and "[train]" in rep.stdout and "alerts: none" in rep.stdout,
          f"obs report: rc {rep.returncode} {rep.stderr[-300:]}")
    return dict(history=hist, launches=launches, probe_launches_per_epoch=extra,
                spans=sorted(names), points=points, n_events=len(events),
                snapshots=len(snaps), oracle_worst_rel=worst, pathology=alerts,
                report_lines=len(rep.stdout.splitlines()))


def obs_served_spans(out: dict, work: Path) -> dict:
    """(b): a classify burst under a trace, on a fresh engine with buckets 1
    and 128: one serve.classify span a call, one serve.compile point a new
    bucket."""
    from repro_torch import obs

    engine = SparseInferenceEngine(out["model"], engine=EngineConfig(batch_buckets=(1, 128)))
    path = work / "serve.jsonl"
    with obs.trace_to(str(path)):
        for n in OBS_SERVE_BURST:
            engine.classify(requests(out["x_test"], n))
    events = obs.read_events(str(path))
    check(obs.validate_events(events) == [], "serve trace invalid")
    spans = [e for e in events if e["ev"] == "span" and e["name"] == "serve.classify"]
    compiles = [e["attrs"]["bucket"] for e in events
                if e["ev"] == "point" and e["name"] == "serve.compile"]
    check(len(spans) == len(OBS_SERVE_BURST), f"{len(spans)} serve.classify spans")
    check(sorted(compiles) == [1, 128], f"serve.compile points {compiles}")
    return dict(calls=len(spans), compiles=compiles,
                classify_ms={str(n): 1e3 * float(np.median([e["dur_s"] for e in spans
                                                            if e["attrs"]["bucket"] == n]))
                             for n in (1, 128)})


def obs_lm_run(work: Path) -> dict:
    """(c): the LM example's loop at full width (bf16) for OBS_LM_STEPS
    steps with host SET after each, ``--probe --trace --timeline``: both
    files valid, the sparse FFN's snapshot stats finite, and C, D and E
    bf16 launched a step as in lm_train."""
    from repro_torch import obs
    from repro_torch.obs import timeline

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    example = train_lm_example()
    model = PatternLM(lm_config(), seed=SEED, device=CARD)
    L = model.cfg.n_layers
    want_step = {"bsmm_fwd": 4 * L, "rows": 4 * L, "bsmm_dx": 2 * L, "bsmm_dx.bf16": 2 * L,
                 "bsmm_dw": 2 * L, "bsmm_dw.bf16": 2 * L}
    snaps_n, per_step = [], []

    def counts():
        return dict(read_counts(), **de_second_passes(), **c_sub_counts())

    def on_step(i, params, metrics):
        snap = counts()
        per_step.append({k: n - snaps_n[-1][k] for k, n in snap.items() if n - snaps_n[-1][k]})
        snaps_n.append(snap)

    trace, tl = work / "lm.jsonl", work / "lm_timeline.jsonl"
    reset_counts()
    snaps_n.append(counts())
    run = example.train(model, steps=OBS_LM_STEPS, batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"],
                        lr=LM_TRAIN["lr"], evolve_every=1, zeta=LM_TRAIN["zeta"],
                        on_step=on_step, verbose=False, trace=str(trace), probe=True,
                        timeline=str(tl))
    for i, got in enumerate(per_step):
        check(got == want_step, f"LM step {i} launched {got}, expected {want_step}")
    events = obs.read_events(str(trace))
    check(obs.validate_events(events) == [], "LM trace invalid")
    names = [e["name"] for e in events if e["ev"] == "span"]
    check(names.count("train.step") == OBS_LM_STEPS and names.count("train.evolve")
          == OBS_LM_STEPS and names.count("train.run") == 1, f"LM spans {sorted(set(names))}")
    tev = run["timeline"]
    check(timeline.validate_timeline(tev) == [], "LM timeline invalid")
    snaps = timeline.snapshots(tev, "lm")
    check(len(snaps) == OBS_LM_STEPS + 1, f"{len(snaps)} LM snapshots")
    vals = [v for s in snaps for st in s["layers"] for v in st.values()]
    check(bool(np.isfinite(vals).all()), "LM snapshot stats not finite")
    return dict(losses=run["losses"], per_step_launches=per_step, spans=sorted(set(names)),
                snapshots=[s["layers"] for s in snaps], alerts=timeline.alerts(tev))


def obs_profiling(work: Path, attempts: int = 3) -> dict:
    """(d): ``sample_device_memory`` against the allocator, and
    ``profile_trace`` around kernel A's launches writing a Chrome trace that
    holds them. torch.profiler can drop the device events of whole calls
    late in a run (PERF.md §7): every capture must hold kernel A launches,
    and one that holds fewer than A's wrapper counted is taken again, up to
    ``attempts`` times, as ``profile_classify`` does; each capture's count
    is reported."""
    from repro_torch import obs

    x = torch.empty(1 << 26, dtype=torch.uint8, device=CARD)
    mem = obs.sample_device_memory(obs.MetricsRegistry(control=True))
    dev = torch.cuda.current_device()
    check(mem[f"device_bytes_in_use{{device={dev}}}"] == torch.cuda.memory_allocated(dev)
          and mem[f"device_peak_bytes_in_use{{device={dev}}}"]
          == torch.cuda.max_memory_allocated(dev), f"device memory {mem}")
    del x
    model = element_model(CARD)
    xb = torch.as_tensor(load("cifar10", scale=TRAIN_SCALE).x_test[:128], device=CARD)
    held = []
    for attempt in range(attempts):
        reset_counts()
        with obs.profile_trace(str(work / "prof"), name="kernel_a"):
            with torch.no_grad():
                for _ in range(3):
                    mlp_forward(model.params(), model.topo_arrays(), xb, model.config)
        launched = read_counts()["coo_matmul_T"]
        trace = json.loads((work / "prof" / "kernel_a.pt.trace.json").read_text())
        held.append(sum(1 for e in trace.get("traceEvents", [])
                        if e.get("cat") == "kernel" and "coo_matmul_T" in e.get("name", "")))
        check(launched == 3 * model.config.n_layers, f"kernel A launched {launched}")
        check(0 < held[-1] <= launched, f"the profile holds {held[-1]} of kernel A's "
                                        f"{launched} launches")
        if held[-1] == launched:
            break
    return dict(memory=mem, kernel_a_launches=launched, kernel_a_events=held[-1],
                kernel_a_events_per_capture=held)


def obs_overhead() -> dict:
    """One 3-epoch run of (a)'s model, OBS_TIMED times each, interleaved:
    under ``obs.disabled()``, traced, and traced + probed (timeline and
    monitor). Host-clock seconds of ``run()`` and its epoch_seconds."""
    from repro_torch import obs
    from repro_torch.obs import detect, timeline

    work = Path(tempfile.mkdtemp(prefix="obs_timing_"))
    secs = {"disabled": [], "traced": [], "traced_probed": []}
    epochs = {k: [] for k in secs}
    for rep in range(OBS_TIMED):
        for variant in secs:
            trainer = obs_trainer(variant == "traced_probed")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if variant == "disabled":
                with obs.disabled():
                    hist = trainer.run()
            else:
                ctx = timeline.timeline_to(work / f"tl{rep}.jsonl", run_id="t") \
                    if variant == "traced_probed" else contextlib.nullcontext()
                detect.configure(detect.AnomalyMonitor() if variant == "traced_probed" else None)
                with obs.trace_to(str(work / f"t{rep}.jsonl")), ctx:
                    hist = trainer.run()
                detect.configure(None)
            torch.cuda.synchronize()
            secs[variant].append(time.perf_counter() - t0)
            epochs[variant].extend(hist["epoch_seconds"])
    med = {k: float(np.median(v)) for k, v in secs.items()}
    return dict(run_s=secs, run_s_median=med,
                epoch_s_median={k: float(np.median(v)) for k, v in epochs.items()},
                per_epoch_s_median={k: v / TRAIN_EPOCHS for k, v in med.items()},
                overhead_traced=med["traced"] / med["disabled"] - 1,
                overhead_traced_probed=med["traced_probed"] / med["disabled"] - 1,
                budget=0.02)


def phase_obs(out: dict) -> str:
    work = Path(tempfile.mkdtemp(prefix="obs_"))
    res = {}
    for key, fn in (("element", lambda: obs_element_run(work)),
                    ("serve", lambda: obs_served_spans(out, work)),
                    ("lm", lambda: obs_lm_run(work)),
                    ("profiling", lambda: obs_profiling(work)),
                    ("overhead", obs_overhead)):
        t0 = time.perf_counter()
        res[key] = fn()
        res[key]["seconds"] = time.perf_counter() - t0
    res["card"] = out["smi"]
    ov = res["overhead"]
    res["holds_budget"] = bool(ov["overhead_traced_probed"] < ov["budget"])
    print(json.dumps({"obs_timing": res}), flush=True)
    el, lm = res["element"], res["lm"]
    return (
        f"(a) the element model 3 epochs probed + traced: spans {el['spans']}, points "
        f"{el['points']}, {el['snapshots']} snapshots within {el['oracle_worst_rel']:.3g} of numpy, "
        f"no alert, bit-equal to the unprobed run, probe launches an epoch "
        f"{el['probe_launches_per_epoch']}, dead layer caught {el['pathology']}; (b) "
        f"{res['serve']['calls']} classify spans, compiles at buckets {res['serve']['compiles']}; "
        f"(c) Qwen1.5-0.5B {OBS_LM_STEPS} steps probed + traced, losses "
        f"{[round(v, 4) for v in lm['losses']]}, C/D/E bf16 a step as lm_train; (d) memory "
        f"gauges = allocator, profile holds kernel A's {res['profiling']['kernel_a_events']} of "
        f"{res['profiling']['kernel_a_launches']} launches (captures "
        f"{res['profiling']['kernel_a_events_per_capture']}); overhead traced {100 * ov['overhead_traced']:.2f} %, traced + probed "
        f"{100 * ov['overhead_traced_probed']:.2f} % (run medians {ov['run_s_median']}), "
        f"budget 2 % {'held' if res['holds_budget'] else 'not held'}"
    )


# -- out-of-core XL: the paper's Table-4 regime --------------------------------

# The paper's first Table-4 row at full width (benchmarks/table4_extreme.py
# scales it down to (512, 2, 10)): 65536-500000-500000-2, epsilon 10,
# All-ReLU with alpha 0.5, f32, dropout 0, batch 32, and a device budget of
# 0.6 x the in-core bytes, so that every layer streams.
XL_DIMS = (65536, 500000, 500000, 2)
XL_EPSILON = 10
XL_ALPHA = 0.5
XL_BATCH = 32
XL_BUDGET_FRACTION = 0.6
XL_SAMPLES = 512  # make_extreme_dataset: 358 training samples (11 steps), 154 test
XL_EPOCHS = 2
XL_LR = 0.01
# the streamed run's history against the in-core run's: the epoch means of
# the same per-step losses, taken in f64 by one and in f32 by the other
XL_HISTORY_RTOL = 1e-6
# what the reference's planner gives for these inputs (tests/test_torch_xl.py
# computes both planners)
XL_PLAN = dict(in_core_bytes=880_370_704, budget_bytes=528_222_422,
               peak_device_bytes=528_161_560, shard_capacity=73_728, chunk=8_192,
               shards=[77, 136, 14])
XL_TIMED_STEPS = 8
KERNEL_XL_ACC = dict(
    name="xl_shard_acc", route="cuda", source="src/repro_torch/csrc/coo_matmul_T.cu",
    replaces="src/repro/kernels/ops.py:347",
)
KERNEL_XL_DW = dict(
    name="xl_shard_dw", route="cuda", source="src/repro_torch/csrc/coo_dw.cu",
    replaces="src/repro/kernels/ops.py:393",
)
# kernel B's own pass in the stream's (features, batch) layout, and kernel
# G's standalone call there (once per layer and step)
KERNEL_B_T = dict(
    name="bias_all_relu_T", route="cuda", source="src/repro_torch/csrc/bias_all_relu.cu",
    replaces="src/repro/kernels/all_relu_fused.py:23",
)
KERNEL_G_XL = dict(
    name="all_relu_bwd.xl", route="cuda", source="src/repro_torch/csrc/coo_dw.cu",
    replaces="src/repro/core/all_relu.py:21",
)


def xl_config(chunk: int) -> SparseMLPConfig:
    return SparseMLPConfig(layer_dims=XL_DIMS, epsilon=XL_EPSILON, activation="all_relu",
                           alpha=XL_ALPHA, dropout=0.0, impl="element", element_impl="custom",
                           spmm_chunk=chunk)


def xl_train_config(evolve: bool) -> TrainerConfig:
    return TrainerConfig(epochs=XL_EPOCHS, batch_size=XL_BATCH, lr=XL_LR, zeta=0.3, seed=SEED,
                         pruning=None, evolve=evolve, device_evolution=False)


def xl_copy(state):
    """A copy of an XL state's host leaves."""
    layers = [dataclasses.replace(l, **{f.name: np.array(getattr(l, f.name))
                                        for f in dataclasses.fields(l)
                                        if isinstance(getattr(l, f.name), np.ndarray)})
              for l in state.layers]
    return dataclasses.replace(state, layers=layers)


def xl_in_core_step(cfg, core: SparseMLP, topo, xb, yb, opt_state=None):
    """One in-core step of ``core`` (kernel A with its fused epilogue, F
    with G's work) from ``opt_state`` (a fresh one by default): the new
    params, optimizer state and loss."""
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)  # TrainerConfig's
    params = core.params()
    return make_mlp_train_step(cfg, opt)(
        params, opt.init(params) if opt_state is None else opt_state, topo,
        torch.as_tensor(xb, device=CARD), torch.as_tensor(yb, device=CARD).long(),
        torch.tensor(XL_LR, device=CARD), None)


def xl_in_core_of(cfg, state):
    """The in-core model and optimizer state of an XL state: its topology,
    values, biases and velocities on the card."""
    topos = [sparsity.ElementTopology(l.in_dim, l.out_dim, l.rows, l.cols)
             for l in state.layers]
    core = SparseMLP.from_state(cfg, topos, [l.values for l in state.layers],
                                [l.bias for l in state.layers], device=CARD)
    vel = {k: tuple(torch.as_tensor(np.array(getattr(l, f)), device=CARD) for l in state.layers)
           for k, f in (("values", "velocity"), ("biases", "bias_vel"))}
    return core, SGDState(velocity=vel, step=torch.zeros((), dtype=torch.int32, device=CARD))


def xl_same_as_in_core(state, params, opt_state, what: str) -> None:
    """An XL state bit-equal to an in-core step's params and velocity."""
    for l, layer in enumerate(state.layers):
        for got, want in ((layer.values, params["values"][l]),
                          (layer.velocity, opt_state.velocity["values"][l]),
                          (layer.bias, params["biases"][l]),
                          (layer.bias_vel, opt_state.velocity["biases"][l])):
            check(np.array_equal(got, want.cpu().numpy()), f"{what}: layer {l} differs")


def xl_same_states(a, b, what: str) -> None:
    for l, (x, y) in enumerate(zip(a.layers, b.layers)):
        for f in ("rows", "cols", "perm_r", "values", "velocity", "bias", "bias_vel"):
            check(np.array_equal(np.asarray(getattr(x, f)), np.asarray(getattr(y, f))),
                  f"{what}: layer {l} {f} differs")


def xl_shard_checks(ex, rng: np.random.Generator) -> dict:
    """K8 on every shard of layer 1, at the main path's operands (layer 1's
    input from a streamed forward, a normal dz): ``xl_shard_acc`` chained
    over the shards, in place, against its plain version after every shard
    (within RTOL, ATOL) and, at the end, bit-equal to kernel A over the whole
    layer in one call (segments span shard edges); every row outside a
    shard's window untouched; ``xl_shard_dw`` on each shard bit-equal to
    kernel F over the whole layer, and against its plain version. Then
    kernel B's (features, batch) pass and G's standalone call at the
    layer's (500000, 32), against their plain versions. Returns the errors
    and the operands of a middle shard for the timings."""
    layer, C, d, B = ex.state.layers[1], ex.C, ex.d_max, ex.B
    src = ex.h[0]
    dz = torch.as_tensor(rng.standard_normal((d, B)).astype(np.float32), device=CARD)
    acc = torch.zeros((d, B), device=CARD)
    plain = torch.zeros((d, B), device=CARD)
    v_all = torch.as_tensor(np.asarray(layer.values), device=CARD)
    r_all = torch.as_tensor(np.asarray(layer.rows), device=CARD)
    c_all = torch.as_tensor(np.asarray(layer.cols), device=CARD)
    dv_whole = sparsity.coo_dw(src[: layer.in_dim], dz[: layer.out_dim], r_all, c_all)
    dv = torch.empty((C,), device=CARD)
    err_acc = err_dw = 0.0
    picked = None
    bounds = topology.element_shard_bounds(layer.nnz, C)
    for s, (lo, hi) in enumerate(bounds):
        vals = torch.zeros((C,), device=CARD)
        vals[: hi - lo] = v_all[lo:hi]
        gather = torch.zeros((C,), dtype=torch.int32, device=CARD)
        gather[: hi - lo] = r_all[lo:hi]
        seg = torch.full((C,), d, dtype=torch.int32, device=CARD)
        seg[: hi - lo] = c_all[lo:hi]
        window = ops.shard_window(seg, d, rows=gather)
        before = acc.clone()
        ops.xl_shard_acc(acc, src, vals, gather, n_segments=d, window=window)
        ops._xl_shard_acc_plain(plain, src, vals, gather, window, None)
        w = slice(window.lo, window.lo + window.n)
        err_acc = max(err_acc, float((acc[w] - plain[w]).abs().max()))
        torch.testing.assert_close(acc[w], plain[w], rtol=RTOL, atol=ATOL)
        outside = torch.ones(d, dtype=torch.bool, device=CARD)
        outside[w] = False
        check(torch.equal(acc[outside], before[outside]),
              f"xl_shard_acc wrote outside shard {s}'s window")
        ops.xl_shard_dw(src, dz, gather, window=window, out=dv)
        check(torch.equal(dv[: hi - lo], dv_whole[lo:hi]),
              f"xl_shard_dw on shard {s} differs from kernel F over the layer")
        want = ops._xl_shard_dw_plain(src, dz, gather, window, None, torch.zeros_like(dv))
        err_dw = max(err_dw, float((dv[: hi - lo] - want[: hi - lo]).abs().max()))
        torch.testing.assert_close(dv[: hi - lo], want[: hi - lo], rtol=RTOL, atol=ATOL)
        if s == len(bounds) // 2:
            picked = dict(vals=vals, gather=gather, window=window, hi_lo=hi - lo)
    seg_ptr = torch.searchsorted(c_all, torch.arange(layer.out_dim + 1, dtype=torch.int32,
                                                     device=CARD))
    whole = sparsity._coo_matmul_T_cuda(src, v_all, r_all, c_all, seg_ptr, layer.out_dim, None)
    check(torch.equal(acc[: layer.out_dim], whole),
          "xl_shard_acc over layer 1's shards is not bit-equal to kernel A over the layer")
    # kernel B's (features, batch) pass and G's standalone call at the layer's shape
    n = layer.out_dim
    bias = torch.as_tensor((0.1 * rng.standard_normal(n)).astype(np.float32), device=CARD)
    slope = ref.slope_for(XL_ALPHA, 2)
    y, mask = all_relu_fused.bias_all_relu_T(acc[:n], bias, slope,
                                             mask=torch.empty((n, B), dtype=torch.uint8,
                                                              device=CARD))
    py, pmask = all_relu_fused.bias_all_relu_T_plain(acc[:n], bias, slope, with_mask=True)
    check(torch.equal(y, py) and torch.equal(mask, pmask),
          "kernel B's (features, batch) pass differs from its plain version")
    gz, gb = all_relu_fused.all_relu_bwd(dz[:n], mask, slope)
    pz, pb = all_relu_fused.all_relu_bwd_plain(dz[:n], mask, slope)
    check(torch.equal(gz, pz), "kernel G's dz differs from its plain version")
    torch.testing.assert_close(gb, pb, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    torch.cuda.synchronize()
    return dict(err_acc=err_acc, err_dw=err_dw, err_b=float((y - py).abs().max()),
                err_g=float((gb - pb).abs().max()),
                shards=len(bounds), src=src, dz=dz, picked=picked, acc=acc, bias=bias,
                slope=slope, mask=mask, n=n)


def xl_timing_rows(chk: dict) -> list:
    """Device times of K8 on layer 1's middle shard (per shard), kernel B's
    (features, batch) pass and G's standalone call at (500000, 32), beside
    their bounds, plain versions and library calls: ``torch.sparse``'s CSR
    product over the shard's window for ``xl_shard_acc``, its sampled
    product (``sampled_addmm``) for ``xl_shard_dw``, ``torch.where`` on the
    biased pre-activation for B, ``torch.where`` and a row ``sum`` for G."""
    p, src, dz = chk["picked"], chk["src"], chk["dz"]
    w, k = p["window"], p["hi_lo"]
    B = src.shape[1]
    scratch = torch.zeros_like(chk["acc"])
    rows_used = int(torch.unique(p["gather"][:k]).numel())
    acc_bytes = (rows_used * B * 4 + k * 8 + (w.n + 1) * 8 + 2 * w.n * B * 4)
    dw_bytes = (rows_used * B * 4 + w.n * B * 4 + k * 4 + w.n_runs * 12 + k * 4)
    seg_ptr = w.seg_ptr[: w.n + 1]
    csr = torch.sparse_csr_tensor(seg_ptr, p["gather"][:k].long(), p["vals"][:k],
                                  (w.n, src.shape[0]))
    mask_csr = torch.sparse_csr_tensor(seg_ptr, p["gather"][:k].long(),
                                       torch.zeros(k, device=CARD), (w.n, src.shape[0]))
    dz_win = dz[w.lo: w.lo + w.n]
    dv = torch.empty_like(p["vals"])
    common = dict(layer=1, batch=B, shard_slots=k, segments=w.n, route=sparsity.coo_route(w.longest))
    n, y = chk["n"], chk["acc"][: chk["n"]]
    out_y = torch.empty_like(y)
    mask = torch.empty_like(chk["mask"])
    dz_n = dz[:n]
    # the library calls' inputs, made beforehand and not timed: the biased
    # pre-activation for B, the branch as a bool mask for G
    y_b = y + chk["bias"][:, None]
    branch = chk["mask"] != 0
    return [
        dict(kernel="xl_shard_acc", **common,
             ms=device_ms(lambda: ops.xl_shard_acc(scratch, src, p["vals"], p["gather"],
                                                   n_segments=src.shape[0], window=w)),
             plain_ms=device_ms(lambda: ops._xl_shard_acc_plain(scratch, src, p["vals"],
                                                                p["gather"], w, None)),
             library_ms=library_ms(lambda: torch.sparse.mm(csr, src)),
             **bound(acc_bytes, 2 * k * B)),
        dict(kernel="xl_shard_dw", **common, runs=w.n_runs,
             ms=device_ms(lambda: ops.xl_shard_dw(src, dz, p["gather"], window=w, out=dv)),
             plain_ms=device_ms(lambda: ops._xl_shard_dw_plain(src, dz, p["gather"], w, None,
                                                               dv)),
             library_ms=library_ms(lambda: torch.sparse.sampled_addmm(mask_csr, dz_win, src.T)),
             **bound(dw_bytes, 2 * k * B)),
        dict(kernel="bias_all_relu_T", layer=1, batch=B, shape=[n, B],
             ms=device_ms(lambda: all_relu_fused.bias_all_relu_T(y, chk["bias"], chk["slope"],
                                                                 out=out_y, mask=mask)),
             plain_ms=device_ms(lambda: all_relu_fused.bias_all_relu_T_plain(
                 y, chk["bias"], chk["slope"], with_mask=True)),
             library_ms=library_ms(lambda: torch.where(y_b > 0, y_b, y_b * chk["slope"])),
             **bound(n * B * 9 + n * 4, 3 * n * B)),
        dict(kernel="all_relu_bwd.xl", layer=1, batch=B, shape=[n, B],
             ms=device_ms(lambda: all_relu_fused.all_relu_bwd(dz_n, chk["mask"], chk["slope"])),
             plain_ms=device_ms(lambda: all_relu_fused.all_relu_bwd_plain(dz_n, chk["mask"],
                                                                          chk["slope"])),
             library_ms=library_ms(lambda: torch.where(branch, dz_n, dz_n * chk["slope"]).sum(1)),
             **bound(n * B * 9 + n * 4, 2 * n * B)),
    ]


def xl_step_timings(ex, loader, out: dict) -> dict:
    """The streamed step (host clock, each ending in the loss's sync):
    median and quartiles over XL_TIMED_STEPS steps, the executor's split of
    the host's time (gather into the pinned ring, issuing copies, waiting
    for events, the host update) and the bus's bytes per step, then a
    profile of two steps (device busy, idle share, the H2D copies' device
    time)."""
    batches = list(loader.epoch(0))
    ts, splits = [], []
    for i in range(XL_TIMED_STEPS):
        xb, yb = batches[i % len(batches)]
        ex.reset_stats()
        t0 = time.perf_counter()
        ex.train_step(xb, yb, XL_LR, momentum=0.9, weight_decay=2e-4)
        ts.append((time.perf_counter() - t0) * 1e3)
        splits.append(dict(ex.stats))
    q25, q50, q75 = np.percentile(ts, [25, 50, 75])
    split = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    xb, yb = batches[0]
    prof = profile_train_step(
        lambda: ex.train_step(xb, yb, XL_LR, momentum=0.9, weight_decay=2e-4), float(q50),
        steps=2)
    h2d_us = sum(v for k, v in prof["device_us_by_name"].items() if "HtoD" in k)
    d2h_us = sum(v for k, v in prof["device_us_by_name"].items() if "DtoH" in k)
    top = sorted(prof["device_us_by_name"].items(), key=lambda kv: -kv[1])[:8]
    return dict(streamed_step_ms=dict(median=float(q50), q25=float(q25), q75=float(q75),
                                      all=ts),
                host_gather_ms=split["gather_s"] * 1e3, host_copy_issue_ms=split["copy_s"] * 1e3,
                host_wait_ms=split["wait_s"] * 1e3, host_update_ms=split["update_s"] * 1e3,
                h2d_bytes_per_step=split["h2d_bytes"], d2h_bytes_per_step=split["d2h_bytes"],
                device_busy_us=prof["device_busy_us"], h2d_copy_device_us=h2d_us,
                d2h_copy_device_us=d2h_us, device_idle_share=prof["device_idle_share"],
                device_launches_per_step=prof["device_launches"],
                profiled_step_ms=prof["profiled_step_ms"], device_us_top=dict(top),
                host_self_us_top=prof["host_self_us_top"][:8], card=out["smi"])


def xl_in_core_step_ms(cfg, core: SparseMLP, topo, xb, yb) -> float:
    """The in-core element step of ``core`` at batch 32 (kernel A with its
    epilogue, F with G's): median of 20 after 5 warm-up steps."""
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    step = make_mlp_train_step(cfg, opt)
    x, y = torch.as_tensor(xb, device=CARD), torch.as_tensor(yb, device=CARD).long()
    lr = torch.tensor(XL_LR, device=CARD)
    st = {"p": core.params(), "o": opt.init(core.params())}
    ts = []
    for i in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st["p"], st["o"], _ = step(st["p"], st["o"], topo, x, y, lr, None)
        torch.cuda.synchronize()
        if i >= 5:
            ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def xl_launches_expected(plan, steps: int, eval_batches: int) -> dict:
    """The streamed run's launches: per forward, kernel A (xl_shard_acc) on
    every canonical shard and kernel B's (features, batch) pass on every
    layer; per step also A on every dual-order shard of layers 1 and up,
    F (xl_shard_dw) on every canonical shard, and G once per layer."""
    fwd = plan.n_shards_total
    dx = sum(lp.n_shards for lp in plan.layers[1:])
    n = plan.n_layers
    acc = (steps + eval_batches) * fwd + steps * dx
    return dict(NO_LAUNCHES, **{
        "coo_matmul_T": acc, "xl_shard_acc": acc, "coo_dw": steps * fwd, "xl_shard_dw": steps * fwd,
        "bias_all_relu": (steps + eval_batches) * n, "bias_all_relu.T": (steps + eval_batches) * n,
        "all_relu_bwd": steps * n})


def phase_xl(out: dict) -> str:
    t0 = time.perf_counter()
    data = make_extreme_dataset(n_samples=XL_SAMPLES, n_features=XL_DIMS[0], seed=SEED)
    nnz = [sparsity.erdos_renyi_nnz(XL_EPSILON, a, b) for a, b in zip(XL_DIMS, XL_DIMS[1:])]
    in_core_bytes = xl.estimate_in_core_bytes(XL_DIMS, nnz, XL_BATCH)
    plan = xl.plan_memory_budget(XL_DIMS, nnz, XL_BATCH,
                                 int(XL_BUDGET_FRACTION * in_core_bytes))
    got_plan = dict(in_core_bytes=in_core_bytes, budget_bytes=plan.budget_bytes,
                    peak_device_bytes=plan.peak_device_bytes,
                    shard_capacity=plan.shard_capacity, chunk=plan.chunk,
                    shards=[lp.n_shards for lp in plan.layers])
    cfg = xl_config(plan.chunk)
    host_model = SparseMLP(cfg, seed=SEED, device="cpu")  # the ER draw and init, on the host
    setup_s = time.perf_counter() - t0
    print(json.dumps({"xl_plan": dict(got_plan, layer_dims=list(XL_DIMS), nnz=nnz,
                                      topo_resident=[lp.topo_resident for lp in plan.layers],
                                      setup_s=setup_s)}))
    check(got_plan == XL_PLAN, f"the plan {got_plan} is not the reference's {XL_PLAN}")
    check([t.nnz for t in host_model.topos] == nnz, "the model's connections are not the plan's")
    loader = ShardedLoader(data.x_train, data.y_train, XL_BATCH, seed=SEED)
    steps = XL_EPOCHS * loader.steps_per_epoch
    eval_batches = XL_EPOCHS * -(-len(data.x_test) // XL_BATCH)
    xb, yb = next(loader.epoch(0))

    # one batch's logits and one step, streamed against in core
    state = xl.XLModelState.from_model(host_model, plan)
    ex = xl.StreamExecutor(state, CARD)
    logits = ex.logits(xb)
    core = SparseMLP.from_state(cfg, host_model.topos, host_model.values, host_model.biases,
                                device=CARD)
    topo = core.topo_arrays()
    with torch.no_grad():
        want = mlp_forward(core.params(), topo, torch.as_tensor(xb, device=CARD),
                           cfg).cpu().numpy()
    check(np.array_equal(logits, want), "streamed logits differ from the in-core forward's")
    loss = ex.train_step(xb, yb, XL_LR, momentum=0.9, weight_decay=2e-4)
    params, opt_state, ref_loss = xl_in_core_step(cfg, core, topo, xb, yb)
    check(loss == float(ref_loss), f"streamed step loss {loss} vs in-core {float(ref_loss)}")
    xl_same_as_in_core(state, params, opt_state, "one streamed step vs in core")
    in_core_step_ms = xl_in_core_step_ms(cfg, core, topo, xb, yb)
    del state, ex, core, topo, params, opt_state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the main path: 2 epochs streamed (no evolution), launches counted, the
    # allocator's peak over the run; then the in-core run in a window of its own
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tr = XLTrainer(xl.XLModelState.from_model(host_model, plan), data, xl_train_config(False),
                   plan, device=CARD)
    reset_counts()
    hist = tr.run()
    torch.cuda.synchronize()
    launches = read_counts()
    mem = dict(streamed_peak_bytes=torch.cuda.max_memory_allocated() - base,
               streamed_base_bytes=base, plan_peak_device_bytes=plan.peak_device_bytes,
               budget_bytes=plan.budget_bytes, port_extra_bytes=tr.executor.port_extra_bytes,
               measured_peak_bytes=tr.executor.measured_peak_bytes)
    want_launches = xl_launches_expected(plan, steps, eval_batches)
    check(launches == want_launches, f"streamed run launches {launches}, expected {want_launches}")
    del tr
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    core_tr = SequentialTrainer(
        SparseMLP.from_state(cfg, host_model.topos, host_model.values, host_model.biases,
                             device=CARD), data, xl_train_config(False))
    core_hist = core_tr.run()
    torch.cuda.synchronize()
    mem.update(in_core_peak_bytes=torch.cuda.max_memory_allocated() - base, in_core_base_bytes=base,
               card=out["smi"])
    print(json.dumps({"xl_memory": mem}))
    del core_tr
    torch.cuda.empty_cache()
    np.testing.assert_allclose(hist["train_loss"], core_hist["train_loss"], rtol=XL_HISTORY_RTOL)
    check(hist["test_acc"] == core_hist["test_acc"] and hist["n_params"] == core_hist["n_params"],
          f"streamed history {hist} vs in core {core_hist}")
    check(mem["streamed_peak_bytes"] <= plan.budget_bytes + mem["port_extra_bytes"],
          f"the streamed run's allocator peak exceeds the budget: {mem}")
    check(mem["streamed_peak_bytes"] < mem["in_core_peak_bytes"],
          f"the streamed run's allocator peak is not below the in-core run's: {mem}")

    # 2 epochs with shard-wise SET, saved after epoch 0: after the evolution
    # the invariants hold and the next streamed step is bit-equal to an
    # in-core step on the evolved topology; resumed from the checkpoint, the
    # run is bit-equal to the one that never stopped
    post: dict = {}
    evolve = xl.evolve_model_streamed

    def timed_evolve(*args, **kwargs):
        t = time.perf_counter()
        res = evolve(*args, **kwargs)
        post["evolution_s"] = time.perf_counter() - t
        post["evolution_stats"] = [{k: r[k] for k in ("n_pruned", "n_fallback")} for r in res]
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_xl_") as tmp:
        mgr = CheckpointManager(tmp, keep_last=XL_EPOCHS)

        def hook(trainer, epoch):
            if epoch != 0:
                return
            t = time.perf_counter()
            trainer.state.check_invariants()
            post["invariants_s"] = time.perf_counter() - t
            t = time.perf_counter()
            trainer.save_checkpoint(mgr)
            post["save_s"] = time.perf_counter() - t
            nxt = xl_copy(trainer.state)
            xb1, yb1 = next(loader.epoch(epoch + 1))
            core1, opt1 = xl_in_core_of(cfg, nxt)
            p2, s2, ref1 = xl_in_core_step(cfg, core1, core1.topo_arrays(), xb1, yb1, opt1)
            got1 = xl.StreamExecutor(nxt, CARD).train_step(xb1, yb1, XL_LR, momentum=0.9,
                                                           weight_decay=2e-4)
            check(got1 == float(ref1), f"post-evolution step loss {got1} vs {float(ref1)}")
            xl_same_as_in_core(nxt, p2, s2, "the step after the evolution vs in core")
            post["post_evolution_step"] = True

        evo = XLTrainer(xl.XLModelState.from_model(host_model, plan), data, xl_train_config(True),
                        plan, device=CARD)
        evo.epoch_end_hook = hook
        xl.evolve_model_streamed = timed_evolve
        try:
            evo_hist = evo.run()
        finally:
            xl.evolve_model_streamed = evolve
        check(post.get("post_evolution_step", False), "the post-evolution step was not checked")
        t = time.perf_counter()
        res = XLTrainer.from_checkpoint(mgr, data, xl_train_config(True), plan, device=CARD)
        post["restore_s"] = time.perf_counter() - t
        post["checkpoint_bytes"] = dir_bytes(Path(tmp))
        res_hist = res.run()
    same_history(res_hist, evo_hist, "the resumed XL run")
    xl_same_states(res.state, evo.state, "the resumed XL run's final state")
    print(json.dumps({"xl_history": {"streamed": hist, "in_core": core_hist,
                                     "streamed_evolution": evo_hist, "resumed": res_hist}}))

    # K8, kernel B's pass and G against their plain versions; the timings
    chk_ex = xl.StreamExecutor(res.state, CARD)
    chk_ex.forward(xb, train=True)
    chk = xl_shard_checks(chk_ex, np.random.default_rng(SEED))
    rows = xl_timing_rows(chk)
    for r in rows:
        print(json.dumps({"kernel_timing": r}))
    n_checked = chk["shards"]
    errs = {"xl_shard_acc": chk["err_acc"], "xl_shard_dw": chk["err_dw"],
            "bias_all_relu_T": chk["err_b"], "all_relu_bwd.xl": chk["err_g"]}
    del chk_ex, chk
    torch.cuda.empty_cache()
    timing = xl_step_timings(res.executor, loader, out)
    timing.update(in_core_step_ms=in_core_step_ms,
                  epoch_seconds={"streamed": hist["epoch_seconds"],
                                 "in_core": core_hist["epoch_seconds"]},
                  **{k: post[k] for k in ("evolution_s", "evolution_stats", "invariants_s",
                                          "save_s", "restore_s", "checkpoint_bytes")},
                  setup_s=setup_s)
    print(json.dumps({"xl_timing": timing}))
    per_step = {k: (launches[k] - (eval_batches * plan.n_shards_total if k == "xl_shard_acc"
                                   else 0)) / steps for k in ("xl_shard_acc", "xl_shard_dw")}
    counts = {"xl_shard_acc": launches["xl_shard_acc"], "xl_shard_dw": launches["xl_shard_dw"],
              "bias_all_relu_T": launches["bias_all_relu.T"],
              "all_relu_bwd.xl": launches["all_relu_bwd"]}
    for meta in (KERNEL_XL_ACC, KERNEL_XL_DW, KERNEL_B_T, KERNEL_G_XL):
        mine = [r for r in rows if r["kernel"] == meta["name"]]
        extra = dict(per="shard", shard_slots=mine[0]["shard_slots"],
                     launches_per_step=per_step[meta["name"]]) if "shard_slots" in mine[0] else {}
        out["kernels"].append(dict(kernel_entry(meta, mine, counts[meta["name"]],
                                                errs[meta["name"]]), **extra))
    return (
        f"dims {XL_DIMS}, nnz {nnz}, budget {plan.budget_bytes} B < in-core {in_core_bytes} B, "
        f"capacity {plan.shard_capacity}, shards {got_plan['shards']}; logits and one step "
        f"bit-equal to in core; 2 epochs loss {hist['train_loss']} vs in core "
        f"{core_hist['train_loss']}, acc {hist['test_acc']} equal; after the evolution the "
        f"invariants hold and the next step is bit-equal to in core; resumed from epoch 0 "
        f"bit-equal; K8 on layer 1's {n_checked} shards max_abs_err acc "
        f"{errs['xl_shard_acc']:.3g}, dw {errs['xl_shard_dw']:.3g}, chained bit-equal to A over "
        f"the layer; allocator peak {mem['streamed_peak_bytes']} B (budget {plan.budget_bytes} + "
        f"port extra {mem['port_extra_bytes']}; in core {mem['in_core_peak_bytes']} B); launches "
        f"{launches}; streamed step median {timing['streamed_step_ms']['median']:.1f} ms (in core "
        f"{timing['in_core_step_ms']:.2f} ms), H2D {timing['h2d_bytes_per_step'] / 1e6:.1f} MB a "
        f"step, idle share {timing['device_idle_share']:.3f}; evolution {post['evolution_s']:.1f} s"
    )


def kernel_entry(meta: dict, rows: list, launches: int, max_abs_err: float) -> dict:
    """A ``kernels``-line entry: device times summed over ``rows`` (the
    launches of one call of the path), its bound, and the library's."""
    keys = ("ms", "plain_ms", "bound_ms") + (
        ("bound_tc_ms",) if all("bound_tc_ms" in r for r in rows) else ())
    total = {k: sum(r[k] for r in rows) for k in keys}
    lib = [r["library_ms"] for r in rows]
    return dict(
        meta, launches=launches, max_abs_err=max_abs_err, **total,
        bound_by=bound(sum(r["bytes"] for r in rows), sum(r["ops"] for r in rows))["bound_by"],
        library_ms=None if None in lib else sum(lib),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card", file=sys.stderr)
        return 1
    out: dict = {}
    for name, phase in (
        ("device", phase_device), ("build", phase_build), ("kernels", phase_kernels),
        ("block_kernels", phase_block_kernels), ("element_kernels", phase_element_kernels),
        ("main", phase_main), ("train", phase_train), ("element_train", phase_element_train),
        ("evolution", phase_evolution),
        ("element_train_device_evolution", phase_element_train_device_evolution),
        ("block_train_device_evolution", phase_block_train_device_evolution),
        ("timings", phase_timings), ("train_timings", phase_train_timings),
        # the paper's masked and dense baselines beside the truly sparse steps
        ("baselines", phase_baselines),
        # the bf16 LM's serving path, its profile beside the other timing phases'
        ("lm", phase_lm),
        # the LM compacted at deployment: zero blocks freed, importance pruning
        ("lm_compact", phase_lm_compact),
        # its training path: kernels D and E bf16 as C bf16's backward
        ("lm_train", phase_lm_train),
        # the rest of the zoo: RG-LRU (on C, D and E bf16), Mamba-1 and MoE
        ("lm_archs", phase_lm_archs),
        # Whisper-medium at full width and depth, and the observability layer
        ("whisper", phase_whisper), ("obs", phase_obs),
        # after the timing phases: run before them, it made their
        # torch.profiler sessions lose device events (PERF.md §7)
        ("wasap", phase_wasap), ("checkpoint", phase_checkpoint), ("xl", phase_xl),
    ):
        t0 = time.perf_counter()
        try:
            line = phase(out)
        except Exception as e:  # report which phase failed, then exit non-zero
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
                  f"{type(e).__name__}: {e}", flush=True)
            raise
        print(f"[{name}] {line} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": out["name"], "count": out["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
