"""The port's block-granularity compaction (``serve.compact``'s block half:
``_free_empty_blocks``, ``_repad_blocks``, ``_keep_mask_from``,
``compact_block_lm``) and the engine's block, masked and dense SET-MLP
serving against the JAX reference on the CPU. The card's run:
``test_torch_gpu.py`` and ``chip_smoke.py``'s ``lm_compact`` phase.

Compaction is host numpy in both packages, so masks, topologies, values
and reports are held equal, bit for bit, also for a bfloat16 model. An LM
whose zeroed blocks are freed computes the same logits as before; a
compacted engine's greedy tokens are the reference's. Served SET-MLPs of
the three other impls answer within rtol = atol = 1e-5 of the reference's
engine (f32), with ``compact=False``: compaction is for element models, and
the port refuses it with a ``ValueError`` where the reference crashes.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import sparsity as jsparsity  # noqa: E402
from repro.core.importance import PruningSchedule as JSchedule  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import SparseInferenceEngine as JEngine  # noqa: E402
from repro.serve import compact as jcompact  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import sparsity  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.interop import lm_from_numpy, mlp_from_numpy  # noqa: E402
from repro_torch.models.transformer import PatternLM  # noqa: E402
from repro_torch.serve import EngineConfig, SparseInferenceEngine, compact  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LM_FIELDS = dict(ffn="sparse", sparse_block=16, sparse_density=0.5, d_ff=64)
LM_CFG = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
JLM_CFG = dataclasses.replace(jconfigs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
EC = dict(max_slots=4, max_len=48, prefill_buckets=(8, 16), prefill_batch=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_of(jm, device="cpu"):
    topos = {slot: [((a.rows, a.cols), (b.rows, b.cols)) for a, b in reps]
             for slot, reps in jm.topologies.items()}
    return lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params),
                         topos, seed=jm._seed, device=device)


def _topo_pair(seed, density=0.6, zero_frac=0.4):
    """A block topology of both packages from one draw, and values with a
    share of whole blocks zeroed."""
    meta = dict(in_dim=48, out_dim=64, block_m=8, block_n=8)
    rng = np.random.default_rng(seed)
    jt = jsparsity.BlockTopology.erdos_renyi(jsparsity.BlockMeta(**meta), density, rng)
    tt = sparsity.BlockTopology(sparsity.BlockMeta(**meta), jt.rows, jt.cols)
    vals = rng.standard_normal((jt.n_blocks, 8, 8)).astype(np.float32)
    vals[rng.random(jt.n_blocks) < zero_frac] = 0.0
    return jt, tt, vals


def _same_topology(a, b):
    np.testing.assert_array_equal(a.rows, b.rows)
    np.testing.assert_array_equal(a.cols, b.cols)
    assert (a.meta.in_dim, a.meta.out_dim, a.meta.block_m, a.meta.block_n) == (
        b.meta.in_dim, b.meta.out_dim, b.meta.block_m, b.meta.block_n)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_free_empty_blocks_matches_reference(seed):
    jt, tt, vals = _topo_pair(seed)
    jkeep, jnew, jv = jcompact._free_empty_blocks(jt, vals)
    tkeep, tnew, tv = compact._free_empty_blocks(tt, vals)
    np.testing.assert_array_equal(tkeep, jkeep)
    _same_topology(tnew, jnew)
    np.testing.assert_array_equal(tv, jv)
    # coverage kept; every freed block was all zero
    assert np.unique(tnew.cols).size == tt.meta.grid_n
    assert not np.abs(vals[~tkeep]).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repad_blocks_matches_reference(seed):
    """Zero blocks resurrected at freed positions, re-sorted among the live
    ones into canonical (col, row) order."""
    jt, tt, vals = _topo_pair(seed)
    keep, t2, v2 = compact._free_empty_blocks(tt, vals)
    target = tt.n_blocks - max(0, (~keep).sum() - 2)
    tnew, tv = compact._repad_blocks(tt.meta, t2.rows, t2.cols, v2, tt.rows[~keep],
                                     tt.cols[~keep], target)
    jnew, jv = jcompact._repad_blocks(jt.meta, t2.rows, t2.cols, v2, jt.rows[~keep],
                                      jt.cols[~keep], target)
    _same_topology(tnew, jnew)
    np.testing.assert_array_equal(tv, jv)
    assert tnew.n_blocks == max(target, t2.n_blocks)
    order = np.lexsort((tnew.rows, tnew.cols))
    np.testing.assert_array_equal(order, np.arange(tnew.n_blocks))


@pytest.mark.parametrize("seed", [0, 1])
def test_keep_mask_from_matches_reference(seed):
    jt, tt, vals = _topo_pair(seed)
    _, jnew, _ = jcompact._free_empty_blocks(jt, vals)
    _, tnew, _ = compact._free_empty_blocks(tt, vals)
    want = jcompact._keep_mask_from(jt, jnew)
    got = compact._keep_mask_from(tt, tnew)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == tnew.n_blocks


# ---------------------------------------------------------------------------
# compact_block_lm
# ---------------------------------------------------------------------------


def _same_lm_state(tm, jm):
    assert tm.topologies.keys() == jm.topologies.keys()
    for slot, reps in jm.topologies.items():
        for (ja, jb), (ta, tb) in zip(reps, tm.topologies[slot]):
            _same_topology(ta, ja)
            _same_topology(tb, jb)
        for name in ("win", "wout"):
            want = np.asarray(jm.params["stack"][slot]["ffn"][name], np.float32)
            got = tm.params["stack"][slot]["ffn"][name].float().numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("schedule", [
    dict(percentile=10.0), dict(percentile=30.0), dict(percentile=60.0), dict(threshold=0.0),
])
def test_compact_block_lm_matches_reference(schedule):
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    jrep = jcompact.compact_block_lm(jm, JSchedule(tau=0, period=1, **schedule))
    trep = compact.compact_block_lm(tm, PruningSchedule(tau=0, period=1, **schedule))
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    _same_lm_state(tm, jm)
    if "percentile" in schedule:
        assert trep.pruned_neurons > 0 and trep.params_after < trep.params_before


def test_compact_block_lm_bf16_keeps_dtype_and_bits():
    """f32 staging is exact for bf16: the compacted bf16 weights are the
    reference's compaction of the same weights, bit for bit."""
    fields = dict(LM_FIELDS, dtype="bfloat16")
    jm = JPatternLM(dataclasses.replace(jconfigs.get_spec("qwen1.5-0.5b").smoke, **fields),
                    seed=1)
    tm = _port_of(jm)
    sched = dict(tau=0, period=1, percentile=30.0)
    jrep = jcompact.compact_block_lm(jm, JSchedule(**sched))
    trep = compact.compact_block_lm(tm, PruningSchedule(**sched))
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    for slot in tm.topologies:
        for name in ("win", "wout"):
            assert tm.params["stack"][slot]["ffn"][name].dtype == torch.bfloat16
    _same_lm_state(tm, jm)


def test_compact_block_lm_refuses_remainder_layers():
    cfg = dataclasses.replace(LM_CFG, pattern=("global", "local"), n_layers=3, window=4)
    model = PatternLM(cfg, seed=0, device="cpu")
    assert "rest0" in model.topologies
    with pytest.raises(ValueError, match="stacked"):
        compact.compact_block_lm(model, PruningSchedule(tau=0, period=1, percentile=30.0))


def test_block_compaction_frees_zeroed_blocks_losslessly():
    """The twin of tests/test_serve.py's: zero, per rep, the blocks of a
    W_in block-column that owns two or more; compaction with a threshold
    that prunes nothing frees them (fewer stacked blocks) without changing
    the forward."""
    model = PatternLM(LM_CFG, seed=2, device="cpu")
    slot = next(iter(model.topologies))
    ffn = model.params["stack"][slot]["ffn"]
    win = ffn["win"].clone()
    for r, (t_in, _) in enumerate(model.topologies[slot]):
        counts = np.bincount(t_in.cols, minlength=t_in.meta.grid_n)
        col = int(np.argmax(counts))
        assert counts[col] >= 2, "raise density: no donor column"
        win[r, torch.as_tensor(t_in.cols == col)] = 0.0
    ffn["win"] = win
    tokens = torch.as_tensor(np.random.default_rng(6).integers(0, LM_CFG.vocab, (2, 8)))
    with torch.inference_mode():
        before, _, _ = model.forward(model.params, tokens, topo=model.topo_arrays())
    nb_before = ffn["win"].shape[1]
    eng = SparseInferenceEngine(
        model, engine=EngineConfig(max_slots=1, max_len=32, prefill_buckets=(8,),
                                   prefill_batch=1),
        compaction=PruningSchedule(tau=0, period=1, threshold=0.0), device="cpu")
    nb_after = eng.model.params["stack"][slot]["ffn"]["win"].shape[1]
    assert nb_after < nb_before
    assert eng._topo[slot][0].rows.shape == (LM_CFG.n_rep, nb_after)
    with torch.inference_mode():
        after, _, _ = eng.model.forward(eng.model.params, tokens, topo=eng._topo)
    np.testing.assert_allclose(before.numpy(), after.numpy(), atol=1e-6)
    assert eng.report.params_after == eng.report.params_before


def test_compacted_engine_tokens_match_reference():
    """Compacted at the 30th percentile by both engines: the same report,
    then prefill two prompts into slots 1 and 3 and decode all slots 6
    steps: the reference engine's tokens."""
    sched = dict(tau=0, period=1, percentile=30.0)
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    jeng = JEngine(jm, engine=JEngineConfig(**EC), compaction=JSchedule(**sched))
    teng = SparseInferenceEngine(tm, engine=EngineConfig(**EC),
                                 compaction=PruningSchedule(**sched), device="cpu")
    assert dataclasses.asdict(teng.report) == dataclasses.asdict(jeng.report)
    assert teng.report.pruned_neurons > 0
    _same_lm_state(teng.model, jeng.model)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, LM_CFG.vocab, n).astype(np.int32) for n in (5, 12)]
    slots = [1, 3]
    want = jeng.prefill(prompts, slots)
    np.testing.assert_array_equal(teng.prefill(prompts, slots), want)
    tokens = np.zeros(4, np.int32)
    pos = np.full(4, EC["max_len"] - 1, np.int64)
    tokens[slots], pos[slots] = want, [5, 12]
    for _ in range(6):
        want = jeng.decode_step(tokens, pos)
        got = teng.decode_step(tokens, pos)
        np.testing.assert_array_equal(got[slots], want[slots])
        tokens[slots] = want[slots]
        pos[slots] += 1


# ---------------------------------------------------------------------------
# serving block, masked and dense SET-MLPs
# ---------------------------------------------------------------------------

MLP_FIELDS = dict(layer_dims=(32, 24, 20, 6), epsilon=6, dropout=0.0, block_m=8, block_n=8)


def _mlp_pair(impl, seed):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**MLP_FIELDS, impl=impl), seed=seed)
    rng = np.random.default_rng(seed + 50)
    jm.biases = [jnp.asarray(rng.standard_normal(b.shape).astype(np.float32))
                 for b in jm.biases]
    tm = mlp_from_numpy(dataclasses.asdict(jm.config),
                        [None if t is None else (t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    return jm, tm


@pytest.mark.parametrize("impl", ["block", "masked", "dense"])
def test_engine_serves_other_impls_without_compaction(impl):
    jm, tm = _mlp_pair(impl, 4)
    ec = dict(batch_buckets=(1, 8, 32))
    teng = SparseInferenceEngine(tm, engine=EngineConfig(**ec), compact=False, device="cpu")
    jeng = JEngine(jm, engine=JEngineConfig(**ec), compact=False)
    assert teng.report is None
    x = np.random.default_rng(5).standard_normal((45, 32)).astype(np.float32)
    for n in (1, 5, 32, 45):
        got = teng.classify(x[:n])
        assert got.shape == (n, 6)
        np.testing.assert_allclose(got, jeng.classify(x[:n]), rtol=1e-5, atol=1e-5)
    assert teng.jit_entry_sizes() == {("classify", 1): 1, ("classify", 8): 1,
                                      ("classify", 32): 1}


@pytest.mark.parametrize("impl", ["block", "masked", "dense"])
def test_engine_refuses_compaction_of_other_impls(impl):
    _, tm = _mlp_pair(impl, 5)
    for kwargs in (dict(), dict(compaction=PruningSchedule(tau=0, period=1, percentile=30.0))):
        with pytest.raises(ValueError, match="compaction is for element models"):
            SparseInferenceEngine(tm, device="cpu", **kwargs)
