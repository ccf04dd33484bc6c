"""The port's LM serving path (``SparseInferenceEngine``'s LM kind,
``ContinuousBatcher``, ``serve_sequential``, LM checkpoints) against the JAX
reference on the CPU, on the reference's serving config (``LM_CFG`` of
``tests/test_serve.py``, f32). The card's run: ``test_torch_gpu.py`` and
``chip_smoke.py``'s ``lm`` phase.

Greedy tokens are held equal token for token: to the reference engine's
(the same weights, carried over), between continuous batching and the
sequential loop, and from a checkpoint of either package. A port-saved
checkpoint has the reference's file names and byte-identical arrays.
"""
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import SparseInferenceEngine as JEngine  # noqa: E402
from repro.serve import save_lm_for_serving as jsave_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.importance import PruningSchedule  # noqa: E402
from repro_torch.interop import lm_from_numpy  # noqa: E402
from repro_torch.models.transformer import PatternLM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    EngineConfig,
    SparseInferenceEngine,
    poisson_trace,
    save_lm_for_serving,
    serve_sequential,
)

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


def _trace(seed, n=8, **kw):
    kw = dict(dict(prompt_lens=(3, 14), new_tokens=(1, 6)), **kw)
    return poisson_trace(n, rate=500.0, vocab=LM_CFG.vocab, seed=seed, **kw)


@pytest.fixture(scope="module")
def lm_serving():
    """The reference's serving fixture on the port: one LM served by the
    continuous batcher (4 slots) and by the sequential loop (a fresh
    one-slot engine from the same checkpoint), after one warm-up trace."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ec = EngineConfig(**EC)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, async_write=False)
        save_lm_for_serving(mgr, PatternLM(LM_CFG, seed=0, device="cpu"), step=0)
        engine = SparseInferenceEngine.from_checkpoint(d, engine=ec, device="cpu")
        naive = SparseInferenceEngine.from_checkpoint(
            d, engine=dataclasses.replace(ec, max_slots=1, prefill_batch=1), device="cpu")
    ContinuousBatcher(engine, queue_capacity=16).run(_trace(0))
    batched_trace, naive_trace = _trace(7), _trace(7)
    out = {
        "engine": engine,
        "batched_trace": batched_trace,
        "batched_stats": ContinuousBatcher(engine, queue_capacity=16).run(batched_trace),
        "naive_trace": naive_trace,
        "naive_stats": serve_sequential(naive, naive_trace),
    }
    torch.set_num_threads(n)
    return out


def test_engine_greedy_tokens_match_reference_engine():
    """Prefill two prompts of one bucket into slots 1 and 3, then decode all
    slots 6 steps at their own positions: the reference engine's tokens."""
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    jeng = JEngine(jm, engine=JEngineConfig(**EC))
    teng = SparseInferenceEngine(tm, engine=EngineConfig(**EC), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, LM_CFG.vocab, n).astype(np.int32) for n in (5, 12)]
    slots = [1, 3]
    want = jeng.prefill(prompts, slots)
    got = teng.prefill(prompts, slots)
    np.testing.assert_array_equal(got, want)
    tokens = np.zeros(4, np.int32)
    pos = np.full(4, EC["max_len"] - 1, np.int64)
    tokens[slots], pos[slots] = want, [5, 12]
    for _ in range(6):
        want = jeng.decode_step(tokens, pos)
        got = teng.decode_step(tokens, pos)
        np.testing.assert_array_equal(got[slots], want[slots])
        tokens[slots] = want[slots]
        pos[slots] += 1


def test_batcher_tokens_match_reference_batcher():
    """The same trace through both packages' continuous batchers: every
    request's greedy tokens equal (scheduling may group them differently;
    tokens do not depend on it)."""
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    jtrace, ttrace = _trace(5), _trace(5)
    JBatcher(JEngine(jm, engine=JEngineConfig(**EC)), queue_capacity=16).run(jtrace)
    ContinuousBatcher(SparseInferenceEngine(tm, engine=EngineConfig(**EC), device="cpu"),
                      queue_capacity=16).run(ttrace)
    for rj, rt in zip(jtrace, ttrace):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert rt.tokens == rj.tokens, rt.rid


def test_continuous_batching_matches_naive_tokens(lm_serving):
    for r_b, r_n in zip(lm_serving["batched_trace"], lm_serving["naive_trace"]):
        assert r_b.tokens == r_n.tokens, r_b.rid
        assert len(r_b.tokens) == r_b.max_new_tokens


def test_lm_serving_completes_and_measures(lm_serving):
    s = lm_serving["batched_stats"]
    assert s.completed == len(lm_serving["batched_trace"])
    assert s.rejected == 0
    assert s.generated_tokens == sum(r.max_new_tokens for r in lm_serving["batched_trace"])
    assert s.throughput_tok_s > 0
    assert s.latency_p99_ms >= s.latency_p50_ms > 0


def test_zero_rebuilds_after_warmup(lm_serving):
    engine = lm_serving["engine"]
    before = engine.stats["compiles"]
    ContinuousBatcher(engine, queue_capacity=16).run(_trace(11))
    assert engine.stats["compiles"] == before
    assert set(engine.jit_entry_sizes()) <= {("prefill", 8), ("prefill", 16), ("decode",)}
    assert all(v == 1 for v in engine.jit_entry_sizes().values())


def test_backpressure_and_admission(lm_serving):
    engine = lm_serving["engine"]
    b = ContinuousBatcher(engine, queue_capacity=2)
    vocab = LM_CFG.vocab
    ok = [b.submit(poisson_trace(1, 1.0, vocab=vocab, seed=s)[0]) for s in range(5)]
    assert sum(ok) == 2  # queue bound enforced immediately
    too_long = poisson_trace(1, 1.0, vocab=vocab, seed=0)[0]
    too_long.prompt = np.zeros((17,), np.int32)  # > largest bucket (16)
    assert not b.submit(too_long) and "bucket" in too_long.rejected
    over_budget = poisson_trace(1, 1.0, vocab=vocab, seed=0)[0]
    over_budget.prompt = np.zeros((10,), np.int32)
    over_budget.max_new_tokens = 100  # 10 + 100 > max_len 48
    assert not b.submit(over_budget) and "max_len" in over_budget.rejected


def test_eviction_and_join_in_place_under_saturated_queue(lm_serving):
    engine = lm_serving["engine"]
    b = ContinuousBatcher(engine, queue_capacity=4)
    trace = poisson_trace(30, rate=2000.0, vocab=LM_CFG.vocab, prompt_lens=(3, 14),
                          new_tokens=(2, 5), seed=3)
    st = b.run(trace)
    assert st.rejected > 0
    assert all(r.rejected in (None, "queue full") for r in trace)
    admitted = [r for r in trace if r.rejected is None]
    assert st.completed == len(admitted)
    assert all(len(r.tokens) == r.max_new_tokens for r in admitted)
    assert st.completed > engine.cfg.max_slots
    assert b.prefill_calls > 1


def test_poisson_trace_matches_reference():
    from repro.serve import poisson_trace as jtrace
    for rj, rt in zip(jtrace(6, 40.0, vocab=512, seed=4, deadline_s=0.5),
                      poisson_trace(6, 40.0, vocab=512, seed=4, deadline_s=0.5)):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert (rt.max_new_tokens, rt.arrival, rt.deadline_s) == (
            rj.max_new_tokens, rj.arrival, rj.deadline_s)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_reference_checkpoint_serves_the_reference_engines_tokens(tmp_path):
    jm = JPatternLM(JLM_CFG, seed=1)
    jsave_lm(JManager(str(tmp_path), async_write=False), jm, step=0)
    ec = dict(EC, max_slots=2)
    jeng = JEngine.from_checkpoint(str(tmp_path), engine=JEngineConfig(**ec))
    teng = SparseInferenceEngine.from_checkpoint(str(tmp_path), engine=EngineConfig(**ec),
                                                 device="cpu")
    for (ja, jb), (ta, tb) in zip(jm.topologies["s0_global"],
                                  teng.model.topologies["s0_global"]):
        np.testing.assert_array_equal(ta.rows, ja.rows)
        np.testing.assert_array_equal(tb.cols, jb.cols)
    prompts = [np.random.default_rng(2).integers(0, LM_CFG.vocab, 9).astype(np.int32)]
    tok = jeng.prefill(prompts, [0])
    np.testing.assert_array_equal(teng.prefill(prompts, [0]), tok)
    tokens, pos = np.array([tok[0], 0], np.int32), np.array([9, 47])
    for _ in range(5):
        want = jeng.decode_step(tokens, pos)
        np.testing.assert_array_equal(teng.decode_step(tokens, pos)[0], want[0])
        tokens[0], pos[0] = want[0], pos[0] + 1


def test_lm_checkpoint_roundtrip_forward_equal(tmp_path):
    model = PatternLM(LM_CFG, seed=1, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, LM_CFG.vocab, (2, 10)))
    want, _, _ = model.forward(model.params, tokens, topo=model.topo_arrays())
    save_lm_for_serving(CheckpointManager(str(tmp_path), async_write=False), model, step=1)
    eng = SparseInferenceEngine.from_checkpoint(
        str(tmp_path), compact=False, device="cpu",
        engine=EngineConfig(max_slots=1, max_len=32, prefill_buckets=(16,), prefill_batch=1))
    got, _, _ = eng.model.forward(eng.model.params, tokens, topo=eng.model.topo_arrays())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_save_writes_the_reference_files(tmp_path, dtype):
    """The same tree saved by both packages: the same file names, the same
    array bytes, the same topologies and meta."""
    jm = JPatternLM(dataclasses.replace(JLM_CFG, dtype=dtype, pattern=("local", "global"),
                                        n_layers=3, window=8), seed=2)
    tm = _port_of(jm)
    jsave_lm(JManager(str(tmp_path / "ref"), async_write=False), jm, step=3)
    save_lm_for_serving(CheckpointManager(str(tmp_path / "port"), async_write=False), tm,
                        step=3)
    ref_dir, port_dir = tmp_path / "ref" / "step_000000003", tmp_path / "port" / "step_000000003"

    def files(root: Path):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert files(port_dir) == files(ref_dir)
    for name in files(ref_dir):
        if name.startswith("arrays/"):
            assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
        elif name.startswith("topology/"):
            a, b = np.load(port_dir / name), np.load(ref_dir / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    jman, tman = JManager(str(tmp_path / "ref")), CheckpointManager(str(tmp_path / "port"))
    jmeta, tmeta = jman.read_manifest(3)["meta"], tman.read_manifest(3)["meta"]
    assert tmeta == jmeta
    assert tman.read_manifest(3)["shapes"] == jman.read_manifest(3)["shapes"]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_lm_engine_refusals():
    # a compaction schedule is taken now (tests/test_torch_compact.py holds
    # it against the reference's): the engine compacts, then serves
    model = PatternLM(LM_CFG, seed=0, device="cpu")
    eng = SparseInferenceEngine(model, compaction=PruningSchedule(tau=0, period=1,
                                                                  percentile=10.0),
                                engine=EngineConfig(**EC), device="cpu")
    assert eng.report is not None and eng.report.pruned_neurons > 0
    assert eng.report.params_after < eng.report.params_before
    with pytest.raises(ValueError, match="prefix-LM"):
        SparseInferenceEngine(PatternLM(dataclasses.replace(LM_CFG, prefix_len=4), seed=0,
                                        device="cpu"), device="cpu")
    local = PatternLM(dataclasses.replace(LM_CFG, pattern=("local",), window=4), seed=0,
                      device="cpu")
    eng = SparseInferenceEngine(local, engine=EngineConfig(**EC), device="cpu")
    assert not eng.model.cfg.decode_window_cache
    assert "pos" not in eng._caches["stack"]["s0_local"]
    with pytest.raises(TypeError, match="MLP engine"):
        eng.classify(np.zeros((1, 4), np.float32))


def test_serve_example_refuses_unported_flags_and_runs_on_cpu(capsys):
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "examples" / "serve_torch.py"
    spec = importlib.util.spec_from_file_location("serve_torch_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    pruned = example.main(["--prune-pct", "10", "--requests", "4", "--rate", "400",
                           "--device", "cpu"])
    assert pruned.completed == 4 and "neurons pruned" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1, item 4"):
        example.main(["--trace", "out.jsonl", "--device", "cpu"])
    stats = example.main(["--requests", "4", "--rate", "400", "--device", "cpu"])
    assert stats.completed == 4 and "continuous batching" in capsys.readouterr().out
