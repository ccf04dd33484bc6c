"""The port's deployment-time compaction and inference engine against the
JAX reference on the CPU (the engine on the card: ``test_torch_gpu.py``).

Compaction is host numpy in both packages, so topologies, dims, values and
reports are held equal; compacted logits are held bit-equal to the model
they came from (the plain version adds in slot order, as kernel A does).
A model saved for serving and restored by ``from_checkpoint`` answers
bit-equal to the live one; a reference-saved one within rtol = atol = 1e-5
of the reference's engine.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.importance import PruningSchedule as JSchedule
from repro.core.sparsity import ElementTopology as JTopo
from repro.models import mlp as jmlp
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import SparseInferenceEngine as JEngine
from repro.serve import compact as jcompact
from repro.serve import save_mlp_for_serving as jsave_mlp_for_serving
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.importance import PruningSchedule
from repro_torch.interop import mlp_from_numpy
from repro_torch.models import mlp as tmlp
from repro_torch.models.transformer import PatternLM
from repro_torch.serve import (
    EngineConfig,
    SparseInferenceEngine,
    compact_element_mlp,
    eliminate_dead_neurons,
    importance_prune_mlp,
    save_lm_for_serving,
    save_mlp_for_serving,
)

jax.config.update("jax_platform_name", "cpu")

FIELDS = dict(layer_dims=(32, 24, 20, 6), epsilon=6, impl="element", dropout=0.0)
SCHEDULE = dict(tau=0, period=1, percentile=30.0)


def _jax_model(seed, dead=False):
    """A reference model with nonzero biases; ``dead`` kills neurons {3, 4}
    of hidden layer 1 by in-degree (bias zeroed) and neuron 7 by out-degree,
    as tests/test_serve.py does."""
    m = jmlp.SparseMLP(jmlp.SparseMLPConfig(**FIELDS), seed=seed)
    rng = np.random.default_rng(seed + 50)
    biases = [rng.standard_normal(b.shape).astype(np.float32) for b in m.biases]
    if dead:
        t0 = m.topos[0]
        keep = ~np.isin(t0.cols, [3, 4])
        m.topos[0] = JTopo(t0.in_dim, t0.out_dim, t0.rows[keep], t0.cols[keep])
        m.values[0] = m.values[0][np.flatnonzero(keep)]
        biases[0][[3, 4]] = 0.0
        t1 = m.topos[1]
        keep = t1.rows != 7
        m.topos[1] = JTopo(t1.in_dim, t1.out_dim, t1.rows[keep], t1.cols[keep])
        m.values[1] = m.values[1][np.flatnonzero(keep)]
    m.biases = [jnp.asarray(b) for b in biases]
    return m


def _port(jm, device="cpu"):
    return mlp_from_numpy(
        dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases], device,
    )


def _logits(model, x):
    return tmlp.mlp_forward(model.params(), model.topo_arrays(),
                            torch.as_tensor(x, device=model.device), model.config,
                            infer=True).cpu().numpy()


def _jax_logits(model, x):
    return np.asarray(jmlp.mlp_forward(model.params(), model.topo_arrays(),
                                       jnp.asarray(x), model.config, infer=True))


def _assert_same_model(tm, jm):
    assert tm.config.layer_dims == jm.config.layer_dims
    for l in range(jm.config.n_layers):
        np.testing.assert_array_equal(tm.topos[l].rows, jm.topos[l].rows)
        np.testing.assert_array_equal(tm.topos[l].cols, jm.topos[l].cols)
        np.testing.assert_array_equal(tm.values[l].numpy(), np.asarray(jm.values[l]))
        np.testing.assert_array_equal(tm.biases[l].numpy(), np.asarray(jm.biases[l]))


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 32)).astype(np.float32)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_elimination_matches_reference_and_is_bit_equal(seed):
    jm = _jax_model(seed, dead=True)
    tm = _port(jm)
    x = _x(seed, 16)
    before = _logits(tm, x)
    t_out, t_rep = eliminate_dead_neurons(tm)
    j_out, j_rep = jcompact.eliminate_dead_neurons(jm)
    _assert_same_model(t_out, j_out)
    assert dataclasses.asdict(t_rep) == dataclasses.asdict(j_rep)
    assert t_rep.eliminated_neurons == 3
    np.testing.assert_array_equal(_logits(t_out, x), before)
    np.testing.assert_allclose(_logits(t_out, x), _jax_logits(j_out, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("percentile", [10.0, 30.0])
def test_importance_compaction_matches_reference(percentile):
    jm = _jax_model(2)
    tm = _port(jm)
    sched = dict(SCHEDULE, percentile=percentile)
    t_pruned, t_n = importance_prune_mlp(tm, PruningSchedule(**sched))
    j_pruned, j_n = jcompact.importance_prune_mlp(jm, JSchedule(**sched))
    assert t_n == j_n > 0
    _assert_same_model(t_pruned, j_pruned)
    t_out, t_rep = compact_element_mlp(tm, PruningSchedule(**sched))
    j_out, j_rep = jcompact.compact_element_mlp(jm, JSchedule(**sched))
    _assert_same_model(t_out, j_out)
    assert dataclasses.asdict(t_rep) == dataclasses.asdict(j_rep)
    x = _x(3, 9)
    # lossless stage: compacted logits bit-equal to the pruned model's
    np.testing.assert_array_equal(_logits(t_out, x), _logits(t_pruned, x))
    np.testing.assert_allclose(_logits(t_out, x), _jax_logits(j_out, x), rtol=1e-5, atol=1e-5)


def test_compaction_preserves_value_dtype():
    cfg = tmlp.SparseMLPConfig(**dict(FIELDS, dtype="bfloat16"))
    model = tmlp.SparseMLP(cfg, seed=6, device="cpu")
    compacted, _ = compact_element_mlp(model, PruningSchedule(**dict(SCHEDULE, percentile=10.0)))
    assert all(v.dtype == torch.bfloat16 for v in compacted.values)
    assert all(b.dtype == torch.bfloat16 for b in compacted.biases)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _engines(seed, **engine_fields):
    jm = _jax_model(seed)
    t_eng = SparseInferenceEngine(_port(jm), engine=EngineConfig(**engine_fields),
                                  compact=False, device="cpu")
    j_eng = JEngine(jm, engine=JEngineConfig(**engine_fields), compact=False)
    return jm, t_eng, j_eng


def _stats(eng):
    return {k: eng.stats[k] for k in ("compiles", "cache_hits", "cache_evictions", "hit_rate")}


def test_classify_buckets_pad_and_chunk():
    jm, t_eng, j_eng = _engines(4, batch_buckets=(2, 4))
    x = _x(4, 9)  # > largest bucket: chunks of 4, then 1 padded to 2
    got = t_eng.classify(x)
    assert got.shape == (9, 6)
    np.testing.assert_array_equal(got, _logits(t_eng.model, x))
    np.testing.assert_allclose(got, j_eng.classify(x), rtol=1e-5, atol=1e-5)
    assert _stats(t_eng) == _stats(j_eng)
    assert t_eng.stats["compiles"] == 2 and len(t_eng._cache) == 2
    # padding rows never leak into real rows
    np.testing.assert_array_equal(t_eng.classify(x[:3]), got[:3])


def test_bucket_cache_is_bounded():
    _, t_eng, j_eng = _engines(5, batch_buckets=(1, 2), compile_cache_max=1)
    x1, x2 = np.zeros((1, 32), np.float32), np.zeros((2, 32), np.float32)
    for eng in (t_eng, j_eng):
        eng.classify(x1)
        eng.classify(x2)  # evicts bucket 1
        eng.classify(x1)  # bucket 1 again: counts as a compile
    assert _stats(t_eng) == _stats(j_eng)
    assert t_eng.stats["cache_evictions"] >= 2
    assert len(t_eng._cache) == 1


def test_fault_hook_fires_before_any_state_change():
    _, t_eng, _ = _engines(6, batch_buckets=(4,))
    calls = []

    def hook(op, idx):
        calls.append((op, idx))
        if idx == 0:
            raise RuntimeError("injected")

    t_eng.fault_hook = hook
    x = _x(6, 3)
    with pytest.raises(RuntimeError, match="injected"):
        t_eng.classify(x)
    assert t_eng.stats["compiles"] == 0
    out = t_eng.classify(x)  # the retry is served
    assert calls == [("classify", 0), ("classify", 1)] and out.shape == (3, 6)


def test_engine_compaction_matches_reference_engine():
    jm = _jax_model(7)
    sched = dict(SCHEDULE, percentile=20.0)
    t_eng = SparseInferenceEngine(_port(jm), compaction=PruningSchedule(**sched), device="cpu")
    j_eng = JEngine(jm, compaction=JSchedule(**sched))
    assert dataclasses.asdict(t_eng.report) == dataclasses.asdict(j_eng.report)
    _assert_same_model(t_eng.model, j_eng.model)
    x = _x(7, 40)
    np.testing.assert_allclose(t_eng.classify(x), j_eng.classify(x), rtol=1e-5, atol=1e-5)


def test_engine_rejects_other_models():
    with pytest.raises(TypeError, match="SparseMLP"):
        SparseInferenceEngine(object(), device="cpu")


# ---------------------------------------------------------------------------
# checkpoint glue
# ---------------------------------------------------------------------------


def test_mlp_engine_checkpoint_roundtrip(tmp_path):
    """The twin of tests/test_serve.py's: saved, then from_checkpoint, then
    the live model's logits, bit-equal, with the saved connectivity."""
    model = _port(_jax_model(3))
    x = _x(3, 5)
    want = _logits(model, x)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    save_mlp_for_serving(mgr, model, step=4)
    eng = SparseInferenceEngine.from_checkpoint(
        str(tmp_path), engine=EngineConfig(batch_buckets=(8,)), compact=False, device="cpu")
    np.testing.assert_array_equal(eng.classify(x), want)
    # restored connectivity is the saved one, not a fresh seed draw
    _assert_same_model(eng.model, _jax_model(3))
    # the reference's engine serves the port's checkpoint too
    j_eng = JEngine.from_checkpoint(str(tmp_path), engine=JEngineConfig(batch_buckets=(8,)),
                                    compact=False)
    np.testing.assert_allclose(j_eng.classify(x), want, rtol=1e-5, atol=1e-5)


def test_reference_checkpoint_served_by_port(tmp_path):
    jm = _jax_model(8)
    jsave_mlp_for_serving(JManager(str(tmp_path), async_write=False), jm, step=2)
    sched = dict(SCHEDULE, percentile=20.0)
    t_eng = SparseInferenceEngine.from_checkpoint(
        CheckpointManager(str(tmp_path)), step=2, compaction=PruningSchedule(**sched),
        device="cpu")
    j_eng = JEngine(jm, compaction=JSchedule(**sched))
    assert dataclasses.asdict(t_eng.report) == dataclasses.asdict(j_eng.report)
    x = _x(8, 40)
    np.testing.assert_allclose(t_eng.classify(x), j_eng.classify(x), rtol=1e-5, atol=1e-5)


def test_jit_entry_sizes_one_per_bucket_after_warmup():
    _, t_eng, j_eng = _engines(9, batch_buckets=(2, 4))
    x = _x(9, 9)  # buckets 4 (chunks) and 2 (the padded tail)
    for _ in range(3):
        t_eng.classify(x)
        t_eng.classify(x[:1])
    j_eng.classify(x)
    assert t_eng.jit_entry_sizes() == {("classify", 2): 1, ("classify", 4): 1}
    assert t_eng.jit_entry_sizes().keys() == j_eng.jit_entry_sizes().keys()
    assert t_eng.stats["jit_entries"] == 2 and t_eng.stats["compiles"] == 2


def test_checkpoint_glue_refuses_what_this_slice_lacks(tmp_path):
    block = tmlp.SparseMLP(tmlp.SparseMLPConfig(**dict(FIELDS, impl="block", block_m=8,
                                                       block_n=8)), device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    # the serving checkpoint holds element models, as the reference's restore
    # is element-only
    with pytest.raises(ValueError, match="element"):
        save_mlp_for_serving(mgr, block)
    # an LM checkpoint serves (tests/test_torch_lm_serve.py), compacted too
    lm_cfg = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, ffn="sparse",
                                 sparse_block=16, sparse_density=0.5, d_ff=64)
    save_lm_for_serving(mgr, PatternLM(lm_cfg, seed=0, device="cpu"), step=1)
    eng = SparseInferenceEngine.from_checkpoint(mgr, device="cpu",
                                                compaction=PruningSchedule(**SCHEDULE))
    assert eng.kind == "lm" and eng.report.params_after < eng.report.params_before
    mgr.save(2, {"w": torch.zeros(1)})
    with pytest.raises(ValueError, match="serve_kind"):
        SparseInferenceEngine.from_checkpoint(mgr, device="cpu")
