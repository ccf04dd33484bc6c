"""The MoE FFN in the port's serving engine (``SparseInferenceEngine``'s LM
kind, ``ContinuousBatcher``, LM checkpoints) against the JAX reference on
the CPU, on qwen3-moe-30b-a3b's smoke config (f32, 8 experts, top-2). The
card's run: ``test_torch_gpu.py`` and ``chip_smoke.py``'s ``lm_moe`` phase.

The reference's engine vmaps a batch-1 decode over its slots, so each slot
dispatches alone (a token, its own capacity); the port decodes the slots
as the rows of one forward with one dispatch group a slot, which is the
same function: its greedy tokens are held equal token for token, and each
slot's logits to that slot decoded alone at 1e-5. The reference's prefill
is one batched forward at the model's own groups, so the prompts of a call
and their padding share capacity; the port's keeps that. No test here
holds batched tokens to one-request-at-a-time tokens: under a shared
capacity they may differ, in both packages alike. The batchers run on a
clock that only the engine's calls advance, so both schedule the same
prefill calls.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro.serve import ContinuousBatcher as JBatcher  # noqa: E402
from repro.serve import EngineConfig as JEngineConfig  # noqa: E402
from repro.serve import SparseInferenceEngine as JEngine  # noqa: E402
from repro.serve import batcher as jbatcher  # noqa: E402
from repro.serve import save_lm_for_serving as jsave_lm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import lm_from_numpy  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatcher,
    EngineConfig,
    SparseInferenceEngine,
    poisson_trace,
)
from repro_torch.serve import batcher as tbatcher  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen3-moe-30b-a3b"
MOE_CFG = configs.get_spec(ARCH).smoke
JMOE_CFG = jconfigs.get_spec(ARCH).smoke
EC = dict(max_slots=4, max_len=48, prefill_buckets=(8, 16), prefill_batch=4)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0):
    jm = JPatternLM(JMOE_CFG, seed=seed)
    tm = lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params), {},
                       seed=seed, device="cpu")
    return jm, tm


def _engines(ec=EC, seed=0):
    jm, tm = _models(seed)
    return (JEngine(jm, engine=JEngineConfig(**ec)),
            SparseInferenceEngine(tm, engine=EngineConfig(**ec), device="cpu"))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MOE_CFG.vocab, n).astype(np.int32) for n in lens]


def _alone_logits(engine, slot: int, token: int, pos: int) -> torch.Tensor:
    """The slot decoded alone: a batch-1 decode step on a copy of its cache
    rows (the reference's vmapped step), (vocab,)."""
    c = engine._caches
    one = {"stack": tree_map(lambda a: a[:, slot:slot + 1].clone(), c["stack"]),
           "rest": tree_map(lambda a: a[slot:slot + 1].clone(), c["rest"])}
    with torch.inference_mode():
        logits, _, _ = engine.model.forward(
            engine._params, torch.tensor([[token]]), topo=engine._topo,
            positions=torch.tensor([[pos]]), mode="decode", caches=one)
    return logits[0, -1]


def test_engine_greedy_tokens_match_reference_engine():
    """Two prompts of one bucket into slots 1 and 3, 3 decode steps with
    slots 0 and 2 idle, then four prompts into all four slots and 6 steps:
    every slot's tokens, the idle ones' too, the reference engine's."""
    jeng, teng = _engines()
    tokens = np.zeros(4, np.int32)
    pos = np.full(4, EC["max_len"] - 1, np.int64)
    for prompts, slots, steps in ((_prompts(11, (5, 12)), [1, 3], 3),
                                  (_prompts(12, (3, 8, 6, 7)), [0, 1, 2, 3], 6)):
        want = jeng.prefill(prompts, slots)
        np.testing.assert_array_equal(teng.prefill(prompts, slots), want)
        tokens[slots], pos[slots] = want, [len(p) for p in prompts]
        for _ in range(steps):
            want = jeng.decode_step(tokens, pos)
            np.testing.assert_array_equal(teng.decode_step(tokens, pos), want)
            tokens, pos = want.copy(), np.where(np.isin(np.arange(4), slots), pos + 1, pos)


class _EngineClock:
    """A clock that only ``sleep`` and the engines' calls advance (each call
    by ``step_s``), installed as ``time`` of both packages' batchers: the
    schedule then depends on the trace alone, not on either engine's speed."""

    def __init__(self, step_s: float = 0.002):
        self.t, self.step_s = 100.0, step_s

    def __call__(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += max(1e-6, float(dt))

    def timed(self, fn):
        def call(*args):
            self.t += self.step_s
            return fn(*args)
        return call


def test_batcher_tokens_match_reference_batcher(monkeypatch):
    """One Poisson trace through both packages' continuous batchers: the
    same prefill calls and decode steps, and every request's greedy tokens
    equal (a call's prompts share the prefill's capacity in both)."""
    clock = _EngineClock()
    for mod in (jbatcher, tbatcher):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=clock, monotonic=clock, sleep=clock.sleep))
    jtrace, ttrace = (poisson_trace(10, rate=400.0, vocab=MOE_CFG.vocab, seed=5,
                                    prompt_lens=(3, 14), new_tokens=(2, 7)) for _ in range(2))
    jeng, teng = _engines()
    for eng in (jeng, teng):
        eng.prefill, eng.decode_step = clock.timed(eng.prefill), clock.timed(eng.decode_step)
    js = JBatcher(jeng, queue_capacity=16).run(jtrace)
    ts = ContinuousBatcher(teng, queue_capacity=16).run(ttrace)
    assert (ts.prefill_calls, ts.decode_steps) == (js.prefill_calls, js.decode_steps)
    assert ts.completed == js.completed == len(ttrace)
    assert ts.prefill_calls < len(ttrace)  # some calls prefilled several prompts
    for rj, rt in zip(jtrace, ttrace):
        np.testing.assert_array_equal(rt.prompt, rj.prompt)
        assert rt.tokens == rj.tokens, rt.rid


def test_reference_checkpoint_serves_the_reference_engines_tokens(tmp_path):
    """The reference's MoE LM saved by ``save_lm_for_serving`` and served by
    the port's ``from_checkpoint``: the reference engine's tokens."""
    jm = JPatternLM(JMOE_CFG, seed=1)
    jsave_lm(JManager(str(tmp_path), async_write=False), jm, step=0)
    ec = dict(EC, max_slots=2)
    jeng = JEngine.from_checkpoint(str(tmp_path), engine=JEngineConfig(**ec))
    teng = SparseInferenceEngine.from_checkpoint(str(tmp_path), engine=EngineConfig(**ec),
                                                 device="cpu")
    assert teng.model.cfg.ffn == "moe" and teng.model.topologies == {}
    prompts = _prompts(2, (9, 4))
    tok = jeng.prefill(prompts, [0, 1])
    np.testing.assert_array_equal(teng.prefill(prompts, [0, 1]), tok)
    tokens, pos = tok.copy(), np.array([9, 4])
    for _ in range(5):
        want = jeng.decode_step(tokens, pos)
        np.testing.assert_array_equal(teng.decode_step(tokens, pos), want)
        tokens, pos = want, pos + 1


def test_grouped_decode_logits_equal_each_slot_decoded_alone():
    """The engine's all-slots step (one dispatch group a slot) against each
    slot's batch-1 decode on a copy of its cache rows, idle slots included,
    over 6 steps: within 1e-5."""
    _, teng = _engines()
    prompts = _prompts(3, (5, 7, 2))
    first = teng.prefill(prompts, [0, 2, 3])
    tokens = np.zeros(4, np.int64)
    pos = np.full(4, EC["max_len"] - 1, np.int64)
    tokens[[0, 2, 3]], pos[[0, 2, 3]] = first, [5, 7, 2]
    for _ in range(6):
        want = torch.stack([_alone_logits(teng, s, int(tokens[s]), int(pos[s]))
                            for s in range(4)])
        with torch.inference_mode():
            got = teng._step_logits(teng._params, teng._topo, teng._caches,
                                    torch.as_tensor(tokens), torch.as_tensor(pos))
        torch.testing.assert_close(got, want, **TOL)
        tokens = got.argmax(-1).numpy()
        pos[[0, 2, 3]] += 1


def test_single_group_decode_drops_entries_the_per_slot_groups_keep(monkeypatch):
    """The first layer's MoE rows of a decode step with one slot busy and
    three idle (their rows alike, so their picks too): one dispatch group a
    slot keeps all 4 x 2 entries; one group over the 4 rows shares the
    capacity between the slots and drops some."""
    _, teng = _engines()
    seen = []
    real = transformer.moe_fwd

    def recording(params, x, cfg):
        seen.append((params, x.detach().clone(), cfg))
        return real(params, x, cfg)

    monkeypatch.setattr(transformer, "moe_fwd", recording)
    tok = teng.prefill(_prompts(4, (6,)), [2])
    tokens = np.zeros(4, np.int32)
    pos = np.full(4, EC["max_len"] - 1, np.int64)
    tokens[2], pos[2] = tok[0], 6
    seen.clear()
    teng.decode_step(tokens, pos)
    params, x, mcfg = seen[0]
    S, K, d = EC["max_slots"], MOE_CFG.top_k, MOE_CFG.d_model
    assert x.shape == (S, 1, d) and mcfg.groups == S
    kept = {}
    for groups in (S, 1):
        cfg = dataclasses.replace(mcfg, groups=groups)
        G, Tg, C = moe_mod.dispatch_shape(cfg, S)
        with torch.inference_mode():
            _, _, _, _, keep, _ = moe_mod._dispatch(params, x.reshape(G, Tg, d), cfg, C)
        kept[groups] = (int(keep.sum()), int((~keep).sum()))
    assert kept[S] == (S * K, 0)
    assert kept[1][0] + kept[1][1] == S * K and kept[1][1] > 0


def test_prefill_shares_capacity_as_the_reference_does():
    """A 5-token and a 12-token prompt in one prefill call, and the 12-token
    one alone, over 6 seeded draws: the port's first tokens equal the
    reference's in every call, and sharing the call changes the 12-token
    prompt's token in some draws, in both packages alike. The model's one
    dispatch group spans the call's rows and padding, and the stable sort
    keeps the earlier row's entries first, so the second row's overflow;
    with a group a prompt no token would change."""
    ec = dict(EC, prefill_batch=2)
    jeng, teng = _engines(ec)
    changed = {"ref": 0, "port": 0}
    for seed in range(6):
        short, long_ = _prompts(100 + seed, (5, 12))
        for name, eng in (("ref", jeng), ("port", teng)):
            together = eng.prefill([short, long_], [0, 1])
            alone = eng.prefill([long_], [2])
            changed[name] += int(together[1] != alone[0])
        np.testing.assert_array_equal(teng.prefill([short, long_], [0, 1]),
                                      jeng.prefill([short, long_], [0, 1]))
        np.testing.assert_array_equal(teng.prefill([long_], [2]), jeng.prefill([long_], [2]))
    assert changed["port"] == changed["ref"] > 0
