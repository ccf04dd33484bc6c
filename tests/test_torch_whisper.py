"""Whisper in the port (``models/whisper.py``, ``models/layers.py``'s
``cross_attention_fwd``/``init_plain_ffn``/``plain_ffn_fwd``,
``configs/whisper_medium.py``, ``launch/steps.py``'s Whisper branches)
against the JAX reference on the CPU, at the SMOKE config (2 + 2 layers,
d_model 64) with the reference's parameters carried over by
``interop.whisper_from_numpy`` (the packages draw their weights from
different generators).

Tolerances (f32): ``encode``, ``decode_train`` and ``logits`` at rtol 1e-5
(atol 1e-5); the loss at 1e-5; every gradient leaf within 1e-4 of the
reference's relative to the leaf's largest |gradient| (plus 1e-6): a leaf's
small entries are sums that cancel. The cross attention's ``bq``, ``bk``
and ``bv`` are never read, and their gradients are exact zeros in both. One
``make_train_step`` step: weights and velocity at rtol 1e-5 (atol 1e-6).
``make_prefill_step`` at 1e-5, the decode steps at 1e-5 against the
reference's (1e-3 with the reference's default bf16 caches, where one K/V
entry may round the other way: the caches within one bf16 ulp) and at 1e-4 against the teacher-forced
logits. bf16: the port's
bf16 model within 5e-2 of the reference's forward of the same bf16 weights
computed in f32, as the other bf16 LM tests hold it.

The frames are 24 (the smoke kv chunk is 16): the cross attention's last
KV chunk is padded with zero keys, which take part in the softmax in the
reference (nothing masks them), and in the port alike.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.whisper import WhisperModel as JWhisper  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import whisper_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.whisper import WhisperConfig, WhisperModel  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SMOKE = jconfigs.get_spec("whisper-medium").smoke
B, FRAMES, S = 2, 24, 16
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pair(cfg=SMOKE, seed=0):
    jm = JWhisper(cfg, seed=seed)
    tm = whisper_from_numpy(dataclasses.asdict(cfg), jax.tree.map(np.asarray, jm.params),
                            device="cpu")
    return jm, tm


def _inputs(seed=0, cfg=SMOKE, frames=FRAMES, s=S):
    rng = np.random.default_rng(seed)
    fr = rng.standard_normal((B, frames, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (B, s))
    return fr, tok


def _batch(fr, tok):
    return {"frames": fr, "tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def test_config_and_param_tree_match_reference():
    spec, jspec = configs.get_spec("whisper-medium"), jconfigs.get_spec("whisper-medium")
    for mine, theirs in ((spec.config, jspec.config), (spec.smoke, jspec.smoke)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert (spec.family, spec.shapes, spec.source) == (jspec.family, jspec.shapes, jspec.source)
    assert [f.name for f in dataclasses.fields(WhisperConfig)] == [
        f.name for f in dataclasses.fields(type(jspec.config))]
    # the port's own build: the reference's leaf names, shapes and dtypes,
    # the reference's distributions (zero biases, unit layernorm scales)
    jm = JWhisper(SMOKE, seed=0)
    tm = WhisperModel(SMOKE, seed=0, device="cpu")
    mine, theirs = tree_flatten_with_names(tm.params)[0], _flatten_with_names(jm.params)[0]
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(mine, theirs):
        assert tuple(a.shape) == b.shape and str(a.dtype).removeprefix("torch.") == str(b.dtype)
        if name.endswith(("bias", "b1", "b2", "bq", "bk", "bv")):
            assert not a.any(), name
        if name.endswith("scale"):
            assert bool((a == 1).all()), name
    assert tm.n_params == sum(int(np.prod(b.shape)) for _, b in theirs)
    # the weights' scale is the reference's 1/sqrt(fan-in)
    wq = tm.params["enc"]["attn"]["wq"]
    assert float(wq.std()) == pytest.approx(1 / np.sqrt(SMOKE.d_model), rel=0.1)
    again = WhisperModel(SMOKE, seed=0, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        mine, tree_flatten_with_names(again.params)[0]))


def test_encode_decode_and_logits_match_reference():
    jm, tm = _pair()
    fr, tok = _inputs()
    mem_j = jm.encode(jm.params, jnp.asarray(fr))
    mem_t = tm.encode(tm.params, torch.as_tensor(fr))
    np.testing.assert_allclose(_np(mem_t), np.asarray(mem_j), **TOL)
    h_j = jm.decode_train(jm.params, jnp.asarray(tok), mem_j)
    h_t = tm.decode_train(tm.params, torch.as_tensor(tok), mem_t)
    np.testing.assert_allclose(_np(h_t), np.asarray(h_j), **TOL)
    np.testing.assert_allclose(_np(tm.logits(tm.params, h_t)),
                               np.asarray(jm.logits(jm.params, h_j)), **TOL)


def test_loss_and_every_gradient_leaf_match_reference():
    jm, tm = _pair()
    fr, tok = _inputs(1)
    batch = _batch(fr, tok)

    def jloss(p):
        mem = jm.encode(p, jnp.asarray(fr))
        h = jm.decode_train(p, jnp.asarray(tok), mem)
        logp = jax.nn.log_softmax(jm.logits(p, h).astype(jnp.float32))
        return -jnp.take_along_axis(logp, jnp.asarray(batch["labels"])[..., None], -1).mean()

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(jm.params)
    tb = tree_map(torch.as_tensor, batch)
    # the port's loss and gradients, through the step's own gradient path
    total, loss, grads = tsteps._microbatched_grad(tsteps.whisper_loss_fn(tm), tm.params, tb, 1)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert float(total) == float(loss)
    mine, theirs = tree_flatten_with_names(grads)[0], _flatten_with_names(want_grads)[0]
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, g), (_, w) in zip(mine, theirs):
        w = np.asarray(w, np.float32)
        assert g is not None and tuple(g.shape) == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=name)
    for name in ("bq", "bk", "bv"):  # never read: exact zeros, not None
        g = grads["dec"]["cross_attn"][name]
        assert not g.any() and not np.asarray(want_grads["dec"]["cross_attn"][name]).any()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jm, tm = _pair()
    fr, tok = _inputs(2)
    batch = _batch(fr, tok)
    jstep, jopt = jsteps.make_train_step(jm, lr=0.05, microbatches=microbatches)
    tstep, topt = tsteps.make_train_step(tm, lr=0.05, microbatches=microbatches)
    jp, js, jmet = jax.jit(jstep)(jm.params, jopt.init(jm.params),
                                  jax.tree.map(jnp.asarray, batch))
    tp, ts, tmet = tstep(tm.params, topt.init(tm.params), tree_map(torch.as_tensor, batch))
    assert set(tmet) == set(jmet) == {"loss"}
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), **TOL)
    for got, want in ((tp, jp), (ts.velocity, js.velocity)):
        mine, theirs = tree_flatten_with_names(got)[0], _flatten_with_names(want)[0]
        assert [n for n, _ in mine] == [n for n, _ in theirs]
        for (name, a), (_, b) in zip(mine, theirs):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=name)
    assert int(ts.step) == int(js.step) == 1


def test_prefill_matches_reference():
    jm, tm = _pair()
    fr, tok = _inputs(3)
    want = jsteps.make_prefill_step(jm)(jm.params, {"frames": jnp.asarray(fr),
                                                    "tokens": jnp.asarray(tok)})
    got = tsteps.make_prefill_step(tm)(tm.params, {"frames": torch.as_tensor(fr),
                                                   "tokens": torch.as_tensor(tok)})
    assert tuple(got.shape) == want.shape == (B, 1, SMOKE.vocab)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_sequence_matches_reference(cache_dtype):
    """Decode 8 tokens one at a time from position 0: each step's logits
    against the reference's decode step (the caches' names, shapes and
    dtypes the reference's), and, with f32 caches, against the
    teacher-forced forward's logits at that position."""
    jm, tm = _pair()
    fr, tok = _inputs(4, s=8)
    mem_j = jm.encode(jm.params, jnp.asarray(fr))
    mem_t = tm.encode(tm.params, torch.as_tensor(fr))
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jc = jm.init_caches(B, SMOKE.max_text, dtype=jdt)
    tc = tm.init_caches(B, SMOKE.max_text, dtype=tdt)
    jdec, tdec = jax.jit(jsteps.make_decode_step(jm)), tsteps.make_decode_step(tm)
    teacher = _np(tm.logits(tm.params, tm.decode_train(tm.params, torch.as_tensor(tok), mem_t)))
    # bf16 caches: a K/V entry an ulp apart in f32 may round to bf16 the
    # other way in the two packages
    tol = TOL if cache_dtype == "float32" else dict(rtol=1e-3, atol=1e-3)
    for pos in range(tok.shape[1]):
        want, jc = jdec(jm.params, {"tokens": jnp.asarray(tok[:, pos:pos + 1]),
                                    "position": jnp.asarray(pos), "caches": jc,
                                    "memory": mem_j})
        got, new = tdec(tm.params, {"tokens": torch.as_tensor(tok[:, pos:pos + 1]),
                                    "position": pos, "caches": tc, "memory": mem_t})
        assert new is tc and tuple(got.shape) == want.shape == (B, 1, SMOKE.vocab)
        np.testing.assert_allclose(_np(got), np.asarray(want), **tol, err_msg=f"pos {pos}")
        if cache_dtype == "float32":
            np.testing.assert_allclose(_np(got)[:, 0], teacher[:, pos], rtol=1e-4, atol=1e-4)
    mine, theirs = tree_flatten_with_names(tc)[0], _flatten_with_names(jc)[0]
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(mine, theirs):
        assert tuple(a.shape) == b.shape and str(a.dtype).removeprefix("torch.") == str(b.dtype)
        # a cache entry: within one ulp of its dtype
        ulp = dict(rtol=2 ** -7, atol=1e-3) if cache_dtype == "bfloat16" else TOL
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **ulp, err_msg=name)


def test_bf16_matches_reference_forward_of_its_weights():
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    jm, tm = _pair(cfg)
    assert tm.params["tok_embed"].dtype == torch.bfloat16
    fr, tok = _inputs(5)
    frb = torch.as_tensor(fr).bfloat16()
    h = tm.decode_train(tm.params, torch.as_tensor(tok), tm.encode(tm.params, frb))
    got = tm.logits(tm.params, h)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jm.params)
    jf = jnp.asarray(frb.float().numpy())
    want = jm.logits(j32, jm.decode_train(j32, jnp.asarray(tok), jm.encode(j32, jf)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=5e-2, atol=5e-2)
    # the bf16 train step: finite, and the loss the f32 forward's within 5e-2
    tstep, topt = tsteps.make_train_step(tm, lr=0.01)
    tb = tree_map(torch.as_tensor, _batch(fr, tok))
    tb["frames"] = tb["frames"].bfloat16()
    tp, _, met = tstep(tm.params, topt.init(tm.params), tb)
    assert all(torch.isfinite(a).all() and a.dtype == torch.bfloat16
               for _, a in tree_flatten_with_names(tp)[0])
    logp = jax.nn.log_softmax(want)
    ref_loss = -jnp.take_along_axis(logp, jnp.asarray(np.roll(tok, -1, 1))[..., None], -1).mean()
    np.testing.assert_allclose(float(met["loss"]), float(ref_loss), rtol=5e-2)


def test_remat_changes_nothing():
    """``remat="block"`` (each layer under ``torch.utils.checkpoint``) and
    ``"none"`` give the same loss and gradients, bit for bit."""
    jm, tm = _pair()
    fr, tok = _inputs(6)
    tb = tree_map(torch.as_tensor, _batch(fr, tok))
    _, l1, g1 = tsteps._microbatched_grad(tsteps.whisper_loss_fn(tm), tm.params, tb, 1)
    tm.cfg = dataclasses.replace(tm.cfg, remat="none")
    _, l0, g0 = tsteps._microbatched_grad(tsteps.whisper_loss_fn(tm), tm.params, tb, 1)
    assert float(l1) == float(l0)
    for (n, a), (_, b) in zip(tree_flatten_with_names(g1)[0], tree_flatten_with_names(g0)[0]):
        assert torch.equal(a, b), n
