"""Every architecture of the registry (the ``PatternLM`` archs and the
encoder-decoder ``whisper-medium``) in the port against the JAX reference
at its SMOKE config, on the CPU: the twin of
``tests/test_arch_smoke.py``, which holds the reference's own outputs to
their shapes and finiteness; here the port's are held to the reference's.
Also one ``adamw`` update (``repro_torch.optim.sgd``) on an LM tree and an
MLP tree.

The reference's parameters cross over through ``interop.lm_from_numpy``
(``interop.whisper_from_numpy`` for Whisper; the packages draw their dense
weights from different generators). Whisper's loss is its train step's
(``launch.steps.whisper_loss_fn``) on seeded frame embeddings. At f32:

* logits and the loss with the MoE auxiliary loss: rtol = atol = 1e-4, the
  attention LM's tolerance (``tests/test_torch_lm.py``);
* gradients: per leaf within 1e-4 of the reference's relative to the leaf's
  largest |gradient| (plus 1e-6 absolute), since a leaf's small entries are
  sums that cancel;
* one decode step from ``init_caches`` at position 7: the reference's logits
  at 1e-4, and the caches' names, shapes and dtypes the reference's;
* ``adamw``: rtol 1e-6 on f32 trees (its power and square root may round
  apart by an ulp), and the bf16 LM tree's new parameters within one bf16
  ulp (2**-7 relative).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro.models.mlp import SparseMLP as JSparseMLP  # noqa: E402
from repro.models.mlp import SparseMLPConfig as JSparseMLPConfig  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro.models.whisper import WhisperModel as JWhisper  # noqa: E402
from repro.models.transformer import chunked_softmax_xent as jxent  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.interop import lm_from_numpy, tensor_from_numpy, whisper_from_numpy  # noqa: E402
from repro_torch.launch.steps import whisper_loss_fn  # noqa: E402
from repro_torch.models.transformer import chunked_softmax_xent  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = configs.list_archs()
WHISPER = "whisper-medium"
B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """The reference's smoke model for ``arch`` (seed 0) and the port's twin
    of it."""
    if arch == WHISPER:
        jm = JWhisper(jconfigs.get_spec(arch).smoke, seed=0)
        tm = whisper_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params),
                                device="cpu")
        return jm, tm
    jm = JPatternLM(jconfigs.get_spec(arch).smoke, seed=0)
    topos = {slot: [((a.rows, a.cols), (b.rows, b.cols)) for a, b in reps]
             for slot, reps in jm.topologies.items()}
    tm = lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params), topos,
                       seed=0, device="cpu")
    return jm, tm


def _inputs(arch):
    cfg = jconfigs.get_spec(arch).smoke
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S))
    prefix = None
    if jconfigs.get_spec(arch).family == "vlm":
        prefix = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return toks, prefix


def _whisper_forward_and_grad(jm, tm):
    """Whisper's logits and train-step loss on seeded frames, and the
    gradients of every leaf, in both packages."""
    cfg = jm.cfg
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S))
    labels = np.roll(toks, -1, axis=1)

    def jloss(params):
        h = jm.decode_train(params, jnp.asarray(toks), jm.encode(params, jnp.asarray(frames)))
        logits = jm.logits(params, h)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[..., None], -1).mean(), logits

    (want_loss, want_logits), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jm.params)
    names, unflatten = tree_flatten_with_names(tm.params)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in names]
    params = unflatten(leaves)
    batch = {"frames": torch.as_tensor(frames), "tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    loss, _ = whisper_loss_fn(tm)(params, batch)
    h = tm.decode_train(params, batch["tokens"], tm.encode(params, batch["frames"]))
    logits = tm.logits(params, h)
    assert logits.shape == (B, S, cfg.vocab)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **TOL)
    return names, grads, want_grads


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_grad_match_reference(arch):
    jm, tm = _pair(arch)
    if arch == WHISPER:
        names, grads, want_grads = _whisper_forward_and_grad(jm, tm)
        _check_grads(arch, names, grads, want_grads)
        return
    cfg = jm.cfg
    toks, prefix = _inputs(arch)
    n_prefix = 0 if prefix is None else cfg.prefix_len
    jtopo = jm.topo_arrays()

    def jloss(params):
        h, _, aux = jm.forward(params, jnp.asarray(toks, jnp.int32), topo=jtopo,
                               prefix_embeds=None if prefix is None else jnp.asarray(prefix),
                               return_hidden=True)
        logits = jm.logits(params, h)
        total = jxent(jm, params, h[:, n_prefix:], jnp.asarray(toks, jnp.int32), chunk=16) + aux
        return total, (logits, aux)

    (want_total, (want_logits, want_aux)), want_grads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(jm.params)

    names, unflatten = tree_flatten_with_names(tm.params)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in names]
    params = unflatten(leaves)
    h, none, aux = tm.forward(params, torch.as_tensor(toks), topo=tm.topo_arrays(),
                              prefix_embeds=None if prefix is None else torch.as_tensor(prefix),
                              return_hidden=True)
    assert none is None
    logits = tm.logits(params, h)
    assert logits.shape == (B, S + n_prefix, cfg.vocab)
    total = chunked_softmax_xent(tm, params, h[:, n_prefix:], torch.as_tensor(toks),
                                 chunk=16) + aux
    grads = torch.autograd.grad(total, leaves)

    np.testing.assert_allclose(_np(logits), np.asarray(want_logits), **TOL)
    np.testing.assert_allclose(float(total.detach()), float(want_total), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), **TOL)
    assert (float(aux.detach()) > 0) == (cfg.ffn == "moe")
    _check_grads(arch, names, grads, want_grads)


def _check_grads(arch, names, grads, want_grads):
    want = dict(_flatten_with_names(want_grads)[0])
    assert [n for n, _ in names] == list(want)
    for (name, _), g in zip(names, grads):
        w = np.asarray(want[name], np.float32)
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + GRAD_ATOL,
                                   err_msg=f"{arch}: gradient {name}")


def _whisper_decode(jm, tm):
    """One Whisper decode step at position 7 from zero caches, on a seeded
    encoder memory, in both packages: ``(got, want, caches, new caches,
    the reference's new caches)``."""
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, 1))
    jmem = jm.encode(jm.params, jnp.asarray(frames))
    want, jnew = jax.jit(jm.decode_step)(jm.params, jnp.asarray(toks), jnp.asarray(7),
                                         jm.init_caches(B, 64, dtype=jnp.float32), jmem)
    caches = tm.init_caches(B, 64, dtype=torch.float32)
    tmem = tm.encode(tm.params, torch.as_tensor(frames))
    got, new = tm.decode_step(tm.params, torch.as_tensor(toks), 7, caches, tmem)
    return got, want, caches, new, jnew


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step_matches_reference(arch):
    jm, tm = _pair(arch)
    cfg = jm.cfg
    if arch == WHISPER:
        got, want, caches, new, jnew = _whisper_decode(jm, tm)
        _check_decode(cfg, got, want, caches, new, jnew)
        return
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, 1))
    jcaches = jm.init_caches(B, 64, dtype=jnp.float32)
    want, jnew, _ = jax.jit(lambda p, c: jm.forward(
        p, jnp.asarray(toks, jnp.int32), topo=jm.topo_arrays(), positions=jnp.array([7]),
        mode="decode", caches=c))(jm.params, jcaches)
    caches = tm.init_caches(B, 64, dtype=torch.float32)
    got, new, _ = tm.forward(tm.params, torch.as_tensor(toks), topo=tm.topo_arrays(),
                             positions=torch.tensor([7]), mode="decode", caches=caches)
    _check_decode(cfg, got, want, caches, new, jnew)


def _check_decode(cfg, got, want, caches, new, jnew):
    assert got.shape == (B, 1, cfg.vocab) and torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the cache structure: the reference's names, shapes and dtypes, kept
    assert new is caches
    mine, theirs = tree_flatten_with_names(new)[0], _flatten_with_names(jnew)[0]
    assert [n for n, _ in mine] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(mine, theirs):
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), **TOL, err_msg=name)


def _adamw_trees(kind):
    """(params, grads) as numpy trees: the LM's (bf16 with f32 leaves:
    recurrentgemma's smoke model in bf16) or the block SET-MLP's (f32)."""
    rng = np.random.default_rng(5)
    if kind == "lm":
        cfg = dataclasses.replace(jconfigs.get_spec("recurrentgemma-2b").smoke,
                                  dtype="bfloat16")
        params = jax.tree.map(np.asarray, JPatternLM(cfg, seed=0).params)
    else:
        jm = JSparseMLP(JSparseMLPConfig(layer_dims=(784, 64, 32, 10), epsilon=8, block_m=8,
                                         block_n=8, impl="block", dropout=0.0), seed=0)
        params = jax.tree.map(np.asarray, jm.params())
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype), params)
    return params, grads


@pytest.mark.parametrize("kind", ["lm", "mlp"])
def test_adamw_update_matches_reference(kind):
    params, grads = _adamw_trees(kind)
    opt, jopt = tsgd.adamw(), jsgd.adamw()
    tp = tree_map(lambda a: tensor_from_numpy(a, "cpu"), params)
    tg = tree_map(lambda a: tensor_from_numpy(a, "cpu"), grads)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    state, jstate = opt.init(tp), jopt.init(jp)
    for lr in (1e-2, 3e-3):  # two steps: the bias corrections move
        tp, state = opt.update(tg, state, tp, lr)
        jp, jstate = jopt.update(jg, jstate, jp, lr)
    assert int(state.step) == int(jstate.step) == 2
    for got, want in ((tp, jp), (state.mu, jstate.mu), (state.nu, jstate.nu)):
        mine, theirs = tree_flatten_with_names(got)[0], _flatten_with_names(want)[0]
        assert [n for n, _ in mine] == [n for n, _ in theirs]
        for (name, a), (_, b) in zip(mine, theirs):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), name
            rtol = 2 ** -7 if a.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), rtol=rtol, atol=1e-7,
                                       err_msg=name)
