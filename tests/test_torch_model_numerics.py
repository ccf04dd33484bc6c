"""The port's recurrent blocks, MoE FFN and decode against the JAX reference
on the CPU: twins of ``tests/test_model_numerics.py``'s scan, decode and MoE
tests (``repro_torch.models.mamba``, ``.griffin``, ``.moe``,
``.transformer``), with fixed seeds in place of hypothesis so that the count
is steady.

Tolerances, and why:

* the chunked scans (f32) against the sequential recurrence: the
  reference's own, 1e-4 (Mamba) and 1e-5 (RG-LRU); against the reference's
  chunked scan the same, since both group the chunk's products in other
  orders (the reference's associative scan, the port's Hillis-Steele scan);
* the blocks and ``PatternLM`` (f32) with the reference's parameters carried
  over: 1e-4, the attention LM's (``tests/test_torch_lm.py``); decode against
  the teacher-forced forward at the reference's 5e-3;
* ``moe_fwd`` (f32) against the reference: 1e-5 on the output and the
  auxiliary loss; which tokens capacity drops is held exactly;
* decode against the teacher-forced forward in bf16 (the card's dtype):
  ``BF16_ATOL + BF16_RTOL x |want|`` elementwise, the ``lm`` phase's logit
  tolerance in ``chip_smoke.py``, which its ``lm_archs`` phase holds the
  full-size models to.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro.models.griffin import _rglru_scan as j_rglru_scan  # noqa: E402
from repro.models.griffin import RGLRUConfig as JRGLRUConfig  # noqa: E402
from repro.models.griffin import init_rglru_block as jinit_rglru, rglru_fwd as jrglru_fwd  # noqa: E402
from repro.models.mamba import MambaConfig as JMambaConfig  # noqa: E402
from repro.models.mamba import _ssm_chunked as j_ssm_chunked  # noqa: E402
from repro.models.mamba import init_mamba_block as jinit_mamba, mamba_fwd as jmamba_fwd  # noqa: E402
from repro.models.mamba import init_mamba_state as jinit_mamba_state  # noqa: E402
from repro.models.moe import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.moe import init_moe as jinit_moe, moe_fwd as jmoe_fwd  # noqa: E402
from repro.models.transformer import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro_torch.interop import lm_from_numpy  # noqa: E402
from repro_torch.models import griffin, mamba, moe  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

LM_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=5e-3, atol=5e-3)
BF16_ATOL, BF16_RTOL = 0.1, 5e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _params(jparams) -> dict:
    return tree_map(_t, jax.tree.map(np.asarray, jparams))


# ---------------------------------------------------------------------------
# the chunked scans against the sequential recurrence and the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [3, 8, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mamba_chunked_scan_matches_sequential_and_reference(seed, chunk):
    rng = np.random.default_rng(seed)
    B, S, di, ds = 2, 13, 4, 3
    u = rng.standard_normal((B, S, di)).astype(np.float32)
    delta = (rng.random((B, S, di)) * 0.5).astype(np.float32)
    Bc = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cc = rng.standard_normal((B, S, ds)).astype(np.float32)
    A = -(rng.random((di, ds)) + 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, di, ds)).astype(np.float32)

    y, hT = mamba._ssm_chunked(*map(_t, (u, delta, Bc, Cc, A, h0)), chunk)
    jy, jhT = j_ssm_chunked(*map(jnp.asarray, (u, delta, Bc, Cc, A, h0)), chunk)

    h, ys = h0, []
    for t in range(S):
        da = np.exp(delta[:, t, :, None] * A)
        dbu = delta[:, t, :, None] * Bc[:, t, None, :] * u[:, t, :, None]
        h = da * h + dbu
        ys.append(np.einsum("bds,bs->bd", h, Cc[:, t]))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(y), np.stack(ys, 1), **tol)
    np.testing.assert_allclose(_np(hT), h, **tol)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **tol)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **tol)


@pytest.mark.parametrize("chunk", [2, 5, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rglru_chunked_scan_matches_sequential_and_reference(seed, chunk):
    rng = np.random.default_rng(seed)
    B, S, dr = 2, 11, 5
    gx = rng.standard_normal((B, S, dr)).astype(np.float32)
    a_t = (rng.random((B, S, dr)) * 0.9).astype(np.float32)
    h0 = rng.standard_normal((B, dr)).astype(np.float32)
    h_seq, hT = griffin._rglru_scan(_t(gx), _t(a_t), _t(h0), chunk)
    jh_seq, jhT = j_rglru_scan(jnp.asarray(gx), jnp.asarray(a_t), jnp.asarray(h0), chunk)
    h, want = h0, []
    for t in range(S):
        h = a_t[:, t] * h + gx[:, t]
        want.append(h.copy())
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(h_seq), np.stack(want, 1), **tol)
    np.testing.assert_allclose(_np(hT), h, **tol)
    np.testing.assert_allclose(_np(h_seq), np.asarray(jh_seq), **tol)
    np.testing.assert_allclose(_np(hT), np.asarray(jhT), **tol)


def test_scan_chunk_backward_matches_reference():
    """The checkpointed chunk bodies' gradients (the backward recomputes
    each chunk) against the reference's through ``jax.checkpoint``."""
    rng = np.random.default_rng(3)
    B, S, dr = 2, 11, 5
    gx = rng.standard_normal((B, S, dr)).astype(np.float32)
    a_t = (rng.random((B, S, dr)) * 0.9).astype(np.float32)
    h0 = rng.standard_normal((B, dr)).astype(np.float32)
    w = rng.standard_normal((B, S, dr)).astype(np.float32)

    def jloss(g, a, h):
        hs, hT = j_rglru_scan(g, a, h, 4)
        return jnp.sum(hs * w) + jnp.sum(hT)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (gx, a_t, h0)))
    ins = [_t(v).requires_grad_(True) for v in (gx, a_t, h0)]
    hs, hT = griffin._rglru_scan(*ins, 4)
    got = torch.autograd.grad((hs * _t(w)).sum() + hT.sum(), ins)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(wv), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the blocks with the reference's parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches_reference(with_state):
    cfg = dict(d_model=32, d_inner=64, d_state=4, chunk=8)
    jparams, _ = jinit_mamba(jax.random.PRNGKey(0), JMambaConfig(**cfg), jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 13, 32)).astype(np.float32)
    jstate = None
    state = None
    if with_state:
        jstate = jinit_mamba_state(JMambaConfig(**cfg), 2, jnp.float32)
        rng = np.random.default_rng(1)
        jstate = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype),
                              jstate)
        state = tree_map(_t, jax.tree.map(np.asarray, jstate))
    want, jnew = jmamba_fwd(jparams, jnp.asarray(x), JMambaConfig(**cfg), state=jstate)
    got, new = mamba.mamba_fwd(_params(jparams), _t(x), mamba.MambaConfig(**cfg), state=state)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)
    assert (new is None) == (jnew is None) == (not with_state)
    if with_state:
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(_np(new[k]), np.asarray(jnew[k]), **LM_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_reference(with_state):
    cfg = dict(d_model=32, d_rnn=48, chunk=4)
    jparams, _ = jinit_rglru(jax.random.PRNGKey(0), JRGLRUConfig(**cfg), jnp.float32)
    # lambda spread, so that the recurrence gates differ across channels
    jparams["lambda_p"] = jnp.linspace(-1.0, 4.0, 48, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, 11, 32)).astype(np.float32)
    jstate = state = None
    if with_state:
        rng = np.random.default_rng(1)
        np_state = {"rnn": rng.standard_normal((2, 48)).astype(np.float32),
                    "conv": rng.standard_normal((2, 3, 48)).astype(np.float32)}
        jstate = jax.tree.map(jnp.asarray, np_state)
        state = tree_map(_t, np_state)
    want, jnew = jrglru_fwd(jparams, jnp.asarray(x), JRGLRUConfig(**cfg), state=jstate)
    got, new = griffin.rglru_fwd(_params(jparams), _t(x), griffin.RGLRUConfig(**cfg),
                                 state=state)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LM_TOL)
    assert (new is None) == (jnew is None) == (not with_state)
    if with_state:
        for k in ("rnn", "conv"):
            np.testing.assert_allclose(_np(new[k]), np.asarray(jnew[k]), **LM_TOL)


def test_softplus_is_the_references():
    """``logaddexp(x, 0)`` to an ulp (XLA flushes the subnormal result at
    -100 to 0), also above 20, where ``F.softplus`` returns x itself."""
    x = np.array([-100.0, -20.5, -1.0, 0.0, 1e-3, 1.0, 19.9, 20.1, 30.0, 100.0], np.float32)
    np.testing.assert_allclose(_np(mamba.softplus(_t(x))), np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=1e-37)


# ---------------------------------------------------------------------------
# decode == forward slice, for the four patterns of the reference's test
# ---------------------------------------------------------------------------


PATTERNS = [("global",), ("local", "global"), ("mamba",), ("rglru", "rglru", "local")]


def _decode_cfg(pattern, **kw):
    fields = dict(
        name="t", vocab=64, d_model=32, n_layers=2 * len(pattern),
        n_heads=4, n_kv=2, head_dim=8, d_ff=48, pattern=pattern, window=8,
        d_inner=64, d_state=4, d_rnn=32, dtype="float32", kv_chunk=8,
        ssm_chunk=8, tied_embeddings=True, remat="none",
        decode_window_cache=False,  # exact parity needs full-window cache
    )
    fields.update(kw)
    return fields


def _port_of(jm):
    return lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params), {},
                         seed=0, device="cpu")


@pytest.mark.parametrize("pattern", PATTERNS, ids=["_".join(p) for p in PATTERNS])
def test_decode_matches_teacher_forced_forward(pattern):
    jm = JPatternLM(JModelConfig(**_decode_cfg(pattern)), seed=0)
    tm = _port_of(jm)
    S = 12
    toks = np.random.default_rng(0).integers(0, 64, (2, S))
    want_full, _, _ = jm.forward(jm.params, jnp.asarray(toks, jnp.int32))
    full, _, aux = tm.forward(tm.params, torch.as_tensor(toks))
    np.testing.assert_allclose(_np(full), np.asarray(want_full), **LM_TOL)
    assert float(aux) == 0.0

    caches = tm.init_caches(2, S, dtype=torch.float32)
    jcaches = jm.init_caches(2, S, dtype=jnp.float32)
    jstep = jax.jit(lambda p, t, pos, c: jm.forward(p, t, positions=pos, mode="decode",
                                                    caches=c))
    outs = []
    for pos in range(S):
        lg, caches, _ = tm.forward(tm.params, torch.as_tensor(toks[:, pos:pos + 1]),
                                   positions=torch.tensor([pos]), mode="decode", caches=caches)
        jlg, jcaches, _ = jstep(jm.params, jnp.asarray(toks[:, pos:pos + 1], jnp.int32),
                                jnp.array([pos]), jcaches)
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **LM_TOL)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full), **DECODE_TOL)
    # the caches carried to the end, recurrent states included
    got = {k: _np(v) for k, v in tree_flatten_with_names(caches)[0]}
    want = {k: np.asarray(v) for k, v in _flatten_with_names(jcaches)[0]}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **LM_TOL, err_msg=k)


@pytest.mark.parametrize("pattern", [("mamba",), ("rglru", "rglru", "local")],
                         ids=["mamba", "rglru_rglru_local"])
def test_decode_bf16_within_the_cards_tolerance(pattern):
    """The bf16 model (the card's dtype) decoded token by token from
    ``init_caches`` against its own teacher-forced forward: within
    BF16_ATOL + BF16_RTOL x |want| elementwise, the tolerance the card's
    ``lm_archs`` phase holds the full-size models to."""
    cfg = _decode_cfg(pattern, dtype="bfloat16", n_layers=3 * len(pattern),
                      decode_window_cache=True, window=16, ssm_chunk=4)
    jm = JPatternLM(JModelConfig(**cfg), seed=0)
    tm = _port_of(jm)
    S = 16
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 64, (2, S)))
    with torch.inference_mode():
        full, _, _ = tm.forward(tm.params, toks)
        caches = tm.init_caches(2, S)
        outs = []
        for pos in range(S):
            lg, caches, _ = tm.forward(tm.params, toks[:, pos:pos + 1],
                                       positions=torch.tensor([pos]), mode="decode",
                                       caches=caches)
            outs.append(lg[:, 0])
    got, want = torch.stack(outs, 1).float(), full.float()
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= BF16_ATOL + BF16_RTOL * want.abs()).all())


def test_prefill_returns_no_recurrent_state():
    """As in the reference: ``prefill`` keeps the attention K/V and returns
    no state for a recurrent block (none for its stacked slot, ``None`` for a
    remainder layer)."""
    cfg = _decode_cfg(("rglru", "local"), n_layers=3)
    jm = JPatternLM(JModelConfig(**cfg), seed=0)
    tm = _port_of(jm)
    toks = np.random.default_rng(0).integers(0, 64, (2, 6))
    _, jc, _ = jm.forward(jm.params, jnp.asarray(toks, jnp.int32), mode="prefill")
    logits, c, _ = tm.forward(tm.params, torch.as_tensor(toks), mode="prefill")
    assert sorted(c["stack"]) == sorted(jc["stack"]) == ["s1_local"]
    assert c["rest"] == jc["rest"] == [None]


# ---------------------------------------------------------------------------
# MoE: the reference's output, dispatch invariants, capacity drops
# ---------------------------------------------------------------------------


def _moe_case(seed, groups, top_k, capacity_factor=8.0, E=4, d=8, f=16, T=12):
    kw = dict(n_experts=E, top_k=top_k, d_model=d, d_ff=f, capacity_factor=capacity_factor,
              groups=groups)
    jparams, _ = jinit_moe(jax.random.PRNGKey(seed % 97), JMoEConfig(**kw), jnp.float32)
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)
    return kw, jparams, x


_jmoe = jax.jit(jmoe_fwd, static_argnums=2)
MOE_CASES = [(seed, groups, top_k) for seed in (0, 7) for groups in (1, 2, 4)
             for top_k in (1, 2)]


@pytest.mark.parametrize("seed,groups,top_k", MOE_CASES)
def test_moe_fwd_matches_reference(seed, groups, top_k):
    kw, jparams, x = _moe_case(seed, groups, top_k, capacity_factor=1.0)
    want, jaux = _jmoe(jparams, jnp.asarray(x), JMoEConfig(**kw))
    got, aux = moe.moe_fwd(_params(jparams), _t(x), moe.MoEConfig(**kw))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    # the reference's invariants (tests/test_model_numerics.py)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert 0.0 <= float(aux) < 1.0


@pytest.mark.parametrize("seed,groups,top_k", MOE_CASES)
def test_moe_dispatch_invariants(seed, groups, top_k):
    """Every kept entry in a slot of its own, at most C a expert, the
    combine equal to a loop over each token's kept experts; with ample
    capacity, grouping does not change the result."""
    kw, jparams, x = _moe_case(seed, groups, top_k, capacity_factor=1.0)
    cfg = moe.MoEConfig(**kw)
    params = _params(jparams)
    E, K, T = cfg.n_experts, cfg.top_k, x.shape[0]
    G = max(1, np.gcd(groups, T))
    Tg = T // G
    C = max(1, int(np.ceil(Tg * K * cfg.capacity_factor / E)))
    xg = _t(x).reshape(G, Tg, -1)
    _, slot, st, sg, keep, _ = moe._dispatch(params, xg, cfg, C)
    y, _ = moe.moe_fwd(params, _t(x), cfg)
    want = torch.zeros_like(xg)
    for g in range(G):
        kept = slot[g][keep[g]]
        assert kept.unique().numel() == kept.numel()           # a slot each
        assert int((~keep[g]).sum()) == 0 or bool((slot[g][~keep[g]] == E * C).all())
        assert np.bincount((kept // C).numpy(), minlength=E).max() <= C
        for j in torch.nonzero(keep[g]).flatten().tolist():
            t, e = int(st[g, j]), int(slot[g, j]) // C
            xt = xg[g, t]
            h = torch.nn.functional.silu(xt @ params["wi_gate"][e]) * (xt @ params["wi_up"][e])
            want[g, t] += sg[g, j] * (h @ params["wo"][e])
    np.testing.assert_allclose(_np(y), _np(want.reshape(T, -1)), rtol=1e-5, atol=1e-5)
    ample = dataclasses.replace(cfg, capacity_factor=8.0)
    y_g, _ = moe.moe_fwd(params, _t(x), ample)
    y_1, _ = moe.moe_fwd(params, _t(x), dataclasses.replace(ample, groups=1))
    np.testing.assert_allclose(_np(y_g), _np(y_1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_capacity_drops_overflow(seed):
    """capacity = ceil(16 * 1 * 0.25 / 2) = 2 slots an expert: at most 4
    tokens served, and the same tokens as the reference's."""
    kw, jparams, x = _moe_case(seed, 1, 1, capacity_factor=0.25, E=2, d=4, f=8, T=16)
    want, _ = _jmoe(jparams, jnp.asarray(x), JMoEConfig(**kw))
    got, _ = moe.moe_fwd(_params(jparams), _t(x), moe.MoEConfig(**kw))
    served = np.abs(_np(got)).sum(-1) > 1e-9
    assert served.sum() <= 2 * kw["n_experts"]
    np.testing.assert_array_equal(served, np.abs(np.asarray(want)).sum(-1) > 1e-9)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
