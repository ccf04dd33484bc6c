"""The port's LM training slice against the JAX reference on the CPU: the
loss (``chunked_softmax_xent``), the bf16 plain versions of kernels D and E,
``launch/steps.py::make_train_step`` (and ``_microbatched_grad``), remat,
``examples/train_lm_torch.py``'s loop, and ``MomentumSGD`` on the LM's tree.
The kernels themselves run on the card (``test_torch_gpu.py``).

Tolerances, and why:

* the loss in f32: 1e-6 relative (the same f32 sums; ``logsumexp`` in
  another order);
* D's and E's plain versions in bf16 against the Pallas ``bsmm_dx`` and
  ``bsmm_dw`` run in bf16 (interpret mode): 1e-2, above one bf16 ulp (both
  keep an f32 sum and round once, in other orders); against
  ``ref.bsmm_*_ref``: the reference's own bf16 tolerance, 5e-2;
* one train step in f32: 1e-5 absolute + 1e-4 relative on the loss, every
  gradient leaf and every updated parameter: the sums run in other orders,
  and kernel C's plain version rounds a column's sum once where the
  reference's ``bsmm_xla`` rounds each tile's product;
* the same step in bf16: the loss within 5e-2 relative and each gradient
  leaf within 5e-2 relative L2 of the reference, which computes in f32 on
  the bf16 weights (XLA's CPU backend cannot run its bf16 ``bsmm_xla``), on
  a batch of the training stream (the test says why);
* ``remat="block"`` against ``remat="none"``: bit for bit (the same
  arithmetic, recomputed);
* the example's loop: every step's loss within 1e-4 of the reference
  loop's, and the topologies after each evolution equal (the same numpy
  draws on the same tile scores).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import _flatten_with_names  # noqa: E402
from repro.core.sparsity import BlockMeta as JMeta  # noqa: E402
from repro.core.sparsity import BlockTopology as JTopo  # noqa: E402
from repro.core.topology import evolve_block as jevolve_block  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.block_sparse_matmul import bsmm_dw as jbsmm_dw  # noqa: E402
from repro.kernels.block_sparse_matmul import bsmm_dx as jbsmm_dx  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.transformer import ModelConfig as JModelConfig  # noqa: E402
from repro.models.transformer import PatternLM as JPatternLM  # noqa: E402
from repro.models.transformer import chunked_softmax_xent as jxent  # noqa: E402
from repro.optim.sgd import MomentumSGD as JMomentumSGD  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.set_mlp import mlp_config  # noqa: E402
from repro_torch.interop import lm_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as bsm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.mlp import SparseMLP  # noqa: E402
from repro_torch.models.transformer import PatternLM, chunked_softmax_xent  # noqa: E402
from repro_torch.optim.sgd import MomentumSGD  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_leaves, tree_map  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
LM_FIELDS = dict(ffn="sparse", sparse_block=32, sparse_density=0.5)
LM_CFG = dataclasses.replace(configs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
JLM_CFG = dataclasses.replace(jconfigs.get_spec("qwen1.5-0.5b").smoke, **LM_FIELDS)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 0.05

# B, gm, gn, bm, bn, density: the reference's kernel sweep (tests/test_kernels.py:32)
SHAPES = [
    (8, 2, 3, 8, 16, 0.7),
    (16, 4, 4, 16, 16, 0.4),
    (32, 3, 5, 8, 8, 0.9),
    (8, 1, 2, 16, 8, 1.0),
    (24, 5, 2, 8, 16, 0.5),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _port_of(jm):
    """The port's twin of a reference ``PatternLM`` on the CPU (its
    parameters and topologies)."""
    topos = {slot: [((a.rows, a.cols), (b.rows, b.cols)) for a, b in reps]
             for slot, reps in jm.topologies.items()}
    return lm_from_numpy(dataclasses.asdict(jm.cfg), jax.tree.map(np.asarray, jm.params), topos,
                         seed=jm._seed, device="cpu")


def _batch(cfg, B=4, S=9, seed=3):
    """Tokens and next-token labels, two of them -1 (left out of the loss),
    for both packages."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[0, 2] = labels[B - 1, S - 1] = -1
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(labels)}
    return jb, tb


def _jgrads(jm, params, batch, microbatches=1):
    """The reference train step's loss and gradients (its ``loss_fn``
    through its ``_microbatched_grad``)."""
    topo = jm.topo_arrays()

    def loss_fn(p, b):
        h, _, aux = jm.forward(p, b["tokens"], topo=topo, return_hidden=True)
        loss = jxent(jm, p, h, b["labels"])
        return loss + aux, loss

    return jax.jit(jsteps._microbatched_grad, static_argnums=(0, 3))(loss_fn, params, batch,
                                                                    microbatches)


def _tgrads(tm, batch, microbatches=1):
    return steps._microbatched_grad(steps.lm_loss_fn(tm, tm.topo_arrays()), tm.params, batch,
                                    microbatches)


def _same_leaves(got, want, **tol):
    """Trees of both packages: the same leaf names, every leaf within tol."""
    want_named, _ = _flatten_with_names(want)
    got_named, _ = tree_flatten_with_names(got)
    assert [n for n, _ in got_named] == [n for n, _ in want_named]
    for (name, g), (_, w) in zip(got_named, want_named):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), err_msg=name, **tol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_chunked_softmax_xent_matches_reference():
    """f32, labels of -1 left out, a chunk (5) that does not divide S (13)."""
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 13, JLM_CFG.d_model)).astype(np.float32)
    labels = rng.integers(0, JLM_CFG.vocab, (2, 13))
    labels[0, :3] = -1
    labels[1, 12] = -1
    want = jxent(jm, jm.params, jnp.asarray(h), jnp.asarray(labels, jnp.int32), chunk=5)
    got = chunked_softmax_xent(tm, tm.params, torch.as_tensor(h), torch.as_tensor(labels),
                               chunk=5)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # every label left out: a zero sum over at least one
    none = torch.full((2, 13), -1)
    assert float(chunked_softmax_xent(tm, tm.params, torch.as_tensor(h), none, chunk=5)) == 0.0


# ---------------------------------------------------------------------------
# kernels D and E in bf16: the plain versions
# ---------------------------------------------------------------------------


def _bf16_case(shape, seed):
    """The reference's ``make_case`` in bf16, with a bf16 output gradient."""
    B, gm, gn, bm, bn, density = shape
    rng = np.random.default_rng(seed)
    jmeta = JMeta(in_dim=gm * bm, out_dim=gn * bn, block_m=bm, block_n=bn)
    jtopo = JTopo.erdos_renyi(jmeta, density, rng)
    values = jtopo.init_values(rng, dtype=jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((B, jmeta.in_dim)), jnp.bfloat16)
    dy = jnp.asarray(np.random.default_rng(seed + 7).standard_normal((B, jmeta.padded_out)),
                     jnp.bfloat16)
    return jmeta, jtopo, values, x, dy


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("shape", SHAPES)
def test_bsmm_dx_plain_bf16_matches_pallas_and_oracle(shape):
    jmeta, jtopo, values, _, dy = _bf16_case(shape, 1)
    bm = jmeta.block_m
    t = jtopo.device_arrays()
    want = jbsmm_dx(dy, values, t.rows_r, t.cols_r, t.first_row, t.perm_r, grid_m=jmeta.grid_m,
                    block_b=8, interpret=True)
    oracle = jref.bsmm_dx_ref(dy.astype(jnp.float32), values.astype(jnp.float32), t.rows,
                              t.cols, grid_m=jmeta.grid_m, grid_n=jmeta.grid_n)
    idx = [torch.as_tensor(np.array(a)) for a in (t.rows_r, t.cols_r, t.first_row, t.perm_r)]
    got = bsm.bsmm_dx_plain(_t(dy), _t(values), *idx, grid_m=jmeta.grid_m)
    assert got.dtype == torch.bfloat16
    # the Pallas kernel writes only covered block-rows (the reference's own
    # test compares those); the plain version's others are exact zeros
    covered = np.zeros(jmeta.grid_m, bool)
    covered[np.asarray(t.rows)] = True
    cols = np.repeat(covered, bm)
    np.testing.assert_allclose(_np(got)[:, cols], np.asarray(want, np.float32)[:, cols],
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), rtol=5e-2, atol=5e-2)
    assert (_np(got)[:, ~cols] == 0).all()
    # one rounding of the f32 sum: the f32 plain version, rounded, bit for bit
    f32 = bsm.bsmm_dx_plain(_t(dy).float(), _t(values).float(), *idx, grid_m=jmeta.grid_m)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(f32.to(torch.bfloat16)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bsmm_dw_plain_bf16_matches_pallas_and_oracle(shape):
    jmeta, jtopo, _, x, dy = _bf16_case(shape, 2)
    bm, bn = jmeta.block_m, jmeta.block_n
    t = jtopo.device_arrays()
    want = jbsmm_dw(x, dy, t.rows, t.cols, n_blocks=jtopo.n_blocks, block_m=bm, block_n=bn,
                    block_b=8, interpret=True)
    oracle = jref.bsmm_dw_ref(x.astype(jnp.float32), dy.astype(jnp.float32), t.rows, t.cols,
                              block_m=bm, block_n=bn)
    rows, cols = torch.as_tensor(np.array(t.rows)), torch.as_tensor(np.array(t.cols))
    got = bsm.bsmm_dw_plain(_t(x), _t(dy), rows, cols, block_m=bm, block_n=bn)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(oracle), rtol=5e-2, atol=5e-2)
    f32 = bsm.bsmm_dw_plain(_t(x).float(), _t(dy).float(), rows, cols, block_m=bm, block_n=bn)
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(f32.to(torch.bfloat16)))
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(bsm.bsmm_dw(_t(x), _t(dy), rows, cols, block_m=bm, block_n=bn), got)


# (what, nb, rows, S): kernel E's bf16 batch runs (one CTA of a tile's
# cluster each), from host ints alone
BF16_SPLITS = [
    ("W_in at 2,048 rows", 22, 2048, 4),
    ("W_out at 2,048 rows", 15, 2048, 4),
    ("W_in at 64 rows", 22, 64, 1),
    ("W_out at 64 rows", 15, 64, 1),
    ("W_in at 4,096 rows", 22, 4096, 4),  # 22 clusters of 4 on 3/4 of the SMs
    ("W_out at 4,096 rows", 15, 4096, 6),
    ("16 x 16 tiles, 8 on 5 x 3, 2,048 rows", 8, 2048, 4),
    ("one 16 x 16 tile, 4,096 rows", 1, 4096, 8),  # the portable cluster size
]


def test_bf16_batch_runs_fill_the_card():
    """Kernel E's bf16 runs: at least 8 chunks of 64 rows a run, the nb
    clusters on at most 3/4 of the SMs, at most 8: 4 on the LM's W_in and
    W_out at 2,048 rows, 1 below 961 rows; runs are whole 64-row chunks."""
    for what, nb, rows, want in BF16_SPLITS:
        assert bsm.dw_splits_bf16(nb, rows) == want, what
    assert [bsm.dw_splits_bf16(1, rows) for rows in (960, 961, 1536, 2048, 2560, 3072,
                                                     3584, 4096, 8192)] == [1, 2, 3, 4, 5, 6,
                                                                            7, 8, 8]
    assert bsm.dw_splits_bf16(0, 2048) == 1
    assert bsm.dw_batch_runs(2048, 4, bsm.DW_CHUNK_BF16) == [(0, 512), (512, 1024),
                                                             (1024, 1536), (1536, 2048)]
    assert bsm.dw_batch_runs(1100, 2, bsm.DW_CHUNK_BF16) == [(0, 576), (576, 1100)]


@pytest.mark.parametrize("case", BF16_SPLITS, ids=[c[0] for c in BF16_SPLITS])
def test_bf16_backward_splits_from_host_ints(case):
    """E's S as above, at most the portable cluster size; its runs cover the
    batch as contiguous ranges of whole 64-row chunks, in order, none empty.
    D's bf16 instance takes no split (one CTA per block-row and 128 rows):
    the split rule is gone from the module."""
    what, nb, rows, s = case
    assert bsm.dw_splits_bf16(nb, rows) == s
    assert 1 <= s <= bsm.CLUSTER_MAX
    edges = bsm.dw_batch_runs(rows, s, bsm.DW_CHUNK_BF16)
    assert len(edges) == s and edges[0][0] == 0 and edges[-1][1] == rows
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(edges, edges[1:] + [(rows, rows)]))
    assert all(lo % bsm.DW_CHUNK_BF16 == 0 for lo, _ in edges)
    assert not hasattr(bsm, "dx_parts_bf16")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_f32_matches_reference(microbatches):
    jm = JPatternLM(JLM_CFG, seed=0)
    tm = _port_of(jm)
    jb, tb = _batch(JLM_CFG)
    total, loss, grads = _tgrads(tm, tb, microbatches)
    jtotal, jloss, jgrads = _jgrads(jm, jm.params, jb, microbatches)
    np.testing.assert_allclose(float(loss), float(jloss), **STEP_TOL)
    np.testing.assert_allclose(float(total), float(jtotal), **STEP_TOL)
    _same_leaves(grads, jgrads, **STEP_TOL)
    if microbatches > 1:  # accumulated in f32
        assert all(g.dtype == torch.float32 for g in tree_leaves(grads))

    jstep, jopt = jsteps.make_train_step(jm, lr=LR, microbatches=microbatches)
    jp, js, jmet = jax.jit(jstep)(jm.params, jopt.init(jm.params), jb, jm.topo_arrays())
    step, opt = steps.make_train_step(tm, lr=LR, microbatches=microbatches)
    p, s, met = step(tm.params, opt.init(tm.params), tb, tm.topo_arrays())
    assert set(met) == {"loss", "total"}
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), **STEP_TOL)
    np.testing.assert_allclose(float(met["total"]), float(jmet["total"]), **STEP_TOL)
    _same_leaves(p, jp, **STEP_TOL)
    _same_leaves(s.velocity, js.velocity, **STEP_TOL)
    assert int(s.step) == int(js.step) == 1
    assert not any(t.requires_grad for t in tree_leaves(p))


def test_train_step_bf16_within_reference_tolerance():
    """The port's bf16 step against the reference's step on the same bf16
    weights computed in f32, on a batch of the slice's training stream
    (``examples/train_lm_torch.py``'s Zipf tokens, seed 0, 8 x 32). On
    uniformly drawn tokens this model's gradient is ill-conditioned: in f32,
    a 2**-9 relative perturbation of the parameters alone moves leaves'
    gradients by 3-14 %, so no bf16 computation holds 5e-2 there."""
    jm = JPatternLM(dataclasses.replace(JLM_CFG, dtype="bfloat16"), seed=0)
    tm = _port_of(jm)
    assert tm.params["embed"]["table"].dtype == torch.bfloat16
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jm.params)
    jm.cfg = dataclasses.replace(jm.cfg, dtype="float32")
    toks = next(_example("train_lm_torch").synthetic_stream(np.random.default_rng(0),
                                                            JLM_CFG.vocab, 8, 33))
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.as_tensor(toks[:, :-1]).long(),
          "labels": torch.as_tensor(toks[:, 1:]).long()}
    _, loss, grads = _tgrads(tm, tb)
    _, jloss, jgrads = _jgrads(jm, j32, jb)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=5e-2)
    want_named, _ = _flatten_with_names(jgrads)
    got_named, _ = tree_flatten_with_names(grads)
    assert [n for n, _ in got_named] == [n for n, _ in want_named]
    for (name, g), (_, w) in zip(got_named, want_named):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(_np(g) - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= 5e-2, (name, err)
    step, opt = steps.make_train_step(tm, lr=LR)
    p, s, _ = step(tm.params, opt.init(tm.params), tb, tm.topo_arrays())
    assert all(a.dtype == b.dtype for a, b in zip(tree_leaves(p), tree_leaves(tm.params)))
    assert all(v.dtype == torch.float32 for v in tree_leaves(s.velocity))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_block_is_bit_equal_to_none(dtype):
    cfg = dataclasses.replace(LM_CFG, dtype=dtype)
    tb = _batch(cfg, seed=6)[1]
    runs = []
    for remat in ("block", "none"):
        tm = PatternLM(dataclasses.replace(cfg, remat=remat), seed=0, device="cpu")
        runs.append(_tgrads(tm, tb))
    (t0, l0, g0), (t1, l1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(t0, t1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_remat_flag_is_checked():
    with pytest.raises(ValueError, match="remat"):
        PatternLM(dataclasses.replace(LM_CFG, remat="full"), seed=0, device="cpu")


def test_sparse_ffn_grad_path_has_the_no_grad_bits():
    """The sparse FFN under autograd (kernel C's Function, then All-ReLU)
    gives the forward bits of the no-grad path (All-ReLU in C's store), and
    the oracle path (``bsmm_xla``) its own formulation's."""
    tm = PatternLM(dataclasses.replace(LM_CFG, dtype="bfloat16"), seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, LM_CFG.vocab, (2, 7)))
    with torch.no_grad():
        want, _, _ = tm.forward(tm.params, toks, topo=tm.topo_arrays())
    params = tree_map(lambda a: a.detach().requires_grad_(True), tm.params)
    got, _, _ = tm.forward(params, toks, topo=tm.topo_arrays())
    assert got.requires_grad and torch.equal(got.detach(), want)
    tm.sparse_impl = "xla"
    oracle, _, _ = tm.forward(params, toks, topo=tm.topo_arrays())
    np.testing.assert_allclose(_np(oracle), _np(want), rtol=5e-2, atol=5e-2)


def test_train_step_refuses_the_whisper_model():
    """Whisper is ported: ``make_train_step`` takes a ``WhisperModel`` and
    gives its three-argument step (``tests/test_torch_whisper.py`` holds
    it to the reference)."""
    from repro_torch import configs
    from repro_torch.models.whisper import WhisperModel

    cfg = configs.get_spec("whisper-medium").smoke
    model = WhisperModel(cfg, seed=0, device="cpu")
    step, opt = steps.make_train_step(model)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 8)))
    batch = {"frames": torch.as_tensor(rng.standard_normal((2, 16, cfg.d_model)),
                                       dtype=torch.float32),
             "tokens": toks, "labels": toks}
    _, state, metrics = step(model.params, opt.init(model.params), batch)
    assert set(metrics) == {"loss"} and torch.isfinite(metrics["loss"]) and int(state.step) == 1


# ---------------------------------------------------------------------------
# examples/train_lm_torch.py against the reference example's loop
# ---------------------------------------------------------------------------


def _example(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_loop(jm, steps_, batch, seq, lr, evolve_every, zeta, stream):
    """examples/train_lm.py's loop (its step, its host SET), cut to
    ``steps_``: every step's loss and the topologies after each evolution."""
    opt = JMomentumSGD(momentum=0.9, weight_decay=1e-4)
    params = jm.params
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, topo, tokens):
        def loss_fn(p):
            h, _, aux = jm.forward(p, tokens[:, :-1], topo=topo, return_hidden=True)
            return jxent(jm, p, h, tokens[:, 1:], chunk=64) + aux

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params2, opt_state2 = opt.update(grads, opt_state, params, lr)
        return params2, opt_state2, loss

    rng = np.random.default_rng(7)
    topo = jm.topo_arrays()
    losses, evolved = [], []
    for i in range(steps_):
        params, opt_state, loss = step(params, opt_state, topo, jnp.asarray(next(stream)))
        losses.append(float(loss))
        if (i + 1) % evolve_every == 0:
            for slot, topos in jm.topologies.items():
                vals_in = np.asarray(params["stack"][slot]["ffn"]["win"])
                vals_out = np.asarray(params["stack"][slot]["ffn"]["wout"])
                new_in, new_out = [], []
                for r, (t_in, t_out) in enumerate(topos):
                    res_i = jevolve_block(t_in, vals_in[r], zeta, rng)
                    res_o = jevolve_block(t_out, vals_out[r], zeta, rng)
                    jm.topologies[slot][r] = (res_i.topology, res_o.topology)
                    new_in.append(res_i.values)
                    new_out.append(res_o.values)
                params["stack"][slot]["ffn"]["win"] = jnp.asarray(np.stack(new_in))
                params["stack"][slot]["ffn"]["wout"] = jnp.asarray(np.stack(new_out))
            topo = jm.topo_arrays()
            evolved.append({slot: [tuple((t.rows.copy(), t.cols.copy()) for t in pair)
                                   for pair in topos] for slot, topos in jm.topologies.items()})
    return losses, evolved


def test_example_loop_matches_reference_loop(tmp_path):
    """The tiny preset, cut to 6 steps with SET every 3, batch 2, seq 16, f32."""
    ex = _example("train_lm_torch")
    ref_ex = _example("train_lm")
    assert ex.PRESETS == ref_ex.PRESETS
    cfg = ex.preset_config("tiny")
    jm = JPatternLM(JModelConfig(**dataclasses.asdict(cfg)), seed=0)
    tm = _port_of(jm)
    run = dict(batch=2, seq=16, lr=0.05, evolve_every=3, zeta=0.3)
    # the same stream: the port's draws are the reference's, as int32
    a = ex.synthetic_stream(np.random.default_rng(0), cfg.vocab, 2, 17)
    b = ref_ex.synthetic_stream(np.random.default_rng(0), cfg.vocab, 2, 17)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), np.asarray(next(b)))
    want_losses, want_evolved = _reference_loop(
        jm, 6, stream=ref_ex.synthetic_stream(np.random.default_rng(0), cfg.vocab, 2, 17), **run)
    got = ex.train(tm, steps=6, ckpt_dir=tmp_path / "ckpt", meta={"preset": "tiny"},
                   verbose=False, **run)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4, atol=1e-4)
    assert len(got["evolved"]) == len(want_evolved) == 2
    for g, w in zip(got["evolved"], want_evolved):
        assert list(g) == list(w)
        for slot in w:
            for gp, wp in zip(g[slot], w[slot]):
                for (gr, gc), (wr, wc) in zip(gp, wp):
                    np.testing.assert_array_equal(gr, wr)
                    np.testing.assert_array_equal(gc, wc)
    # the checkpoint at the end holds the trained parameters
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore(6, like=tm.params)[0]
    for x, y in zip(tree_leaves(restored), tree_leaves(tm.params)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_example_refuses_the_obs_flags(tmp_path, capsys):
    """The obs flags run (they were refused before the obs slice): a valid
    trace with the example's spans, and with ``--probe`` a valid timeline
    of one snapshot per evolution and one at the end, no alert."""
    from repro_torch import obs
    from repro_torch.obs import timeline

    ex = _example("train_lm_torch")
    trace, tl = tmp_path / "t.jsonl", tmp_path / "tl.jsonl"
    ex.main(["--device", "cpu", "--steps", "4", "--evolve-every", "2", "--batch", "2",
             "--seq", "16", "--ckpt-dir", str(tmp_path / "ckpt"), "--trace", str(trace),
             "--probe", "--timeline", str(tl)])
    events = obs.read_events(str(trace))
    assert obs.validate_events(events) == []
    names = [e["name"] for e in events if e["ev"] == "span"]
    assert names.count("train.step") == 4 and names.count("train.evolve") == 2
    assert names.count("train.run") == 1
    tev = timeline.read_timeline(tl)
    assert timeline.validate_timeline(tev) == [] and timeline.alerts(tev) == []
    snaps = timeline.snapshots(tev, "lm")
    assert [s["step"] for s in snaps] == [2, 4, 4]
    assert all(np.isfinite(layer["value_l2"]) for s in snaps for layer in s["layers"])
    assert 0 < snaps[0]["layers"][0]["churn_frac"] <= 1
    out = capsys.readouterr().out
    assert "training-dynamics health" in out and "alerts: none" in out


# ---------------------------------------------------------------------------
# MomentumSGD on the LM's tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["lm", "mlp"])
def test_momentum_sgd_inits_and_updates_any_tree(which):
    """``init`` takes its device from the tree's first leaf: the LM's first
    value is a dict (``params["embed"]``), the MLP's a tuple."""
    if which == "lm":
        params = PatternLM(LM_CFG, seed=0, device="cpu").params
    else:
        cfg = dataclasses.replace(mlp_config("cifar10"), layer_dims=(3072, 32, 16, 10))
        params = SparseMLP(cfg, seed=0, device="cpu").params()
    opt = MomentumSGD(momentum=0.9, weight_decay=1e-4)
    state = opt.init(params)
    assert state.step.device == tree_leaves(params)[0].device and int(state.step) == 0
    assert all(v.dtype == torch.float32 and not v.any() for v in tree_leaves(state.velocity))
    grads = tree_map(torch.ones_like, params)
    new, state = opt.update(grads, state, params, 0.1)
    assert int(state.step) == 1
    for p, v, q in zip(tree_leaves(params), tree_leaves(state.velocity), tree_leaves(new)):
        np.testing.assert_allclose(v.numpy(), -0.1 * (1 + 1e-4 * p.numpy()), rtol=1e-6)
        np.testing.assert_allclose(q.numpy(), (p + v).numpy(), rtol=1e-6)
