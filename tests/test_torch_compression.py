"""The port's ``optim.compression.TopKCompressor`` against the reference's.

The four tests of ``tests/test_compression.py`` run on the port (the
round trip, error feedback across steps, byte accounting, the ``min_k``
floor), and ``compress``/``decompress`` are held equal to the reference's
on the same numpy-seeded inputs: the indices and the error memory exactly,
the sent values bit for bit (both gather the same f32 sums). The inputs
are tie-free (continuous draws), where the two selections are the same
set in the same order; ties are held to ``jax.lax.top_k``'s order (the
lower index first) separately.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.optim.compression import TopKCompressor as JTopK  # noqa: E402
from repro_torch.optim.compression import CompressedLeaf, TopKCompressor  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tree_np(rng):
    return {
        "w": rng.standard_normal((8, 16)).astype(np.float32),
        "b": rng.standard_normal((32,)).astype(np.float32),
    }


def tree(rng):
    return {k: torch.from_numpy(v) for k, v in tree_np(rng).items()}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_compress_decompress_round_trip():
    rng = np.random.default_rng(0)
    grads = tree(rng)
    comp = TopKCompressor(rate=0.25)
    error = comp.init_error(grads)
    wire, new_error = comp.compress(grads, error)
    out = comp.decompress(wire, grads)
    for name, g in grads.items():
        flat = g.numpy().reshape(-1)
        k = comp._k(flat.size)
        leaf = wire[name]
        assert leaf.values.shape == (k,)
        assert leaf.indices.dtype == torch.int32
        assert leaf.size == flat.size
        # decompressed tensor: exactly the sent values at the sent indices,
        # zero everywhere else, original shape/dtype restored
        dec = out[name].numpy()
        assert dec.shape == tuple(g.shape) and dec.dtype == g.numpy().dtype
        dense = np.zeros(flat.size, np.float32)
        dense[leaf.indices.numpy()] = leaf.values.numpy()
        np.testing.assert_array_equal(dec.reshape(-1), dense)
        # top-k by |.|: every sent magnitude >= every kept-back magnitude
        residual = new_error[name].numpy().reshape(-1)
        sent_min = np.abs(leaf.values.numpy()).min()
        mask = np.ones(flat.size, bool)
        mask[leaf.indices.numpy()] = False
        if mask.any():
            assert sent_min >= np.abs(residual[mask]).max() - 1e-7


def test_error_feedback_accumulates_across_steps():
    rng = np.random.default_rng(1)
    comp = TopKCompressor(rate=0.1)
    grads = tree(rng)
    error = comp.init_error(grads)
    for _ in range(4):
        g = tree(rng)
        wire, new_error = comp.compress(g, error)
        sent = comp.decompress(wire, g)
        # conservation: sent + residual == grad + carried error, leaf-wise
        for name in g:
            lhs = sent[name].numpy() + new_error[name].numpy()
            rhs = g[name].numpy() + error[name].numpy()
            np.testing.assert_allclose(lhs, rhs, atol=1e-6)
        error = new_error
    # a constant gradient is transmitted in full within ceil(n/k) steps:
    # error feedback re-queues everything that was withheld
    g_const = tree_map(torch.ones_like, grads)
    error = comp.init_error(grads)
    total = tree_map(torch.zeros_like, grads)
    rounds = max(-(-g.numel() // comp._k(g.numel())) for g in tree_leaves(grads))
    for _ in range(rounds):
        wire, error = comp.compress(g_const, error)
        total = tree_map(lambda t, s: t + s, total, comp.decompress(wire, g_const))
    for name in grads:
        assert total[name].min() >= 1.0, "error feedback starved a coordinate"


def test_payload_and_dense_bytes_accounting():
    rng = np.random.default_rng(2)
    grads = tree(rng)
    comp = TopKCompressor(rate=0.25)
    wire, _ = comp.compress(grads, comp.init_error(grads))
    leaves = tree_leaves(wire, lambda x: isinstance(x, CompressedLeaf))
    # 4B value + 4B int32 index per sent entry
    expect = sum(int(l.values.numel()) * 8 for l in leaves)
    assert comp.payload_bytes(wire) == expect
    assert expect == 8 * sum(comp._k(g.numel()) for g in grads.values())
    assert TopKCompressor.dense_bytes(grads) == 4 * (8 * 16 + 32)
    # the whole point: compressed payload is ~rate of the dense bytes
    assert comp.payload_bytes(wire) < TopKCompressor.dense_bytes(grads)


def test_min_k_floor():
    comp = TopKCompressor(rate=1e-6, min_k=2)
    g = {"w": torch.ones((10,), dtype=torch.float32)}
    wire, _ = comp.compress(g, comp.init_error(g))
    assert wire["w"].values.numel() == 2
    assert comp.payload_bytes(wire) == 16


@pytest.mark.parametrize("rate,min_k", [(0.25, 1), (0.1, 1), (0.01, 3), (1.0, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_compress_decompress_match_the_reference(rate, min_k, seed):
    """Three steps of error feedback through both compressors on the same
    gradients: wire triples, error memory and the decompressed trees equal
    at every step (tie-free inputs)."""
    rng = np.random.default_rng(seed)
    jc, tc = JTopK(rate=rate, min_k=min_k), TopKCompressor(rate=rate, min_k=min_k)
    g0 = tree_np(rng)
    je = jc.init_error({k: jnp.asarray(v) for k, v in g0.items()})
    te = tc.init_error({k: torch.from_numpy(v) for k, v in g0.items()})
    for _ in range(3):
        g = tree_np(rng)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jw, je = jc.compress(jg, je)
        tw, te = tc.compress(tg, te)
        for name in g:
            np.testing.assert_array_equal(tw[name].indices.numpy(), np.asarray(jw[name].indices))
            np.testing.assert_array_equal(tw[name].values.numpy(), np.asarray(jw[name].values))
            assert tw[name].size == jw[name].size
            np.testing.assert_array_equal(te[name].numpy(), np.asarray(je[name]))
        jd, td = jc.decompress(jw, jg), tc.decompress(tw, tg)
        for name in g:
            np.testing.assert_array_equal(td[name].numpy(), np.asarray(jd[name]))
        assert tc.payload_bytes(tw) == jc.payload_bytes(jw)
        assert TopKCompressor.dense_bytes(tg) == JTopK.dense_bytes(jg)


def test_ties_keep_the_lower_index_first():
    """Equal magnitudes are selected as ``jax.lax.top_k`` selects them: the
    lower index first, whatever the sign."""
    vals = np.array([1.0, -3.0, 2.0, 3.0, -2.0, 3.0, 1.0, -1.0], np.float32)
    for k_rate in (0.25, 0.5, 0.75):
        jw, _ = JTopK(rate=k_rate).compress({"w": jnp.asarray(vals)},
                                           {"w": jnp.zeros(8, jnp.float32)})
        tw, _ = TopKCompressor(rate=k_rate).compress({"w": torch.from_numpy(vals)},
                                                     {"w": torch.zeros(8)})
        np.testing.assert_array_equal(tw["w"].indices.numpy(), np.asarray(jw["w"].indices))
