"""The port's WASAP-SGD (``repro_torch.core.wasap``) against the reference's
(``repro.core.wasap``) on the CPU.

Inputs are made with numpy from a seed and carried across with
``interop.mlp_from_numpy``/``sgd_state_from_numpy``. Dropout draws from
other streams in the two packages (a ``torch.Generator`` against split
``jax.random`` keys), so the runs held to the reference are at dropout 0.

* The final merge (numpy in both) is held bit-equal: rows, cols and values.
* ``_average_pytree``/``_cast_like`` at rtol 1e-6, the step counter exact
  and int32.
* ``scan_masked_segment`` and the phase-1 epoch at rtol 1e-5 / atol 1e-6
  (kernel A's plain version sums in another order than XLA's segment sum;
  a few SGD steps carry the last bits).
* Within the port, the fused epoch bit-equal to the padded round loop, at
  the reference test's dropout 0.2 (the same generator stream).
* The trainer, both modes, against the reference's: the topologies (the
  master's after every phase-1 epoch, each worker's after every phase-2
  epoch, the merged one) and the ``n_params`` history equal; the loss
  history at rtol 1e-4 and test accuracy within one test sample, the
  tolerances of ``tests/test_torch_device_train.py``. The fused run's
  device evolutions are fed the reference's draws.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.core import sparsity as jsp  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import wasap as jw  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import wasap as tw  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.interop import mlp_from_numpy, sgd_state_from_numpy  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6  # the phase-1 epoch against the reference
LOSS_RTOL = 1e-4  # a trainer's loss history against the reference


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(jm):
    return mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                          [np.asarray(v) for v in jm.values],
                          [np.asarray(b) for b in jm.biases], device="cpu")


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, str(w.dtype)), (what, i, g.dtype, w.dtype)
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=atol, err_msg=f"{what} {i}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{what} {i}")


def _bits(a, b, what):
    for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        assert torch.equal(x, y), f"{what}: leaf {i} differs"


# ---------------------------------------------------------------------------
# final merge (Algorithm 1 line 37): numpy in both packages, bit-equal
# ---------------------------------------------------------------------------


def _merge_both(topos, values, target):
    """``sparse_average_and_resparsify`` of both packages on the same
    (rows, cols) and values; asserts rows, cols and values equal."""
    jt = [jsp.ElementTopology(i, o, r, c) for i, o, r, c in topos]
    tt = [tsp.ElementTopology(i, o, r, c) for i, o, r, c in topos]
    jtop, jv = jw.sparse_average_and_resparsify(jt, values, target)
    ttop, tv = tw.sparse_average_and_resparsify(tt, values, target)
    np.testing.assert_array_equal(ttop.rows, jtop.rows)
    np.testing.assert_array_equal(ttop.cols, jtop.cols)
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == jv.dtype == np.float32
    return ttop, tv


def test_merge_union_then_prune():
    # tests/test_wasap.py: union of 4 slots, the weakest (3,3) dropped
    topos = [(4, 4, np.array([0, 1, 2]), np.array([0, 1, 2])),
             (4, 4, np.array([0, 3, 2]), np.array([0, 3, 2]))]
    values = [np.array([2.0, 0.5, -1.0], np.float32), np.array([4.0, -1.0, 0.2], np.float32)]
    topo, vals = _merge_both(topos, values, 3)
    dense = np.zeros((4, 4), np.float32)
    dense[topo.rows, topo.cols] = vals
    assert (dense[0, 0], dense[1, 1], dense[2, 2], dense[3, 3]) == (3.0, 0.25, -1.0, 0.0)


def test_merge_is_sign_aware():
    # tests/test_wasap.py: 0.2 survives and -0.6 does not, unlike a |v| ranking
    rows = np.arange(6, dtype=np.int32)
    topo, vals = _merge_both([(6, 6, rows, rows)],
                             [np.array([0.1, 0.2, -0.5, -0.6, -0.7, -0.8], np.float32)], 3)
    np.testing.assert_allclose(sorted(vals.tolist()), [-0.8, -0.7, 0.2], rtol=1e-6)


def test_merge_drops_exact_zeros_first():
    rows = np.arange(4, dtype=np.int32)
    topo, vals = _merge_both([(4, 4, rows, rows)],
                             [np.array([0.0, 3.0, -2.0, 0.9], np.float32)], 3)
    assert topo.nnz == 3 and 0.0 not in set(vals.tolist())


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("target_of", ["first", "smaller", "union"])
def test_merge_matches_the_reference_on_a_seeded_grid(seed, k, target_of):
    """K Erdős–Rényi topologies of a 40x30 layer with overlapping slots;
    values with exact zeros, ties, and pairs that average to exactly 0."""
    rng = np.random.default_rng(seed)
    topos, values = [], []
    for _ in range(k):
        t = jsp.ElementTopology.erdos_renyi(40, 30, 8, rng)
        v = np.round(rng.standard_normal(t.nnz), 1).astype(np.float32)  # ties
        v[rng.random(t.nnz) < 0.05] = 0.0
        topos.append((40, 30, t.rows, t.cols))
        values.append(v)
    if k > 1:  # the same slot with opposite values: an exact 0 average
        f0 = topos[0][2].astype(np.int64) * 30 + topos[0][3]
        f1 = topos[1][2].astype(np.int64) * 30 + topos[1][3]
        common, i0, i1 = np.intersect1d(f0, f1, return_indices=True)
        values[1][i1] = -values[0][i0]
    union = np.unique(np.concatenate([r.astype(np.int64) * 30 + c for _, _, r, c in topos])).size
    target = {"first": topos[0][2].size, "smaller": topos[0][2].size // 2, "union": union}[
        target_of]
    topo, vals = _merge_both(topos, values, target)
    assert topo.nnz == min(target, union)


# ---------------------------------------------------------------------------
# worker averaging
# ---------------------------------------------------------------------------


def _stacked_state(k=3, seed=0):
    """A stacked (K, ...) params tree and SGDState, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"values": [(37,), (11,)], "biases": [(5,), (3,)]}
    params = {key: [rng.standard_normal((k, *s)).astype(np.float32) for s in ss]
              for key, ss in shapes.items()}
    vel = {key: [rng.standard_normal((k, *s)).astype(np.float32) for s in ss]
           for key, ss in shapes.items()}
    step = np.full((k,), 7, np.int32)
    return params, vel, step


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0], [0.5, 2.0, 1.5]])
def test_average_pytree_and_cast_like_match_the_reference(weights):
    params, vel, step = _stacked_state()
    jtree = ({k: tuple(jnp.asarray(a) for a in v) for k, v in params.items()},
             jsgd.SGDState(velocity={k: tuple(jnp.asarray(a) for a in v)
                                     for k, v in vel.items()}, step=jnp.asarray(step)))
    ttree = ({k: tuple(torch.from_numpy(a) for a in v) for k, v in params.items()},
             tsgd.SGDState(velocity={k: tuple(torch.from_numpy(a) for a in v)
                                     for k, v in vel.items()}, step=torch.from_numpy(step)))
    jref = jax.tree.map(lambda a: a[0], jtree)
    tref = tw._take_worker0(ttree)
    jwts = None if weights is None else jnp.asarray(weights, jnp.float32)
    twts = None if weights is None else torch.tensor(weights, dtype=torch.float32)
    javg = jw._cast_like(jw._average_pytree(jtree, jwts), jref)
    tavg = tw._cast_like(tw._average_pytree(ttree, twts), tref)
    _close(tavg, javg, "average", rtol=1e-6, atol=0)
    assert tavg[1].step.dtype == torch.int32 and int(tavg[1].step) == 7
    # without the cast the mean promotes the step counter, as jnp.mean does
    assert tw._average_pytree(ttree, twts)[1].step.dtype == torch.float32


def test_average_is_a_sum_in_worker_order_then_a_division():
    a = torch.tensor([[1e8], [1.0], [-1e8], [3.0]], dtype=torch.float32)
    want = (((a[0] + a[1]) + a[2]) + a[3]) / 4
    assert torch.equal(tw._average_pytree(a), want)


# ---------------------------------------------------------------------------
# scan_masked_segment and the phase-1 epoch
# ---------------------------------------------------------------------------


def _phase1_case(seed=0, n=96, k=2, h=3, b=8, rounds=2, dropout=0.0):
    """tests/test_wasap.py's _phase1_case in both packages: dims (20, 16,
    5), epsilon 8, the last step of the last round padded."""
    rng = np.random.default_rng(seed)
    f, c = 20, 5
    x = rng.standard_normal((n, f)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    cfg = jmlp.SparseMLPConfig(layer_dims=(f, 16, c), epsilon=8, dropout=dropout,
                               impl="element")
    jm = jmlp.SparseMLP(cfg, seed=seed)
    tm = _port_model(jm)
    idx = rng.integers(0, n, (rounds, k, h, b)).astype(np.int32)
    valid = np.ones((rounds, h), np.float32)
    valid[-1, -1] = 0.0  # padded tail step
    lrs = np.full((rounds, h), 0.05, np.float32)
    j = SimpleNamespace(cfg=cfg, model=jm, opt=jsgd.MomentumSGD(momentum=0.9, weight_decay=1e-4),
                        x=jnp.asarray(x), y=jnp.asarray(y), idx=jnp.asarray(idx),
                        lrs=jnp.asarray(lrs), valid=jnp.asarray(valid))
    t = SimpleNamespace(cfg=tm.config, model=tm,
                        opt=tsgd.MomentumSGD(momentum=0.9, weight_decay=1e-4),
                        x=torch.from_numpy(x), y=torch.from_numpy(y).long(),
                        idx=torch.from_numpy(idx).long(), lrs=torch.from_numpy(lrs),
                        valid=torch.from_numpy(valid))
    return j, t


def _generator(seed=42):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_scan_masked_segment_matches_the_reference_and_keeps_masked_carries():
    j, t = _phase1_case()
    valid = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    idx = np.array(j.idx).reshape(-1, 8)[:5]
    lrs = np.full(5, 0.05, np.float32)
    jcore = jsteps.make_mlp_step_core(j.cfg, j.opt, j.model.topo_arrays(), j.x, j.y)
    tcore = tsteps.make_mlp_step_core(t.cfg, t.opt, t.model.topo_arrays(), t.x, t.y)
    jp, js, _, jm = jsteps.scan_masked_segment(
        jcore, j.model.params(), j.opt.init(j.model.params()), jax.random.PRNGKey(0),
        (jnp.asarray(idx), jnp.asarray(lrs)), jnp.asarray(valid))
    tp, ts, _, tm = tsteps.scan_masked_segment(
        tcore, t.model.params(), t.opt.init(t.model.params()), _generator(),
        (torch.from_numpy(idx).long(), torch.from_numpy(lrs)), torch.from_numpy(valid))
    _close((tp, ts), (jp, js), "masked segment")
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL, atol=ATOL)
    assert tm[1] == 0 and tm[4] == 0 and int(ts.step) == 3
    # within the port: the masked steps left the carry bit for bit as the
    # segment of the valid steps alone leaves it
    p, s, _, m = tsteps.scan_segment(
        tcore, t.model.params(), t.opt.init(t.model.params()), _generator(),
        (torch.from_numpy(idx[valid > 0]).long(), torch.from_numpy(lrs[valid > 0])))
    _bits((tp, ts), (p, s), "masked against valid-only")
    assert torch.equal(tm[valid > 0], m)


@pytest.mark.parametrize("average_momentum", [True, False])
@pytest.mark.parametrize("k", [2, 3])
def test_phase1_epoch_matches_the_reference(k, average_momentum):
    j, t = _phase1_case(k=k)
    jep = jw.make_phase1_epoch_fn(j.cfg, j.opt, n_workers=k, average_momentum=average_momentum)
    tep = tw.make_phase1_epoch_fn(t.cfg, t.opt, n_workers=k, average_momentum=average_momentum)
    keys = jax.random.split(jax.random.PRNGKey(42), 2 * k).reshape(2, k, 2)
    jp, jo, jl = jep(j.model.params(), j.opt.init(j.model.params()), j.model.topo_arrays(),
                     j.x, j.y, j.idx, j.lrs, j.valid, keys)
    tp, to, tl = tep(t.model.params(), t.opt.init(t.model.params()), t.model.topo_arrays(),
                     t.x, t.y, t.idx, t.lrs, t.valid, _generator())
    _close((tp, to), (jp, jo), "phase-1 epoch")
    assert int(to.step) == int(jo.step) == 5  # 6 steps, the padded one kept out
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


def test_weighted_phase1_epoch_matches_the_reference():
    """The elastic round's average (worker 1 weighted out) from a started
    state: velocity and a step count carried in with sgd_state_from_numpy."""
    j, t = _phase1_case(k=3)
    rng = np.random.default_rng(3)
    vel = {key: [(0.01 * rng.standard_normal(np.asarray(v).shape)).astype(np.float32)
                 for v in vs] for key, vs in j.model.params().items()}
    jstate = jsgd.SGDState(velocity={key: tuple(jnp.asarray(v) for v in vs)
                                     for key, vs in vel.items()},
                           step=jnp.asarray(4, jnp.int32))
    tstate = sgd_state_from_numpy(vel, 4, device="cpu")
    jep = jw.make_phase1_epoch_fn(j.cfg, j.opt, n_workers=3, weighted=True)
    tep = tw.make_phase1_epoch_fn(t.cfg, t.opt, n_workers=3, weighted=True)
    keys = jax.random.split(jax.random.PRNGKey(42), 6).reshape(2, 3, 2)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    jp, jo, jl = jep(j.model.params(), jstate, j.model.topo_arrays(), j.x, j.y, j.idx, j.lrs,
                     j.valid, keys, jnp.asarray(w))
    tp, to, tl = tep(t.model.params(), tstate, t.model.topo_arrays(), t.x, t.y, t.idx, t.lrs,
                     t.valid, _generator(), torch.from_numpy(w))
    _close((tp, to), (jp, jo), "weighted phase-1 epoch")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("average_momentum", [True, False])
def test_fused_epoch_matches_padded_round_loop_bit_for_bit(average_momentum):
    """Within the port: the epoch and the seed-era round loop take the same
    generator stream (round, worker, step) and give the same bits, at the
    reference test's dropout 0.2 and with its padded tail step."""
    _, t = _phase1_case(dropout=0.2)
    k = t.idx.shape[1]
    ep = tw.make_phase1_epoch_fn(t.cfg, t.opt, n_workers=k, average_momentum=average_momentum)
    topo = t.model.topo_arrays()
    params, state = t.model.params(), t.opt.init(t.model.params())
    p1, o1, l1 = ep(params, state, topo, t.x, t.y, t.idx, t.lrs, t.valid, _generator(7))
    round_fn = tw._make_worker_round(t.cfg, t.opt)
    gen = _generator(7)
    p, o, total = params, state, []
    for r in range(t.idx.shape[0]):
        xs = torch.stack([t.x[t.idx[r, w]] for w in range(k)])
        ys = torch.stack([t.y[t.idx[r, w]] for w in range(k)])
        sp, so, lsum = round_fn(tw._replicate(p, k), tw._replicate(o, k), topo, xs, ys,
                                t.lrs[r], t.valid[r], gen)
        p = tw._cast_like(tw._average_pytree(sp), p)
        o = tw._cast_like(tw._average_pytree(so), o) if average_momentum else tw._take_worker0(so)
        total.append(lsum.sum())
    _bits((p1, o1), (p, o), "fused epoch against the round loop")
    assert torch.equal(l1, torch.stack(total))


@pytest.mark.parametrize("mode", ["wasap", "wassp"])
def test_lr_schedules_match_the_reference(mode):
    fields = dict(n_workers=3, lr=0.013, lr_boost=2.5, lr_boost_epochs=2, warmup_steps=7,
                  mode=mode)
    jtr = SimpleNamespace(wc=jw.WASAPConfig(**fields))
    ttr = SimpleNamespace(wc=tw.WASAPConfig(**fields))
    for gstep in range(0, 40, 3):
        for epoch in range(4):
            assert tw.WASAPTrainer._lr(ttr, gstep, epoch) == jw.WASAPTrainer._lr(
                jtr, gstep, epoch)


# ---------------------------------------------------------------------------
# the trainer against the reference's
# ---------------------------------------------------------------------------


def make_model_and_data(seed=0, dropout=0.1, device="cpu"):
    """tests/test_wasap.py's model (784-64-32-10, epsilon 16) and data
    (fashionmnist at scale 0.02) in the port."""
    data = tdata.load("fashionmnist", scale=0.02, seed=seed)
    cfg = tmlp.SparseMLPConfig(
        layer_dims=(data.n_features, 64, 32, data.n_classes),
        epsilon=16, activation="all_relu", alpha=0.6, dropout=dropout, impl="element",
    )
    return tmlp.SparseMLP(cfg, seed=seed, device=device), data


def _reference_model_and_data(seed=0):
    data = jdata.load("fashionmnist", scale=0.02, seed=seed)
    cfg = jmlp.SparseMLPConfig(
        layer_dims=(data.n_features, 64, 32, data.n_classes),
        epsilon=16, activation="all_relu", alpha=0.6, dropout=0.0, impl="element",
    )
    return jmlp.SparseMLP(cfg, seed=seed), data


def _topology(rows, cols):
    return np.asarray(rows).copy(), np.asarray(cols).copy()


def _spy_host_evolutions(monkeypatch, module, store):
    """Record the topology each host ``evolve_element`` call of ``module``
    (the master's, then each phase-2 worker's, per layer) returns."""
    real = module.evolve_element

    def spy(*args, **kwargs):
        res = real(*args, **kwargs)
        store.append(_topology(res.topology.rows, res.topology.cols))
        return res

    monkeypatch.setattr(module, "evolve_element", spy)


def _spy_reference_device_evolutions(monkeypatch, draws, store):
    """Wrap the reference's device evolutions (``repro.core.wasap.
    evolve_element_layers_device``): record each layer's draws, made from
    the key as the reference makes them, and the topologies it returns."""
    real = jw.evolve_element_layers_device

    def spy(topo_arrays, values, velocity, key, *, layer_dims, zeta,
            init_scheme="he_uniform", probe=False):
        keys = jax.random.split(key, len(topo_arrays))
        for l, t in enumerate(topo_arrays):
            n, total = int(t.rows.shape[0]), layer_dims[l] * layer_dims[l + 1]
            k_grow, k_init = jax.random.split(keys[l])
            cand = jax.random.randint(k_grow, (2 * n,), 0, total, dtype=jnp.int32)
            init = jtopo._init_device(k_init, (n,), fan_in_dense=layer_dims[l],
                                      scheme=init_scheme)
            draws.append((n, total, np.asarray(cand), np.asarray(init)))
        out = real(topo_arrays, values, velocity, key, layer_dims=layer_dims, zeta=zeta,
                   init_scheme=init_scheme, probe=probe)
        store.extend(_topology(t.rows, t.cols) for t in out[0])
        return out

    monkeypatch.setattr(jw, "evolve_element_layers_device", spy)


def _spy_port_device_evolutions(monkeypatch, draws, store):
    """Feed the port's device evolutions ``draws`` in order (``core.
    topology.evolution_draws``, replaced) and record the topologies they
    return. Returns the iterator over the draws."""
    taken = iter(draws)

    def fake(generator, n, total, *, fan_in_dense, scheme):
        want_n, want_total, cand, init = next(taken)
        assert (n, total) == (want_n, want_total)
        return torch.tensor(cand), torch.tensor(init)

    monkeypatch.setattr(ttopo, "evolution_draws", fake)
    real = tw.evolve_element_layers_device

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        store.extend(_topology(t.rows, t.cols) for t in out[0])
        return out

    monkeypatch.setattr(tw, "evolve_element_layers_device", spy)
    return taken


WC = dict(n_workers=3, phase1_epochs=2, phase2_epochs=2, sync_every=3, lr=0.01, zeta=0.2,
          seed=0, batch_size=16)


@pytest.mark.parametrize("fused", [False, True], ids=["round_loop", "fused"])
def test_trainer_matches_the_reference(monkeypatch, fused):
    """2 phase-1 epochs (25 steps a worker-epoch, H = 3: 9 rounds, the last
    with 2 padded steps) and 2 phase-2 epochs of 3 workers, then the merge.
    Round loop: host SET on both packages' numpy rngs. Fused: device SET,
    the port fed the reference's draws."""
    jm, jdata_ = _reference_model_and_data()
    tm, tdata_ = make_model_and_data(dropout=0.0)
    for a, b in zip(tm.topos, jm.topos):  # the same seeded model
        np.testing.assert_array_equal(a.rows, b.rows)
    jtopos, ttopos = [], []
    if fused:
        draws = []
        _spy_reference_device_evolutions(monkeypatch, draws, jtopos)
        jt = jw.WASAPTrainer(jm, jdata_, jw.WASAPConfig(**WC, fused=True))
        hj = jt.run()
        taken = _spy_port_device_evolutions(monkeypatch, draws, ttopos)
    else:
        _spy_host_evolutions(monkeypatch, jw, jtopos)
        _spy_host_evolutions(monkeypatch, tw, ttopos)
        jt = jw.WASAPTrainer(jm, jdata_, jw.WASAPConfig(**WC, fused=False))
        hj = jt.run()
    tt = tw.WASAPTrainer(tm, tdata_, tw.WASAPConfig(**WC, fused=fused))
    assert tt._fused == fused
    ht = tt.run()
    if fused:
        assert next(taken, None) is None  # the port took every draw the reference made
    # evolutions: the master after each phase-1 epoch, then each worker's
    # after each phase-2 epoch, per layer
    assert len(ttopos) == len(jtopos) == (2 + 2 * 3) * 3
    for i, ((rt, ct), (rj, cj)) in enumerate(zip(ttopos, jtopos)):
        np.testing.assert_array_equal(rt, rj, err_msg=f"evolution {i}")
        np.testing.assert_array_equal(ct, cj, err_msg=f"evolution {i}")
    for l, (a, b) in enumerate(zip(tm.topos, jm.topos)):  # the merged topology
        np.testing.assert_array_equal(a.rows, b.rows, err_msg=f"merged layer {l}")
        np.testing.assert_array_equal(a.cols, b.cols, err_msg=f"merged layer {l}")
    assert ht["epoch"] == hj["epoch"] == [0, 1, 2, 3, 4]
    assert ht["phase"] == hj["phase"] == [1, 1, 2, 2, "final"]
    assert ht["n_params"] == hj["n_params"]
    assert ht["n_params"][-1] == ht["n_params"][0]
    np.testing.assert_allclose(ht["train_loss"], hj["train_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ht["test_acc"], hj["test_acc"],
                               atol=1.0 / len(tdata_.y_test) + 1e-9)
    for a, b in zip(tm.values, jm.values):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the reference's trainer tests, on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["wasap", "wassp"])
def test_wasap_two_phase_learns(mode):
    model, data = make_model_and_data()
    wc = tw.WASAPConfig(
        n_workers=3, phase1_epochs=4, phase2_epochs=2, sync_every=3,
        lr=0.01, zeta=0.2, mode=mode, seed=0, batch_size=16,
    )
    hist = tw.WASAPTrainer(model, data, wc).run()
    assert hist["phase"][-1] == "final"
    assert hist["test_acc"][-1] > 0.5, (mode, hist["test_acc"])  # chance = 0.1
    # sparsity restored to the target level after the merge
    assert hist["n_params"][-1] == hist["n_params"][0]


def test_wasap_legacy_roundloop_learns():
    model, data = make_model_and_data()
    wc = tw.WASAPConfig(
        n_workers=3, phase1_epochs=4, phase2_epochs=2, sync_every=3,
        lr=0.01, zeta=0.2, seed=0, batch_size=16, fused=False,
    )
    hist = tw.WASAPTrainer(model, data, wc).run()
    assert hist["test_acc"][-1] > 0.5
    assert hist["n_params"][-1] == hist["n_params"][0]


def test_wasap_phase2_topologies_diverge_then_merge():
    model, data = make_model_and_data(seed=1)
    start_nnz = [t.nnz for t in model.topos]
    wc = tw.WASAPConfig(
        n_workers=2, phase1_epochs=1, phase2_epochs=2, sync_every=2,
        lr=0.03, zeta=0.3, seed=1, batch_size=16,
    )
    trainer = tw.WASAPTrainer(model, data, wc)
    merged = []
    real = trainer._merge_workers
    trainer._merge_workers = lambda states: (merged.append(states), real(states))
    trainer.run()
    assert [t.nnz for t in model.topos] == start_nnz
    (w0, w1), = merged
    assert any(not np.array_equal(a.rows, b.rows) for a, b in zip(w0[0], w1[0]))  # diverged


# ---------------------------------------------------------------------------
# registries of the kernels' plans under K live topologies
# ---------------------------------------------------------------------------


def test_k_workers_device_arrays_keep_their_plans():
    """Phase 2 holds K workers x 4 layers of device-made arrays at once:
    every one keeps its own offsets and F plan registered (a miss would
    cost a host sync on the card), and each is its own topology's."""
    rng = np.random.default_rng(0)
    dims = (30, 24, 16, 20, 10)
    k = 4
    workers = []
    for wk in range(k):
        host = [tsp.ElementTopology.erdos_renyi(dims[l], dims[l + 1], 6, rng)
                for l in range(4)]
        arrays = [h.device_arrays(torch.device("cpu")) for h in host]
        vals = [torch.from_numpy(rng.standard_normal(h.nnz).astype(np.float32)) for h in host]
        gen = _generator(wk)
        new, _, _, _ = ttopo.evolve_element_layers_device(
            arrays, vals, [torch.zeros_like(v) for v in vals], gen, layer_dims=dims, zeta=0.3)
        workers.append(new)
    for wk, new in enumerate(workers):
        for l, t in enumerate(new):
            col_ptr = tsp.registered_offsets(t.cols)
            row_ptr = tsp.registered_offsets(t.rows_r)
            assert col_ptr is not None and row_ptr is not None, (wk, l)
            assert tsp._recall(tsp._DW_RUNS, t.cols) is not None, (wk, l)
            host = tsp.ElementTopology(dims[l], dims[l + 1], t.rows.numpy(), t.cols.numpy())
            np.testing.assert_array_equal(col_ptr.numpy(), host.col_ptr())
            np.testing.assert_array_equal(row_ptr.numpy(), host.row_ptr())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _trainer(**wc):
    model, data = make_model_and_data()
    return tw.WASAPTrainer(model, data, tw.WASAPConfig(n_workers=2, phase1_epochs=1,
                                                       phase2_epochs=0, **wc))


@pytest.mark.parametrize("what,make,item", [
    ("shard_map trainer", lambda: _trainer(worker_axis="shard_map"), "item 9"),
    ("shard_map epoch", lambda: tw.make_phase1_epoch_fn(
        _trainer().model.config, tsgd.MomentumSGD(), n_workers=2, worker_axis="shard_map"),
     "item 9"),
    ("donate", lambda: tw.make_phase1_epoch_fn(
        _trainer().model.config, tsgd.MomentumSGD(), n_workers=2, donate=(0, 1)), "item 5"),
])
def test_refusals_name_their_roadmap_item(what, make, item):
    with pytest.raises(NotImplementedError, match=item):
        make()


@pytest.mark.parametrize("seam,value", [("monitor", object()), ("fault_hook", lambda s: None),
                                        ("step_retries", 2)])
def test_run_refuses_the_runtime_seams(seam, value):
    trainer = _trainer()
    setattr(trainer, seam, value)
    with pytest.raises(NotImplementedError, match="item 5"):
        trainer.run()


def test_block_models_are_refused():
    data = tdata.load("fashionmnist", scale=0.02)
    cfg = tmlp.SparseMLPConfig(layer_dims=(784, 64, 10), impl="block", block_m=8, block_n=8)
    with pytest.raises(ValueError, match="element"):
        tw.WASAPTrainer(tmlp.SparseMLP(cfg, device="cpu"), data, tw.WASAPConfig())


def test_int32_overflow_warns_and_takes_the_round_loop():
    """A layer whose flat positions overflow int32 cannot take the device
    path: the trainer warns and runs the seed round loop, as the
    reference's."""
    model, data = make_model_and_data()
    big = dataclasses.replace(model.config, layer_dims=(70000, 40000, 10))
    model.config = big  # only the check reads it
    with pytest.warns(UserWarning, match="falling back"):
        trainer = tw.WASAPTrainer(model, data, tw.WASAPConfig(n_workers=2))
    assert not trainer._fused and hasattr(trainer, "_round")


# ---------------------------------------------------------------------------
# training-dynamics probes (obs.probes)
# ---------------------------------------------------------------------------


def test_probed_phase1_epoch_matches_the_reference_and_the_unprobed_epoch():
    """``probe=True``: the epoch's state and losses are the unprobed
    epoch's, bit for bit, and its probe stats (the averaged master on the
    epoch's first batch) are the reference's within 1e-4 (histograms
    equal)."""
    j, t = _phase1_case(k=2)
    jep = jw.make_phase1_epoch_fn(j.cfg, j.opt, n_workers=2, probe=True)
    keys = jax.random.split(jax.random.PRNGKey(42), 4).reshape(2, 2, 2)
    *_, jstats = jep(j.model.params(), j.opt.init(j.model.params()), j.model.topo_arrays(),
                     j.x, j.y, j.idx, j.lrs, j.valid, keys)
    args = (t.model.params(), t.opt.init(t.model.params()), t.model.topo_arrays(), t.x, t.y,
            t.idx, t.lrs, t.valid)
    off = tw.make_phase1_epoch_fn(t.cfg, t.opt, n_workers=2)(*args, _generator())
    on = tw.make_phase1_epoch_fn(t.cfg, t.opt, n_workers=2, probe=True)(*args, _generator())
    assert len(off) == 3 and len(on) == 4
    _bits((on[0], on[1]), (off[0], off[1]), "probed phase-1 epoch")
    assert torch.equal(on[2], off[2])
    stats = on[3]
    assert set(stats) == set(jstats)
    for k, w in jstats.items():
        if k.endswith("_hist"):
            np.testing.assert_array_equal(stats[k].numpy(), np.asarray(w), err_msg=k)
        else:
            np.testing.assert_allclose(stats[k].numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_probed_trainer_records_both_phases(tmp_path):
    """A probed fused WASAP run: one ``wasap`` snapshot per epoch of both
    phases (phase 1's with the master's churn, phase 2's worker 0's), the
    spans of both phases, and the unprobed run's history and model."""
    from repro_torch import obs
    from repro_torch.obs import timeline

    def run(probe):
        model, data = make_model_and_data(dropout=0.0)
        wc = tw.WASAPConfig(n_workers=2, phase1_epochs=2, phase2_epochs=1, batch_size=32,
                            probe=probe)
        trainer = tw.WASAPTrainer(model, data, wc)
        if probe:
            with obs.trace_to(str(tmp_path / "t.jsonl")), \
                    timeline.timeline_to(tmp_path / "tl.jsonl", run_id="w"):
                hist = trainer.run()
        else:
            with obs.disabled():
                hist = trainer.run()
        return {k: v for k, v in hist.items() if k != "epoch_seconds"}, model

    (h1, m1), (h0, m0) = run(True), run(False)
    np.testing.assert_equal(h1, h0)
    for a, b in zip(m1.values, m0.values):
        assert torch.equal(a, b)
    events = timeline.read_timeline(tmp_path / "tl.jsonl")
    assert timeline.validate_timeline(events) == []
    snaps = timeline.snapshots(events, "wasap")
    assert [s["extra"]["phase"] for s in snaps] == [1, 1, 2]
    assert all("churn_frac" in s["layers"][0] for s in snaps)
    spans = {e["name"] for e in obs.read_events(str(tmp_path / "t.jsonl")) if e["ev"] == "span"}
    assert spans == {"wasap.run", "wasap.epoch", "wasap.sync_rounds", "wasap.worker_segments",
                     "wasap.merge"}
