"""Resuming the port's trainers from checkpoints, on the CPU.

* **The port against itself.** A trainer saves at every epoch boundary
  through ``epoch_end_hook``; a fresh trainer restores the epoch-0
  checkpoint and runs on. Its ``train_loss``, ``test_acc`` and ``n_params``
  histories and its final values, biases and topologies are bit-equal to
  the run that never stopped, for element and block models, fused (device
  SET and host SET) and per-batch, at dropout 0.2 (the generator's stream
  must resume too); and the hook's saves leave the run as it was without
  them. WASAP the same, resumed at a phase-1 epoch, at the phase boundary
  and at a phase-2 epoch. The device SET's arrays, their offsets and F's
  plan, rebuilt from a checkpoint's host topology, equal the live run's slot
  for slot.
* **Across the packages.** A reference ``SequentialTrainer`` checkpoint
  (element and block) is restored by the port and the port's by the
  reference: params, velocity, topology, counters, ``numpy_rng`` and history
  equal; the restored models' logits on numpy-seeded inputs at rtol = atol
  = 1e-5 (the reference's sums run in another order); and, with host SET at
  dropout 0, the continued run follows the writer's in topology and
  ``n_params`` every epoch and in loss at rtol 1e-4, test accuracy within
  one test sample (the tolerances of ``tests/test_torch_train.py``). WASAP
  checkpoints of both phases load across in both directions with their
  state equal.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core import importance as jimp  # noqa: E402
from repro.core import wasap as jw  # noqa: E402
from repro.data import datasets as jdata  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import importance as timp  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.core import wasap as tw  # noqa: E402
from repro_torch.data import datasets as tdata  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TRAJ = ("epoch", "train_loss", "test_acc", "n_params")
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-4
FIELDS = dict(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, block_m=8, block_n=8)
MODES = {"fused_device_set": (True, True), "fused_host_set": (True, False),
         "per_batch": (False, False)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return tdata.load("fashionmnist", scale=0.01)


def _config(module, impl, dropout):
    return module.SparseMLPConfig(**FIELDS, impl=impl, dropout=dropout)


def _train_config(module, schedule, fused, device_evolution):
    return module.TrainerConfig(epochs=3, batch_size=32, fused_epochs=fused,
                                device_evolution=device_evolution, seed=1,
                                pruning=schedule(tau=1, period=1, percentile=10.0))


def _port_trainer(data, impl, fused=True, device_evolution=True, dropout=0.2):
    model = tmlp.SparseMLP(_config(tmlp, impl, dropout), seed=1, device="cpu")
    return ttrainer.SequentialTrainer(
        model, data, _train_config(ttrainer, timp.PruningSchedule, fused, device_evolution))


def _ref_trainer(impl, fused=True):
    model = jmlp.SparseMLP(_config(jmlp, impl, 0.0), seed=1)
    data = jdata.load("fashionmnist", scale=0.01)
    return jtrainer.SequentialTrainer(
        model, data, _train_config(jtrainer, jimp.PruningSchedule, fused, False))


def _saving(mgr, topologies=None):
    """An epoch-end hook that saves, and records the host mirror."""

    def hook(trainer, epoch):
        trainer.save_checkpoint(mgr)
        if topologies is not None:
            topologies.append([(np.array(t.rows), np.array(t.cols))
                               for t in trainer.model.topos])

    return hook


def _same_history(got, want):
    for key in TRAJ:
        assert got[key] == want[key], (key, got[key], want[key])


def _same_state(a, b):
    """Two port trainers' models: values, biases and topologies bit-equal."""
    for x, y in zip(a.model.values + a.model.biases, b.model.values + b.model.biases):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for s, t in zip(a.model.topos, b.model.topos):
        np.testing.assert_array_equal(s.rows, t.rows)
        np.testing.assert_array_equal(s.cols, t.cols)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("impl", ["element", "block"])
def test_port_resume_is_bit_equal(tmp_path, data, impl, mode):
    fused, device_evolution = MODES[mode]
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    live = _port_trainer(data, impl, fused, device_evolution)
    live.epoch_end_hook = _saving(mgr)
    hist = live.run()
    mgr.wait()
    # saving at every epoch (and the mirror sync before it) leaves the run
    # exactly as without a hook
    unhooked = _port_trainer(data, impl, fused, device_evolution)
    _same_history(unhooked.run(), hist)
    _same_state(unhooked, live)

    steps = mgr.all_steps()
    assert len(steps) == 3 and mgr.verify_step(steps[0]) is None
    resumed = _port_trainer(data, impl, fused, device_evolution)
    assert resumed.restore_checkpoint(mgr, steps[0]) == steps[0]
    assert (resumed.start_epoch, resumed.gstep) == (1, steps[0])
    _same_history(resumed.run(), hist)
    _same_state(resumed, live)


@pytest.mark.parametrize("impl", ["element", "block"])
def test_rebuilt_arrays_equal_the_live_device_set_arrays(tmp_path, data, impl):
    """The arrays a resumed run makes from the saved host topology are the
    live run's, slot for slot: every field, and for an element model kernel
    A's offsets of both orders and F's run plan (the live one's padding
    runs stripped)."""
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    live = _port_trainer(data, impl)
    live.epoch_end_hook = _saving(mgr)
    arrays = []
    phase = live._topology_phase

    def recording(*args):
        out = phase(*args)
        arrays.append(out[0])
        return out

    live._topology_phase = recording
    live.run()
    for epoch, step in enumerate(mgr.all_steps()):
        resumed = _port_trainer(data, impl)
        resumed.restore_checkpoint(mgr, step)
        rebuilt = resumed.model.topo_arrays()
        for l, (a, b) in enumerate(zip(arrays[epoch], rebuilt)):
            for field in a._fields:
                assert torch.equal(getattr(a, field), getattr(b, field)), (epoch, l, field)
            if impl != "element":
                continue
            for idx in ("cols", "rows_r"):
                assert torch.equal(tsp.registered_offsets(getattr(a, idx)),
                                   tsp.registered_offsets(getattr(b, idx))), (epoch, l, idx)
            n_out = FIELDS["layer_dims"][l + 1]
            pa, pb = (tsp.dw_plan(t.rows, t.cols, n_out) for t in (a, b))
            assert torch.equal(pa.runs[pa.runs[:, 0] >= 0], pb.runs), (epoch, l)


WASAP = dict(n_workers=2, phase1_epochs=2, phase2_epochs=2, sync_every=3, batch_size=16, seed=2)


def _port_wasap(data, dropout=0.2, **wc):
    model = tmlp.SparseMLP(_config(tmlp, "element", dropout), seed=2, device="cpu")
    return tw.WASAPTrainer(model, data, tw.WASAPConfig(**dict(WASAP, **wc)))


@pytest.fixture(scope="module")
def wasap_live(tmp_path_factory, data):
    """A 2+2-epoch WASAP run saving at every epoch boundary (steps 1-4)."""
    torch.set_num_threads(1)
    mgr = CheckpointManager(str(tmp_path_factory.mktemp("wasap")), keep_last=10)
    live = _port_wasap(data)
    live.epoch_end_hook = _saving(mgr)
    hist = live.run()
    mgr.wait()
    return live, hist, mgr


def _same_wasap_history(got, want):
    """Bit-equal, NaN equal to NaN (phase 2 does not evaluate)."""
    for key in TRAJ:
        np.testing.assert_array_equal(np.asarray(got[key], float), np.asarray(want[key], float),
                                      err_msg=key)
    assert got["phase"] == want["phase"]


@pytest.mark.parametrize("step", [1, 2, 3], ids=["phase1", "phase_boundary", "phase2"])
def test_wasap_resume_is_bit_equal(wasap_live, data, step):
    live, hist, mgr = wasap_live
    assert mgr.all_steps() == [1, 2, 3, 4]
    phase = mgr.read_manifest(step)["meta"]["resume"]["phase"]
    assert phase == (1 if step <= WASAP["phase1_epochs"] else 2)
    resumed = _port_wasap(data)
    resumed.restore_checkpoint(mgr, step)
    assert (resumed.start_epoch, resumed._phase) == (step, phase)
    _same_wasap_history(resumed.run(), hist)
    _same_state(resumed, live)


def test_wasap_round_loop_refuses_checkpoints(data):
    trainer = _port_wasap(data, fused=False)
    with pytest.raises(RuntimeError, match="fused path"):
        trainer.save_checkpoint(None)


def test_generator_resumes_only_on_its_device_type():
    g = torch.Generator()
    g.manual_seed(3)
    torch.rand(5, generator=g)
    entry = ttrainer.generator_entry(g)
    h = torch.Generator()
    ttrainer.restore_generator(h, entry, [0, 0])
    assert torch.equal(torch.rand(7, generator=g), torch.rand(7, generator=h))
    with pytest.raises(ValueError, match="cuda.*cpu"):
        ttrainer.restore_generator(h, dict(entry, device="cuda"), [0, 0])
    # a reference checkpoint has only a jax key: the documented seed
    ttrainer.restore_generator(h, None, [1, 2])
    assert h.initial_seed() == (1 << 32) | 2 == ttrainer.seed_from_jax_key([1, 2])
    words = ttrainer.jax_key_words(g)
    assert len(words) == 2 and all(0 <= w < 2**32 for w in words)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _snapshot(trainer, x, port: bool) -> dict:
    """A trainer's resume state and its model's logits on ``x``, as numpy."""
    m = trainer.model
    vel = trainer.opt_state.velocity
    if port:
        with torch.no_grad():
            logits = tmlp.mlp_forward(m.params(), m.topo_arrays(), torch.from_numpy(x), m.config)
        leaves = [t.numpy() for t in tree_leaves(m.params()) + tree_leaves(vel)]
    else:
        logits = jmlp.mlp_forward(m.params(), m.topo_arrays(), jnp.asarray(x), m.config,
                                  train=False)
        leaves = [np.asarray(a) for a in jax.tree.leaves(m.params()) + jax.tree.leaves(vel)]
    return dict(
        leaves=leaves, logits=np.asarray(logits),
        topos=[(np.array(t.rows), np.array(t.cols)) for t in m.topos],
        counters=(trainer.epoch_next, trainer.gstep, int(trainer.opt_state.step)),
        rng=trainer.rng.bit_generator.state,
        history={k: list(trainer.history[k]) for k in TRAJ},
    )


def _same_snapshot(got, want):
    assert len(got["leaves"]) == len(want["leaves"])
    for g, w in zip(got["leaves"], want["leaves"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for (ra, ca), (rb, cb) in zip(got["topos"], want["topos"]):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(ca, cb)
    assert got["counters"] == want["counters"]
    assert got["rng"] == want["rng"]
    assert got["history"] == want["history"]
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("impl", ["element", "block"])
def test_sequential_checkpoints_cross_packages(tmp_path, data, impl, writer):
    x = np.random.default_rng(7).standard_normal((9, FIELDS["layer_dims"][0])).astype(np.float32)
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    wtopos, snaps = [], []
    if writer == "reference":
        w = _ref_trainer(impl)
        w_mgr = jmanager.CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    else:
        w = _port_trainer(data, impl, device_evolution=False, dropout=0.0)
        w_mgr = mgr
    save = _saving(w_mgr, wtopos)

    def hook(trainer, epoch):
        save(trainer, epoch)
        snaps.append(_snapshot(trainer, x, port=writer == "port"))

    w.epoch_end_hook = hook
    whist = w.run()
    step = w_mgr.all_steps()[0]

    rtopos = []
    if writer == "reference":  # the port reads
        r = _port_trainer(data, impl, device_evolution=False, dropout=0.0)
        r.restore_checkpoint(mgr, step)
    else:
        r = _ref_trainer(impl)
        r.restore_checkpoint(jmanager.CheckpointManager(str(tmp_path), async_write=False), step)
    _same_snapshot(_snapshot(r, x, port=writer == "reference"), snaps[0])
    r.epoch_end_hook = lambda tr, epoch: rtopos.append(
        [(np.array(t.rows), np.array(t.cols)) for t in tr.model.topos])
    rhist = r.run()

    assert rhist["epoch"] == whist["epoch"] and rhist["n_params"] == whist["n_params"]
    assert len(rtopos) == 2
    for a, b in zip(rtopos, wtopos[1:]):
        for (ra, ca), (rb, cb) in zip(a, b):
            np.testing.assert_array_equal(ra, rb)
            np.testing.assert_array_equal(ca, cb)
    np.testing.assert_allclose(rhist["train_loss"], whist["train_loss"], rtol=LOSS_RTOL)
    n_test = len(data.y_test)
    np.testing.assert_allclose(rhist["test_acc"], whist["test_acc"], atol=1.0 / n_test + 1e-9)


def _ref_wasap():
    model = jmlp.SparseMLP(_config(jmlp, "element", 0.0), seed=2)
    cfg = dict(WASAP, phase1_epochs=1, phase2_epochs=1)
    return jw.WASAPTrainer(model, jdata.load("fashionmnist", scale=0.01), jw.WASAPConfig(**cfg))


def _wasap_state(trainer, port: bool) -> list:
    """The numpy arrays a WASAP checkpoint restores: phase 1's averaged
    master (params, velocity, device topology), or phase 2's master params
    and topology and each worker's params, velocity and topology."""
    as_np = (lambda a: a.numpy()) if port else np.asarray
    leaves = tree_leaves if port else jax.tree.leaves

    def topo(ts):
        return [as_np(f) for t in ts for f in (t.rows, t.cols)]

    if trainer._phase == 1:
        params, opt, t = trainer._p1_state
        return [as_np(a) for a in leaves(params) + leaves(opt.velocity)] + topo(t)
    out = [as_np(a) for a in leaves(trainer.model.params())]
    out += [np.array(a) for t in trainer.model.topos for a in (t.rows, t.cols)]
    for w in trainer._p2_workers:
        out += [as_np(a) for a in leaves(w["params"]) + leaves(w["opt"].velocity)] + topo(w["topo"])
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_wasap_checkpoints_cross_packages(tmp_path, data, writer):
    """Both phases' checkpoints load across: phase 1 at its last epoch (the
    averaged master), phase 2 (the master and both workers)."""
    saved = {}

    def hook(trainer, epoch):
        trainer.save_checkpoint(w_mgr)
        saved[epoch + 1] = _wasap_state(trainer, port=writer == "port")

    if writer == "reference":
        w = _ref_wasap()
        w_mgr = jmanager.CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    else:
        w = _port_wasap(data, dropout=0.0, phase1_epochs=1, phase2_epochs=1)
        w_mgr = CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    w.epoch_end_hook = hook
    w.run()
    assert sorted(saved) == [1, 2]
    for step in (1, 2):
        if writer == "reference":
            r = _port_wasap(data, dropout=0.0, phase1_epochs=1, phase2_epochs=1)
            r.restore_checkpoint(CheckpointManager(str(tmp_path)), step)
        else:
            r = _ref_wasap()
            r.restore_checkpoint(jmanager.CheckpointManager(str(tmp_path)), step)
        assert (r._phase, r.epoch_next) == (step, step)
        got = _wasap_state(r, port=writer == "reference")
        assert len(got) == len(saved[step])
        for g, want in zip(got, saved[step]):
            assert g.dtype == want.dtype
            np.testing.assert_array_equal(g, want)
        _same_wasap_history(r.history, w_mgr.read_manifest(step)["meta"]["resume"]["history"])
