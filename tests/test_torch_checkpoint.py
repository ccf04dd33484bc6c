"""The port's ``CheckpointManager`` (``repro_torch.checkpoint``) on the CPU:
the twins of ``tests/test_checkpoint.py``, the checkpoint tests of
``tests/test_distributed_substrate.py`` and ``tests/test_resilience.py``
(corruption detected, quarantined, named) and the streamed save of
``tests/test_xl.py`` (without XL), then checkpoints crossing between the
packages in both directions.

Leaves cross bit for bit: every comparison here is exact. The leaf names are
held to ``jax.tree_util.tree_flatten_with_path``'s, which the reference's
file names come from.
"""
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.runtime import faultinject as fi  # noqa: E402
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_leaves  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _tree(seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.as_tensor(rng.standard_normal((4, 3))).to(dtype),
        "nested": {
            "b": torch.as_tensor(rng.standard_normal(5)).to(dtype),
            "step": torch.tensor(7, dtype=torch.int32),
        },
        "stack": [torch.as_tensor(rng.standard_normal(2)).to(dtype)],
    }


def _like(t):
    """A like tree: the structure and dtypes, no values."""
    return {"w": torch.zeros_like(t["w"]),
            "nested": {"b": torch.zeros_like(t["nested"]["b"]),
                       "step": torch.zeros_like(t["nested"]["step"])},
            "stack": [torch.zeros_like(t["stack"][0])]}


def _as_tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))


def _assert_tree_equal(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = _as_tensor(g)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# leaf names: the reference's file names
# ---------------------------------------------------------------------------


def _jax_names(tree):
    return [name for name, _ in jmanager._flatten_with_names(tree)[0]]


def _params_pair(rng, n_layers=3):
    shapes = [(11,), (7,), (5,)][:n_layers]
    vals = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    bias = [rng.standard_normal(3 + l).astype(np.float32) for l in range(n_layers)]
    jtree = {"values": tuple(map(jnp.asarray, vals)), "biases": tuple(map(jnp.asarray, bias))}
    ttree = {"values": tuple(map(torch.from_numpy, vals)),
             "biases": tuple(map(torch.from_numpy, bias))}
    return jtree, ttree


@pytest.mark.parametrize("kind", ["params", "sgd_state", "wasap_groups"])
def test_leaf_names_match_jax_key_paths(kind):
    rng = np.random.default_rng(0)
    jtree, ttree = _params_pair(rng)
    if kind == "sgd_state":
        jtree = jsgd.SGDState(velocity=jtree, step=jnp.asarray(3, jnp.int32))
        ttree = tsgd.SGDState(velocity=ttree, step=torch.tensor(3, dtype=torch.int32))
    elif kind == "wasap_groups":
        # the phase-2 checkpoint's extra groups: per-worker params and velocity
        jtree = {f"w{k}_{g}": jtree for k in range(2) for g in ("params", "velocity")}
        ttree = {f"w{k}_{g}": ttree for k in range(2) for g in ("params", "velocity")}
    named, unflatten = tree_flatten_with_names(ttree)
    assert [n for n, _ in named] == _jax_names(jtree)
    for (_, t), j in zip(named, jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # rebuilt in the same structure, NamedTuples included
    rebuilt = unflatten([n for n, _ in named])
    assert type(rebuilt) is type(ttree)
    assert tree_leaves(rebuilt) == [n for n, _ in named]


def test_leaf_names_example_and_none():
    a, b, c = (torch.zeros(1) for _ in range(3))
    named, _ = tree_flatten_with_names({"values": (a, b), "biases": (c,), "gone": None})
    assert [n for n, _ in named] == ["biases__0", "values__0", "values__1"]


# ---------------------------------------------------------------------------
# the twins of tests/test_checkpoint.py
# ---------------------------------------------------------------------------


def test_roundtrip_f32(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(0)
    mgr.save(3, t, meta={"note": "x"})
    params, extra, topos, manifest = mgr.restore(like=_like(t))
    assert all(isinstance(a, np.ndarray) for a in tree_leaves(params))  # numpy, as the reference
    _assert_tree_equal(params, t)
    assert extra == {} and topos == {}
    assert manifest["step"] == 3 and manifest["meta"]["note"] == "x"
    # manifest records shapes/dtypes per leaf
    assert manifest["shapes"]["w"] == [[4, 3], "float32"]


def test_roundtrip_bf16_raw_void_view(tmp_path):
    """bf16 leaves are written as the reference writes them, raw '<V2', and
    come back as torch.bfloat16 through int16."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(1, dtype=torch.bfloat16)
    mgr.save(1, t)
    raw = np.load(tmp_path / "step_000000001" / "arrays" / "w.npy")
    assert raw.dtype.kind == "V"
    with open(tmp_path / "step_000000001" / "arrays" / "w.npy", "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    params, _, _, manifest = mgr.restore(like=_like(t))
    _assert_tree_equal(params, t)
    assert manifest["shapes"]["w"] == [[4, 3], "bfloat16"]


def test_extra_groups_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(2)
    opt = {"velocity": {"w": t["w"] * 2, "nested": {"b": t["nested"]["b"] * 2,
                                                     "step": t["nested"]["step"] * 2},
                        "stack": [t["stack"][0] * 2]}}
    mgr.save(5, t, extra=opt)
    like = _like(t)
    _, extra, _, _ = mgr.restore(like=like, like_extra={"velocity": like})
    _assert_tree_equal(extra["velocity"], opt["velocity"])


def test_topology_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    topo = {
        "layer0": {"rows": np.arange(6, dtype=np.int32),
                   "cols": np.arange(6, dtype=np.int32)[::-1].copy()},
        # tensors too: the trainers pass device arrays
        "layer1": {"rows": torch.zeros(2, dtype=torch.int32),
                   "cols": torch.ones(2, dtype=torch.int32)},
    }
    mgr.save(2, {"w": torch.zeros(1)}, topologies=topo)
    _, _, topos, _ = mgr.restore()
    assert set(topos) == {"layer0", "layer1"}
    for name, arrays in topo.items():
        for k, v in arrays.items():
            assert topos[name][k].dtype == np.int32
            np.testing.assert_array_equal(topos[name][k], np.asarray(v))


def test_keep_last_gc_ordering(tmp_path):
    """GC removes the OLDEST steps only, after a successful write."""
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    t = {"w": torch.zeros(2)}
    for s in (1, 5, 3, 9):  # out-of-order saves still GC by step number
        mgr.save(s, t)
    assert mgr.all_steps() == [5, 9]
    assert mgr.latest_step() == 9
    _, _, _, m = mgr.restore(step=5, like=t)
    assert m["step"] == 5


def test_async_write_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    t = _tree(3)
    mgr.save(1, t)
    mgr.wait()
    assert mgr.all_steps() == [1]
    params, _, _, _ = mgr.restore(like=_like(t))
    _assert_tree_equal(params, t)


def test_async_error_propagates_via_wait(tmp_path, monkeypatch):
    """A failure on the writer thread surfaces at the next wait(), then
    clears."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)

    def boom(*a, **k):
        raise OSError("disk on fire")

    monkeypatch.setattr(manager_mod.np, "save", boom)
    mgr.save(1, {"w": torch.zeros(1)})
    with pytest.raises(OSError, match="disk on fire"):
        mgr.wait()
    monkeypatch.undo()
    mgr.wait()  # the error is consumed: the manager is usable again
    mgr.save(2, {"w": torch.ones(1)})
    mgr.wait()
    assert 2 in mgr.all_steps()


def test_save_waits_for_previous_write(tmp_path, monkeypatch):
    """save() joins the in-flight writer first, so a slow async write never
    races the next snapshot."""
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    gate = threading.Event()
    real_save = manager_mod.np.save

    def slow_save(path, arr):
        gate.wait(timeout=5)
        return real_save(path, arr)

    monkeypatch.setattr(manager_mod.np, "save", slow_save)
    mgr.save(1, {"w": torch.zeros(1)})
    assert mgr._thread.is_alive()
    gate.set()
    monkeypatch.undo()
    mgr.save(2, {"w": torch.ones(1)})  # implicit wait() on step 1
    mgr.wait()
    assert mgr.all_steps() == [1, 2]


def test_read_manifest_without_arrays(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(4, {"w": torch.zeros(3)}, meta={"serve_kind": "mlp"})
    m = mgr.read_manifest()
    assert m["step"] == 4 and m["meta"]["serve_kind"] == "mlp"
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).read_manifest()


# ---------------------------------------------------------------------------
# the checkpoint tests of tests/test_distributed_substrate.py
# ---------------------------------------------------------------------------


def _substrate_tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    t = _substrate_tree()
    mgr.save(7, t, topologies={"l0": {"rows": np.array([1, 2])}}, meta={"k": 1})
    params, _, topos, manifest = mgr.restore(like=t)
    np.testing.assert_array_equal(params["a"], t["a"].numpy())
    assert params["nested"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(topos["l0"]["rows"], [1, 2])
    assert manifest["step"] == 7 and manifest["meta"]["k"] == 1


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _substrate_tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_write_and_wait(tmp_path):
    """The snapshot is taken when save() is called: updating the tensor in
    place while the writer runs leaves the saved copy as it was."""
    mgr = CheckpointManager(str(tmp_path), keep_last=3, async_write=True)
    mgr.save(1, _substrate_tree())
    mgr.wait()
    assert mgr.latest_step() == 1
    t = _substrate_tree()
    mgr.save(2, t)
    t["a"].add_(100.0)
    t["nested"]["b"].zero_()
    mgr.wait()
    params, _, _, _ = mgr.restore(step=2, like=t)
    np.testing.assert_array_equal(params["a"], np.arange(12.0).reshape(3, 4))
    assert torch.equal(params["nested"]["b"], torch.ones((5,), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# integrity: the checkpoint tests of tests/test_resilience.py
# ---------------------------------------------------------------------------


def _rtree():
    return {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones((8,))}


@pytest.mark.parametrize("mode", ["truncate_leaf", "flip_bytes", "delete_manifest"])
def test_corruption_detected_quarantined_and_skipped(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path), keep_last=5, async_write=False)
    t = _rtree()
    mgr.save(1, t, meta={"ok": True})
    mgr.save(2, t, meta={"ok": True})
    assert fi.corrupt(mode, tmp_path, 2)
    assert mgr.verify_step(2) is not None
    assert mgr.verify_step(1) is None
    # the backward scan falls back past it and quarantines the bad dir
    assert mgr.latest_valid_step() == 1
    assert not (tmp_path / "step_000000002").exists()
    qdir = tmp_path / "quarantine" / "step_000000002"
    assert qdir.is_dir()
    assert (qdir / "QUARANTINE_REASON.txt").read_text().strip()
    params, _, _, manifest = mgr.restore(step=1, like=t)
    np.testing.assert_array_equal(params["w"], t["w"].numpy())
    assert manifest["step"] == 1


@pytest.mark.parametrize("mode", ["truncate_leaf", "flip_bytes", "delete_manifest"])
def test_corrupt_restore_raises_named_error(tmp_path, mode):
    """Restoring a damaged checkpoint raises CheckpointCorruptError naming
    the step dir, not a numpy or OS error."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _rtree()
    mgr.save(3, t)
    fi.corrupt(mode, tmp_path, 3)
    with pytest.raises(CheckpointCorruptError) as ei:
        mgr.restore(step=3, like=t)
    assert "step_000000003" in str(ei.value)


def test_unverified_restore_names_the_bad_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _rtree()
    mgr.save(3, t)
    fi.truncate_leaf(tmp_path, 3, leaf="arrays/w.npy", keep_frac=0.3)
    with pytest.raises(CheckpointCorruptError) as ei:
        mgr.restore(step=3, like=t, verify=False)
    assert ei.value.leaf == "arrays/w.npy"


def test_orphaned_tmp_dir_swept_on_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, _rtree())
    tmp_name = fi.orphan_tmp(tmp_path, 2)
    assert (tmp_path / tmp_name).exists()
    mgr2 = CheckpointManager(str(tmp_path), async_write=False)
    assert not (tmp_path / tmp_name).exists()
    assert mgr2.latest_valid_step() == 1  # published state untouched


# ---------------------------------------------------------------------------
# the streamed save (tests/test_xl.py's spec, without XL)
# ---------------------------------------------------------------------------


def _chunks(a, n):
    return iter([a[s : s + n] for s in range(0, a.shape[0], n)])


def test_streamed_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    values = rng.standard_normal(10).astype(np.float32)
    rows = torch.arange(10, dtype=torch.int32)  # tensors stream too
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_streamed(7, {
        "xl_layer1": {"values": ((10,), np.float32, _chunks(values, 4))},
        "xl_layer0": {"values": ((10,), np.float32, _chunks(values * 2, 3)),
                      "rows": ((10,), np.int32, _chunks(rows, 6))},
    }, meta={"kind": "xl_model"})
    manifest = mgr.read_manifest(7)
    assert manifest["meta"]["kind"] == "xl_model"
    assert manifest["streamed_groups"] == ["xl_layer0", "xl_layer1"]
    assert manifest["shapes"]["xl_layer0__rows"] == [[10], "int32"]
    assert mgr.verify_step(7) is None
    np.testing.assert_array_equal(mgr.restore_stream(7, "xl_layer1", "values"), values)
    np.testing.assert_array_equal(mgr.restore_stream(None, "xl_layer0", "values"), values * 2)
    np.testing.assert_array_equal(mgr.restore_stream(7, "xl_layer0", "rows"), rows.numpy())
    # the reference's manager reads it back the same way
    jm = jmanager.CheckpointManager(str(tmp_path), async_write=False)
    assert jm.verify_step(7) is None
    np.testing.assert_array_equal(jm.restore_stream(7, "xl_layer1", "values"), values)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore_stream(7, "xl_layer9", "values")


def test_streamed_checkpoint_chunk_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    bad = {"g": {"leaf": ((10,), np.float32, iter([np.zeros(4, np.float32)]))}}
    with pytest.raises(ValueError, match="covered 4 of 10"):
        mgr.save_streamed(1, bad)


# ---------------------------------------------------------------------------
# restore targets
# ---------------------------------------------------------------------------


def test_restore_onto_a_device_gives_tensors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    t = _tree(4)
    mgr.save(1, t)
    params, _, _, _ = mgr.restore(like=_like(t), device="cpu")
    assert all(isinstance(a, torch.Tensor) for a in tree_leaves(params))
    _assert_tree_equal(params, t)


def test_restore_onto_shardings_of_a_two_rank_mesh(tmp_path):
    """``restore(shardings=)`` on a 2 x 1 gloo mesh (spawned ranks): every
    leaf of the SMOKE Qwen1.5 comes back a DTensor whose local shard is the
    rank's slice of the saved leaf, on both ranks."""
    import torch_dist_workers as workers

    res = workers.spawn(workers.restore_onto_mesh, 2, str(tmp_path))
    assert res["ok"] == [1, 1] and res["step"] == 3
    assert 0 < res["sharded_leaves"] < res["n_leaves"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _trees_both(seed, bf16: bool):
    """One tree in both packages' types, with a NamedTuple, a list, an int
    leaf and (with ``bf16``) bfloat16 leaves."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    vel = rng.standard_normal(6).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jt = {"w": jnp.asarray(w, jdt),
          "opt": jsgd.SGDState(velocity={"values": (jnp.asarray(vel),)},
                               step=jnp.asarray(9, jnp.int32)),
          "stack": [jnp.asarray(b, jdt)]}
    tt = {"w": torch.from_numpy(w).to(tdt),
          "opt": tsgd.SGDState(velocity={"values": (torch.from_numpy(vel),)},
                               step=torch.tensor(9, dtype=torch.int32)),
          "stack": [torch.from_numpy(b).to(tdt)]}
    topos = {"layer0": {"rows": np.array([3, 1, 2], np.int32), "cols": np.array([0, 0, 1], np.int32)}}
    return jt, tt, topos


def _bits(a) -> np.ndarray:
    """A leaf's raw bytes as unsigned integers, whichever package made it."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer, bf16):
    """A checkpoint written by one package is verified and read by the
    other: the same leaf names, bit-equal leaves (bf16 too), topologies and
    meta; and the two packages write byte-identical files for the same
    tree."""
    jt, tt, topos = _trees_both(5, bf16)
    meta = {"kind": "sequential", "resume": {"numpy_rng": np.random.default_rng(1)
                                             .bit_generator.state, "history": {"x": [1.5]}}}
    jm = jmanager.CheckpointManager(str(tmp_path / "ref"), async_write=False)
    tm = CheckpointManager(str(tmp_path / "port"), async_write=False)
    jm.save(4, jt, extra={"velocity": jt}, topologies=topos, meta=meta)
    tm.save(4, tt, extra={"velocity": tt}, topologies=topos, meta=meta)
    # the same files, byte for byte, but for the topology archives (zip
    # entries carry a time stamp)
    jfiles, tfiles = jm.read_manifest(4)["files"], tm.read_manifest(4)["files"]
    assert jfiles.keys() == tfiles.keys()
    for rel in jfiles:
        if not rel.startswith("topology/"):
            assert jfiles[rel] == tfiles[rel], rel
    assert jm.read_manifest(4)["shapes"] == tm.read_manifest(4)["shapes"]

    src = tmp_path / ("ref" if writer == "reference" else "port")
    if writer == "reference":  # the port reads it
        reader = CheckpointManager(str(src), async_write=False)
        params, extra, got_topos, manifest = reader.restore(4, like=tt,
                                                            like_extra={"velocity": tt})
        names = [n for n, _ in tree_flatten_with_names(params)[0]]
        got, got_v = tree_leaves(params), tree_leaves(extra["velocity"])
    else:  # the reference reads it
        reader = jmanager.CheckpointManager(str(src), async_write=False)
        params, extra, got_topos, manifest = reader.restore(4, like=jt,
                                                            like_extra={"velocity": jt})
        names = _jax_names(params)
        got, got_v = jax.tree.leaves(params), jax.tree.leaves(extra["velocity"])
    assert reader.verify_step(4) is None
    assert names == _jax_names(jt) == [n for n, _ in tree_flatten_with_names(tt)[0]]
    for g, w in zip(got + got_v, tree_leaves(tt) * 2):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    for k, v in topos["layer0"].items():
        np.testing.assert_array_equal(got_topos["layer0"][k], v)
    assert manifest["meta"] == meta

