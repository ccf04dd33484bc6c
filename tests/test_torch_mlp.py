"""The port's SET-MLP against the JAX reference on the CPU: seeded init,
configs, data, the whole-model inference forward (rtol 1e-5 / atol 1e-5),
the device rule, and the import isolation of the port.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.configs import set_mlp as jcfg
from repro.data import datasets as jdata
from repro.models import mlp as jmlp
from repro_torch.configs import set_mlp as tcfg
from repro_torch.data import datasets as tdata
from repro_torch.interop import mlp_from_numpy
from repro_torch.models import mlp as tmlp
from repro_torch.serve import SparseInferenceEngine

jax.config.update("jax_platform_name", "cpu")

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
SMOKE = dict(layer_dims=(64, 32, 16, 4), epsilon=8)  # set_mlp.SPEC.smoke


def _port_of(jm: jmlp.SparseMLP, biases=None) -> tmlp.SparseMLP:
    return mlp_from_numpy(
        dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
        [np.asarray(v) for v in jm.values],
        biases if biases is not None else [np.asarray(b) for b in jm.biases],
        device="cpu",
    )


def _with_biases(jm: jmlp.SparseMLP, seed: int):
    """Nonzero biases, so the bias add and All-ReLU's negative side count."""
    rng = np.random.default_rng(seed)
    biases = [rng.standard_normal(b.shape).astype(np.float32) for b in jm.biases]
    jm.biases = [jnp.asarray(b) for b in biases]
    return biases


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("fields", [SMOKE, dict(layer_dims=(32, 24, 20, 6), epsilon=6,
                                                 init="normal")])
def test_seeded_init_bit_equal(seed, fields):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=seed)
    tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**fields), seed=seed, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    for l in range(jm.config.n_layers):
        np.testing.assert_array_equal(tm.topos[l].rows, jm.topos[l].rows)
        np.testing.assert_array_equal(tm.topos[l].cols, jm.topos[l].cols)
        np.testing.assert_array_equal(tm.values[l].numpy(), np.asarray(jm.values[l]))
        np.testing.assert_array_equal(tm.biases[l].numpy(), np.asarray(jm.biases[l]))
    assert tm.n_params == jm.n_params
    assert set(tm.params()) == {"values", "biases"}
    for tt, jt in zip(tm.topo_arrays(), jm.topo_arrays()):
        for a, b in zip(tt, jt):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_configs_match_reference():
    for name in jdata.PAPER_DATASETS:
        assert dataclasses.asdict(tcfg.mlp_config(name)) == dataclasses.asdict(jcfg.mlp_config(name))
    assert (dataclasses.asdict(tcfg.extreme_config(4096, 3, 10))
            == dataclasses.asdict(jcfg.extreme_config(4096, 3, 10)))
    assert tcfg.mlp_config("cifar10").layer_dims == (3072, 4000, 1000, 4000, 10)


@pytest.mark.parametrize("name", ["madelon", "higgs", "cifar10"])
def test_datasets_bit_equal(name):
    a, b = jdata.load(name, scale=0.002), tdata.load(name, scale=0.002)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.n_classes == b.n_classes and a.name == b.name


# the smoke config, other activations (a bias-only epilogue, then the
# activation in the (features, batch) layout), batch 1 and 33, and a
# 400-wide hidden layer whose 80,000 connections send the reference down its
# chunked segment path at batch 8
@pytest.mark.parametrize("fields,batch", [
    (SMOKE, 5),
    (SMOKE, 33),
    (dict(SMOKE, alpha=0.75), 1),
    (dict(SMOKE, activation="relu"), 3),
    (dict(SMOKE, activation="gelu"), 3),
    (dict(SMOKE, activation="leaky_relu"), 33),
    (dict(SMOKE, activation="silu"), 1),
    (dict(layer_dims=(48, 400, 400, 10), epsilon=100), 8),
])
def test_forward_matches_reference(fields, batch):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**fields), seed=1)
    biases = _with_biases(jm, 2)
    x = np.random.default_rng(3).standard_normal((batch, fields["layer_dims"][0])).astype(np.float32)
    want = jmlp.mlp_forward(jm.params(), jm.topo_arrays(), jnp.asarray(x), jm.config, infer=True)
    tm = _port_of(jm, biases)
    got = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x), tm.config, infer=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # leading dims
    got3 = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.as_tensor(x)[None],
                            tm.config, infer=True)
    np.testing.assert_array_equal(got3[0].numpy(), got.numpy())


def test_unported_paths_raise():
    tm = tmlp.SparseMLP(tmlp.SparseMLPConfig(**SMOKE), seed=0, device="cpu")
    x = torch.zeros((2, 64))
    with pytest.raises(NotImplementedError):
        tmlp.mlp_forward(tm.params(), tm.topo_arrays(), x, tm.config, infer=True,
                         return_preacts=True)
    # the element training forward and element dropout are ported: they run,
    # and dropout asks for its generator
    for kwargs in (dict(), dict(infer=True, train=True, rng=torch.Generator()),
                   dict(train=True, rng=torch.Generator())):
        out = tmlp.mlp_forward(tm.params(), tm.topo_arrays(), x, tm.config, **kwargs)
        assert out.shape == (2, 4) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="rng"):
        tmlp.mlp_forward(tm.params(), tm.topo_arrays(), x, tm.config, train=True)
    with pytest.raises(ValueError, match="features"):
        tmlp.mlp_forward(tm.params(), tm.topo_arrays(), torch.zeros((2, 63)), tm.config, infer=True)
    # the masked and dense baselines are ported (tests/test_torch_mlp_training.py
    # holds them against the reference); an unknown impl is refused
    for impl in ("masked", "dense"):
        m = tmlp.SparseMLP(tmlp.SparseMLPConfig(**SMOKE, impl=impl), device="cpu")
        out = tmlp.mlp_forward(m.params(), m.topo_arrays(), x, m.config, infer=True)
        assert out.shape == (2, 4) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="impls"):
        tmlp.SparseMLP(tmlp.SparseMLPConfig(**SMOKE, impl="sparse"), device="cpu")
    # the engine serves a block model as it is; compaction is for element models
    block = tmlp.SparseMLP(tmlp.SparseMLPConfig(**SMOKE, impl="block", block_m=8, block_n=8),
                           device="cpu")
    with pytest.raises(ValueError, match="element"):
        SparseInferenceEngine(block, device="cpu")
    assert SparseInferenceEngine(block, compact=False, device="cpu").classify(
        np.zeros((2, 64), np.float32)).shape == (2, 4)
    with pytest.raises(ValueError, match="layers"):
        tmlp.SparseMLP.from_state(tm.config, tm.topos[:2], tm.values, tm.biases, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmlp.SparseMLPConfig(**SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.SparseMLP(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmlp.SparseMLP(cfg, device="cuda")
    model = tmlp.SparseMLP(cfg, device="cpu")
    assert model.device == CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseInferenceEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp_from_numpy(dataclasses.asdict(cfg), [(t.rows, t.cols) for t in model.topos],
                       [v.numpy() for v in model.values], [b.numpy() for b in model.biases])


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15  # every module of the port was imported
