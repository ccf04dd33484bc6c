"""The port's public names against the reference's, on the CPU.

Every module of the reference that has a twin in the port (the same path
under ``src/repro_torch``) exports through ``__all__`` every name that the
reference's ``__all__`` exports, less the names an open ROADMAP item still
refuses (``NOT_YET``, each with its item; each is held to be still missing,
so that the list shrinks as the items land). The trainer's
``make_step_fn``, ``make_segment_fn`` and ``make_eval_fn`` compute what the
reference's do, at rtol = atol = 1e-5 (f32, the same draws).
"""
import dataclasses
import importlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.models import mlp as jmlp  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.interop import mlp_from_numpy  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
SRC = Path(__file__).resolve().parents[1] / "src"

# names of a reference module's __all__ that the port does not export yet,
# by module, with the ROADMAP Queue 1 item that brings them (none since the
# serving gateway landed)
NOT_YET = {}


def _twins():
    """Dotted names (under both packages) of the reference's modules that
    have a twin file in the port, sorted."""
    names = []
    for path in sorted((SRC / "repro").rglob("*.py")):
        rel = path.relative_to(SRC / "repro")
        if rel.name == "__main__.py" or not (SRC / "repro_torch" / rel).exists():
            continue
        parts = rel.with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


def _pair(name):
    suffix = f".{name}" if name else ""
    # repro.launch.dryrun sets XLA_FLAGS (512 host devices) at its import,
    # for its own process: start the backend first, and keep the flags
    flags = os.environ.get("XLA_FLAGS")
    jax.devices()
    ref = importlib.import_module(f"repro{suffix}")
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return ref, importlib.import_module(f"repro_torch{suffix}")


@pytest.mark.parametrize("name", _twins())
def test_module_exports_cover_the_reference(name):
    ref, port = _pair(name)
    want = getattr(ref, "__all__", None)
    if want is None:  # the reference declares no public names here
        return
    have = set(getattr(port, "__all__", ()))
    missing = sorted(set(want) - have - set(NOT_YET.get(name, {})))
    assert not missing, f"repro_torch.{name} lacks {missing} of the reference's __all__"
    for n in have & set(want):
        assert hasattr(port, n), f"repro_torch.{name}.__all__ names {n}, which it lacks"


def test_names_not_yet_ported_are_still_missing():
    """When an item lands, its names leave NOT_YET."""
    for name in sorted(NOT_YET):
        _still_missing(name)


def _still_missing(name):
    ref, port = _pair(name)
    for n, item in NOT_YET[name].items():
        assert n in ref.__all__, f"the reference's {name} no longer exports {n}"
        assert n not in getattr(port, "__all__", ()), (
            f"repro_torch.{name} exports {n} now: drop it from NOT_YET (item {item})")


FIELDS = dict(layer_dims=(784, 64, 32, 10), epsilon=8, alpha=0.6, block_m=8, block_n=8,
              impl="block", dropout=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed):
    jm = jmlp.SparseMLP(jmlp.SparseMLPConfig(**FIELDS), seed=seed)
    tm = mlp_from_numpy(dataclasses.asdict(jm.config), [(t.rows, t.cols) for t in jm.topos],
                        [np.asarray(v) for v in jm.values], [np.asarray(b) for b in jm.biases],
                        device="cpu")
    return jm, tm


def _opts():
    return (jsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4),
            tsgd.MomentumSGD(momentum=0.9, weight_decay=2e-4))


def _same_params(tp, jp):
    for k in ("values", "biases"):
        for a, b in zip(tp[k], jp[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_make_step_fn_matches_reference():
    jm, tm = _models(seed=6)
    jopt, topt = _opts()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 784)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    jp, js, jl = jtrainer.make_step_fn(jm.config, jopt)(
        jm.params(), jopt.init(jm.params()), jm.topo_arrays(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(0.05, jnp.float32), jax.random.PRNGKey(0))
    tp, ts, tl = ttrainer.make_step_fn(tm.config, topt)(
        tm.params(), topt.init(tm.params()), tm.topo_arrays(), torch.as_tensor(x),
        torch.as_tensor(y).long(), torch.tensor(0.05), None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _same_params(tp, jp)
    assert int(ts.step) == int(js.step) == 1


def test_make_segment_fn_matches_reference():
    """Three steps over a permutation of 48 samples; cached per (config,
    optimizer) as the reference's."""
    jm, tm = _models(seed=8)
    jopt, topt = _opts()
    rng = np.random.default_rng(9)
    x = rng.standard_normal((48, 784)).astype(np.float32)
    y = rng.integers(0, 10, 48).astype(np.int32)
    perm = rng.permutation(48).reshape(3, 16).astype(np.int32)
    lrs = np.array([0.05, 0.04, 0.03], np.float32)
    tseg = ttrainer.make_segment_fn(tm.config, topt)
    assert tseg is ttrainer.make_segment_fn(tm.config, topt)
    jp, js, _, jl = jtrainer.make_segment_fn(jm.config, jopt)(
        jm.params(), jopt.init(jm.params()), jm.topo_arrays(), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(perm), jnp.asarray(lrs), jax.random.PRNGKey(0))
    gen = torch.Generator()
    tp, ts, key, tl = tseg(tm.params(), topt.init(tm.params()), tm.topo_arrays(),
                           torch.as_tensor(x), torch.as_tensor(y).long(),
                           torch.as_tensor(perm).long(), torch.as_tensor(lrs), gen)
    assert key is gen
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _same_params(tp, jp)
    assert int(ts.step) == int(js.step) == 3
    # the probed segment: the same steps, bit for bit, and the probe's stats
    gen = torch.Generator()
    pp, ps, _, pl, stats = ttrainer.make_segment_fn(tm.config, topt, True)(
        tm.params(), topt.init(tm.params()), tm.topo_arrays(), torch.as_tensor(x),
        torch.as_tensor(y).long(), torch.as_tensor(perm).long(), torch.as_tensor(lrs), gen)
    assert torch.equal(pl, tl) and all(torch.equal(a, b) for a, b in zip(pp["values"],
                                                                          tp["values"]))
    assert stats["value_l2"].shape == (tm.config.n_layers,)


def test_make_eval_fn_matches_reference():
    jm, tm = _models(seed=10)
    x = np.random.default_rng(11).standard_normal((37, 784)).astype(np.float32)
    fwd = ttrainer.make_eval_fn(tm.config)
    assert fwd is ttrainer.make_eval_fn(tm.config)
    got = fwd(tm.params(), tm.topo_arrays(), torch.as_tensor(x))
    assert not got.requires_grad
    want = jtrainer.make_eval_fn(jm.config)(jm.params(), jm.topo_arrays(), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_no_refusal_names_the_obs_or_whisper_items():
    """Whisper (ROADMAP Queue 1, item 7b) and the observability layer (item
    4) are ported whole: no string of the port's package or its examples
    names either item any more."""
    import re

    pattern = re.compile(r"item 4(?![0-9])|item 7b|items? [0-9, ]*\b4\b")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + sorted(
        (SRC.parent / "examples").glob("*_torch.py"))
    hits = [f"{path.relative_to(SRC.parent)}:{i}: {line.strip()}"
            for path in files for i, line in enumerate(path.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, "\n".join(hits)


def test_no_refusal_names_the_runtime_or_gateway_items():
    """The runtime and the elastic driver (ROADMAP Queue 1, item 5) and the
    serving gateway (item 6) are ported whole: no string of the port's
    package or its examples names either item, and their modules are
    twins (held by ``test_module_exports_cover_the_reference``)."""
    import re

    pattern = re.compile(r"item [56](?![0-9])")
    files = sorted((SRC / "repro_torch").rglob("*.py")) + sorted(
        (SRC.parent / "examples").glob("*_torch.py"))
    hits = [f"{path.relative_to(SRC.parent)}:{i}: {line.strip()}"
            for path in files for i, line in enumerate(path.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, "\n".join(hits)
    twins = set(_twins())
    assert {"runtime.donation", "runtime.faultinject", "runtime.supervisor", "launch.train",
            "serve.metrics", "serve.gateway"} <= twins
    assert not NOT_YET
