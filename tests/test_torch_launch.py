"""The pod machinery of the port (``repro_torch.launch``: ``mesh``,
``sharding``, ``axes``, ``specs``, ``analytic``, ``hlo_analysis``,
``dryrun``) against the reference's, on the CPU. Twins of
``tests/test_launch.py``'s rules, input-spec, HLO-analysis and sharded-step
tests, and of ``tests/test_wasap.py``'s two-device shard_map test.

Meshes of several ranks run on ``gloo`` in spawned processes
(``tests/torch_dist_workers.py``), never in the test process; the rules
tests build a (2, 2) mesh over a fake process group of 4 ranks, which
touches no device, and tear it down. The 16 x 16 shardings are held to the
reference's in one subprocess that runs both: the reference over 256
forced host devices, the port over a fake group of 256 ranks.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import analytic as janalytic  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo as j_analyze_hlo  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import analytic as tanalytic  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_hlo, analyze_module  # noqa: E402
from repro_torch.launch.sharding import (  # noqa: E402
    default_rules,
    is_spec_leaf,
    shape_aware_shardings,
)
from repro_torch.tree import tree_flatten, tree_flatten_with_names  # noqa: E402

import torch_dist_workers as workers  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


@pytest.fixture(scope="module")
def mesh():
    """A (data=2, model=2) mesh over a fake process group of 4 ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield make_debug_mesh(2, 2, device="cpu")
    dist.destroy_process_group()


def _jbuild(spec):
    """The reference dry run's abstract model (its module sets XLA_FLAGS
    at import, which this process must not pass on)."""
    flags = os.environ.get("XLA_FLAGS")
    jax.devices()  # the backend starts with this process's flags
    from repro.launch.dryrun import build_model

    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return build_model(spec, abstract=True)


def _tbuild(spec):
    from repro_torch.launch.dryrun import build_model

    return build_model(spec, abstract=True)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def test_rules_no_double_axis(mesh):
    rules = default_rules(mesh, batch_size=4)
    # two dims that both want 'model': the second is dropped
    spec = rules.pspec(("mlp", "vocab"))
    axes = [a for a in spec if a is not None]
    assert len(axes) == len(set(axes)) and spec == ("model", None)


def test_shape_aware_drops_nondivisible(mesh):
    rules = default_rules(mesh, batch_size=4)
    sh = shape_aware_shardings(rules, {"w": ("vocab", "embed")},
                               {"w": torch.empty((7, 8), device="meta")})
    assert sh["w"].spec[0] is None  # 7 is not divisible by the model axis
    assert sh["w"].spec == (None, "data") and sh["w"].local_shape((7, 8)) == (7, 4)
    from torch.distributed.tensor import Replicate, Shard

    assert sh["w"].placements == (Shard(1), Replicate())


def test_layout_shard_copies_only_what_it_splits(mesh):
    """A rank's shard of a split dim is a copy that owns its bytes; a
    replicated layout moves nothing and gives the full tensor itself."""
    from repro_torch.launch.sharding import Layout

    full = torch.arange(32.0).reshape(4, 8)
    assert Layout(mesh, (None, None)).shard(full) is full
    assert Layout(mesh, ()).shard(full) is full
    local = Layout(mesh, ("data", "model")).shard(full)  # rank 0 of the (2, 2) mesh
    assert torch.equal(local, full[:2, :4]) and local.data_ptr() != full.data_ptr()
    assert local.is_contiguous() and local.untyped_storage().nbytes() == local.nbytes


def test_batch_rule_replicates_tiny_batch(mesh):
    rules = default_rules(mesh, batch_size=1)  # long_500k style
    assert rules.pspec(("batch",)) == (None,)
    rules = default_rules(mesh, batch_size=4)
    assert rules.pspec(("batch",))[0] == "data"


def test_rules_and_pspecs_match_the_reference(mesh):
    """Every rule of ``default_rules`` and the pspec of every logical name,
    for both ways of the batch and the MoE expert rule, are the
    reference's (its rules read only the mesh's axis names and sizes)."""
    from types import SimpleNamespace

    from repro.launch.sharding import default_rules as j_rules

    jmesh = SimpleNamespace(axis_names=("data", "model"),
                            devices=SimpleNamespace(shape=(2, 2)))
    for kw in (dict(batch_size=4), dict(batch_size=1), dict(n_experts=8, batch_size=4),
               dict(n_experts=3), dict(fsdp=False)):
        want, got = j_rules(jmesh, **kw), default_rules(mesh, **kw)
        assert got.rules == want.rules, kw
        for name in want.rules:
            assert got.pspec((name, "vocab")) == tuple(want.pspec((name, "vocab"))), (kw, name)


def test_hint_redistributes_only_dtensors(mesh):
    from repro_torch.launch.axes import current_rules, hint, logical_axis_rules

    x = torch.ones(4, 4)
    rules = default_rules(mesh, batch_size=4)
    with logical_axis_rules(rules):
        assert current_rules() is rules
        assert hint(x, "batch", "mlp") is x  # a plain tensor is left as it is
    assert current_rules() is None


# ---------------------------------------------------------------------------
# model specs, input specs and the analytic flops of every cell
# ---------------------------------------------------------------------------


def _spec_leaves(tree):
    return tree_flatten(tree, is_leaf=is_spec_leaf)[0]


def test_input_specs_and_model_flops_cover_all_cells():
    """For every runnable cell of every arch: ``input_specs``' inputs have
    the reference's shapes and dtypes (token ids int64, the reference's
    int32), its logical specs are the reference's, the model's specs and
    parameter shapes are the reference's, and ``model_flops`` is the
    reference's number exactly."""
    for arch in jconfigs.list_archs():
        jspec, tspec = jconfigs.get_spec(arch), tconfigs.get_spec(arch)
        jm, tm = _jbuild(jspec), _tbuild(tspec)
        assert _spec_leaves(tm.specs) == jax.tree.leaves(
            jm.specs, is_leaf=lambda x: isinstance(x, tuple) or x is None), arch
        assert all(t.device.type == "meta" for t in tree_flatten(tm.params)[0])
        assert [tuple(a.shape) for a in tree_flatten(tm.params)[0]] == [
            tuple(a.shape) for a in jax.tree.leaves(jm.params)], arch
        for shape_id, ok in jspec.shapes.items():
            assert tspec.shapes[shape_id] == ok
            if ok is not True:
                continue
            jin, jlog = jspecs.input_specs(jspec, shape_id, jm)
            tin, tlog = tspecs.input_specs(tspec, shape_id, tm)
            ja = jax.tree.leaves(jin)
            ta = tree_flatten_with_names(tin)[0]
            assert [tuple(a.shape) for _, a in ta] == [tuple(a.shape) for a in ja], (arch,
                                                                                  shape_id)
            for (name, a), b in zip(ta, ja):
                want = "int64" if name in ("tokens", "labels", "position") else str(b.dtype)
                assert a.device.type == "meta" and str(a.dtype).split(".")[-1] == want, name
            assert _spec_leaves(tlog) == jax.tree.leaves(
                jlog, is_leaf=lambda x: isinstance(x, tuple) or x is None), (arch, shape_id)
            assert tanalytic.model_flops(tspec, shape_id) == janalytic.model_flops(
                jspec, shape_id), (arch, shape_id)
        if hasattr(tspec.config, "pattern"):
            assert tanalytic.param_counts(tspec.config) == janalytic.param_counts(jspec.config)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


def _torch_loop(a):
    x = a
    for _ in range(5):
        x = x @ x
    return x


def test_hlo_analysis_multiplies_while_trip_counts():
    """The reference's analysis of the compiled HLO of a 5-trip
    ``fori_loop`` of 8 x 8 dots and the port's of the torch loop: one 8 x 8
    x 8 dot an iteration, 5 iterations, in both."""
    txt = jax.jit(lambda a: jax.lax.fori_loop(0, 5, lambda i, x: x @ x, a)).lower(
        jnp.ones((8, 8), jnp.float32)).compile().as_text()
    want = j_analyze_hlo(txt)["flops"]
    got = analyze_hlo(_torch_loop, torch.ones(8, 8))
    assert want == got["flops"] == 5 * 2 * 8 * 8 * 8
    assert got["collective_bytes"] == 0.0 and got["hbm_bytes"] == 5 * 3 * 8 * 8 * 4


def test_hlo_trip_count_parse():
    """The eager record holds every iteration: 5 ``mm`` ops, each counted
    once (the reference's trip count times its body's count)."""
    from repro_torch.analysis.jaxpr_audit import record_call

    _, record = record_call(_torch_loop, (torch.ones(8, 8),))
    assert [op.name for op in record.ops] == ["aten.mm"] * 5
    assert analyze_module(record)["flops"] == 5 * 1024


def test_cost_model_counts_matmul_einsum_and_collectives():
    """Under ``inference_mode`` a matmul or einsum dispatches whole; the
    flops are 2 x lhs x rhs free dims all the same. A fake tensor takes the
    same count, and a fake kernel wrapper call takes the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    @torch.inference_mode()
    def f(a, b, c):
        return torch.einsum("bqd,bkd->bqk", a, c), a @ b

    want = 2 * 2 * 8 * 16 * 4 + 2 * 2 * 8 * 16 * 32
    assert analyze_hlo(f, torch.randn(2, 8, 16), torch.randn(16, 32),
                       torch.randn(2, 4, 16))["flops"] == want
    from repro_torch.kernels.all_relu_fused import bias_all_relu

    before = bias_all_relu.launches
    with FakeTensorMode():
        assert analyze_hlo(f, torch.empty(2, 8, 16), torch.empty(16, 32),
                           torch.empty(2, 4, 16))["flops"] == want
        y = bias_all_relu(torch.empty(4, 8), torch.empty(8), alpha=0.6, layer_index=1)
        assert y.shape == (4, 8) and y.device.type == "cpu"
    assert bias_all_relu.launches == before


def _wrappers():
    from repro_torch.core import sparsity
    from repro_torch.kernels import all_relu_fused, ops
    from repro_torch.kernels import block_sparse_matmul as bsm

    return (sparsity.coo_matmul_T, sparsity.coo_dw, all_relu_fused.bias_all_relu,
            all_relu_fused.all_relu_bwd, bsm.bsmm_fwd, bsm.bsmm_dx, bsm.bsmm_dw,
            ops.xl_shard_acc, ops.xl_shard_dw)


@pytest.mark.parametrize("kind", ["meta", "fake"])
def test_meta_and_fake_tensors_take_the_wrappers_plain_versions(kind):
    """A ``meta`` tensor and a fake one (``FakeTensorMode``, the dry run's)
    take a kernel wrapper's plain version, whatever device a fake one
    names, and launch nothing: the sparse FFN's forward and backward
    (kernels C, and D and E under autograd), kernel A with B's epilogue and
    the mask, kernel F with G's epilogue, and kernel B alone give the CPU
    run's shapes and dtypes, and no wrapper's launch count moves."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import sparsity
    from repro_torch.device import takes_plain
    from repro_torch.kernels.all_relu_fused import bias_all_relu
    from repro_torch.models import layers as L

    cpu = torch.device("cpu")
    sc = L.SparseFFNConfig(block_m=16, block_n=16, density=0.5)
    params, (t_in, t_out), metas = L.init_sparse_ffn(np.random.default_rng(5), 64, 48, sc,
                                                     torch.float32, cpu)
    a_in, a_out = t_in.device_arrays(cpu), t_out.device_arrays(cpu)
    rng = np.random.default_rng(0)
    nnz, n_in, n_out, batch = 40, 12, 10, 6
    rows = torch.as_tensor(np.sort(rng.integers(0, n_in, nnz)).astype(np.int32))
    cols = torch.as_tensor(np.sort(rng.integers(0, n_out, nnz)).astype(np.int32))
    coo = (torch.randn(n_in, batch), torch.randn(nnz), rows, cols, torch.randn(n_out, batch),
           torch.randn(n_out))

    def run(to, ctx):
        with ctx:
            p = {k: to(v).detach().requires_grad_() for k, v in params.items()}
            ti, to_ = type(a_in)(*map(to, a_in)), type(a_out)(*map(to, a_out))
            x = to(torch.randn(3, 5, 64)).requires_grad_()
            y = L.sparse_ffn_fwd(p, ti, to_, metas, x, sc, 1)
            y.sum().backward()
            xT, vals, r, c, dyT, bias = map(to, coo)
            a, mask = sparsity.coo_matmul_T(xT, vals, r, c, n_out, bias=bias, slope=0.5,
                                            with_mask=True)
            f = sparsity.coo_dw(xT, dyT, r, c, with_dbias=True, mask=mask, slope=0.5)
            b = bias_all_relu(to(torch.randn(4, 8)), to(torch.randn(8)), alpha=0.6,
                              layer_index=1)
            outs = (y, x.grad, p["win"].grad, p["wout"].grad, a, mask, *f, b)
            return [(tuple(t.shape), t.dtype, takes_plain(t)) for t in outs]

    want = run(lambda t: t, contextlib.nullcontext())
    before = [w.launches for w in _wrappers()]
    if kind == "meta":
        got = run(lambda t: t.to("meta"), contextlib.nullcontext())
    else:
        mode = FakeTensorMode()
        got = run(mode.from_tensor, mode)
        with mode:  # a fake tensor that names the card takes the plain version too
            assert takes_plain(torch.empty(2, device="cuda"))
    assert got == want
    assert [w.launches for w in _wrappers()] == before


# ---------------------------------------------------------------------------
# the 16 x 16 shardings of every arch, both packages in one subprocess
# ---------------------------------------------------------------------------

_PARITY = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    import jax, jax.numpy as jnp
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro import configs as jc
    from repro.launch import specs as jspecs
    from repro.launch.dryrun import build_model as jbuild
    from repro.launch.sharding import default_rules as jrules, shape_aware_shardings as jsas
    from repro_torch import configs as tc
    from repro_torch.launch import specs as tspecs
    from repro_torch.launch.dryrun import build_model as tbuild
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import default_rules as trules, shape_aware_shardings as tsas
    from repro_torch.tree import tree_flatten

    assert jax.device_count() == 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    jmesh = jax.make_mesh((16, 16), ("data", "model"))
    tmesh = make_production_mesh(device="cpu")
    n_leaves = 0
    for arch in jc.list_archs():
        js, ts = jc.get_spec(arch), tc.get_spec(arch)
        jm, tm = jbuild(js), tbuild(ts)
        ne = getattr(js.config, "n_experts", 0)
        cells = [(None, jm.specs, jm.params, tm.specs, tm.params)]
        for shape_id, ok in js.shapes.items():
            if ok is True:
                ji, jl = jspecs.input_specs(js, shape_id, jm)
                ti, tl = tspecs.input_specs(ts, shape_id, tm)
                cells.append((shape_id, jl, ji, tl, ti))
        for shape_id, jl, ji, tl, ti in cells:
            B = jc.SHAPES[shape_id]["global_batch"] if shape_id else None
            jsh = jax.tree.leaves(jsas(jrules(jmesh, n_experts=ne, batch_size=B), jl, ji))
            jshapes = jax.tree.leaves(ji)
            tsh = tree_flatten(tsas(trules(tmesh, n_experts=ne, batch_size=B), tl, ti))[0]
            tshapes = tree_flatten(ti)[0]
            assert len(jsh) == len(tsh), (arch, shape_id)
            for a, b, sa, sb in zip(jsh, tsh, jshapes, tshapes):
                assert tuple(a.spec) == tuple(b.spec), (arch, shape_id, a.spec, b.spec)
                assert tuple(a.shard_shape(sa.shape)) == b.local_shape(sb.shape), (
                    arch, shape_id, a.spec)
                n_leaves += 1
    dist.destroy_process_group()
    print("PARITY_OK", n_leaves)
    """
)


def test_shape_aware_shardings_at_16x16_match_the_reference_for_every_arch():
    """Every parameter and every cell's input of every arch: the port's
    shape-aware spec entries on a fake 16 x 16 mesh equal the reference's
    on 256 host devices, and each rank's local shard shape is the
    reference's ``shard_shape`` (so its bytes are a reference shard's)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _PARITY], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PARITY_OK" in res.stdout
    assert int(res.stdout.split("PARITY_OK")[1]) > 400  # 298 parameters and the inputs


# ---------------------------------------------------------------------------
# the sharded step, the driver and WASAP on gloo ranks
# ---------------------------------------------------------------------------


def test_sharded_train_step_on_host_mesh():
    """The sharded train step on a 2 x 1 gloo mesh: a finite loss, the
    embedding table stored as each rank's half of its FSDP axis."""
    res = workers.spawn(workers.sharded_step, 2)
    assert np.isfinite(res["loss"])
    assert res["table"] == [[512, 32], ["S(1)", "S(0)"]]  # embed on data, vocab on model (1)


def test_phase1_vmap_shardmap_equivalence_multidevice():
    """The worker axis really sharded: 4 workers on 2 gloo ranks (a 2-way
    data axis), dropout 0.1, every param, velocity and loss and the
    generator's state bit-equal to ``vmap`` on both ranks."""
    res = workers.spawn(workers.wasap_shard_map, 2, 4, 0.1)
    assert res == {"equal_on_every_rank": [1, 1], "mesh_data": 2}


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------


def test_dryrun_cell_records_the_reference_keys():
    """Two cells of the dry run, cut to 2 layers, as rank 0 of a fake world
    of 256: the record's keys, positive bytes and flops, and the sharded
    step's collectives (the parameters' all-gathers, the gradients'
    all-reduce) counted by ``CommDebugMode``. A decode cell whose caches
    are sharded over the model axis (falcon-mamba's ``inner``) reads them
    gathered and writes them back to its shards: its output bytes are the
    logits and the caches' shards."""
    script = textwrap.dedent(
        """
        import json
        from repro_torch.launch import dryrun
        rec = dryrun.lower_cell("qwen1.5-0.5b", "train_4k", overrides={"n_layers": 2},
                                verbose=False)
        dec = dryrun.lower_cell("falcon-mamba-7b", "decode_32k", overrides={"n_layers": 2},
                                verbose=False)
        print("DEC" + json.dumps(dec))
        print("REC" + json.dumps(rec))
        """)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    rec = json.loads(res.stdout.split("REC", 1)[1])
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                "flops", "collectives", "analytic", "lower_seconds"):
        assert key in rec, key
    assert "compile_seconds" not in rec and "bytes_accessed" not in rec
    assert rec["mesh"] == "16x16" and rec["kind"] == "train"
    assert min(rec["argument_size_in_bytes"], rec["temp_size_in_bytes"], rec["flops"]) > 0
    counts = rec["collectives"]["counts"]
    assert counts.get("all_gather", 0) > 0 and counts.get("all_reduce", 0) == 1
    assert rec["collectives"]["per_chip_bytes"] > 0
    dec = json.loads(res.stdout.split("DEC", 1)[1].split("REC", 1)[0])
    # the logits of 128 / 16 sequences over falcon-mamba's 65,024 words, at
    # least 2 bytes a value, and the caches' shards besides
    logits = 8 * 1 * 65024 * 2
    assert dec["kind"] == "decode" and dec["output_size_in_bytes"] > logits
    assert dec["output_size_in_bytes"] - logits <= dec["argument_size_in_bytes"]
    assert dec["collectives"]["counts"]["all_gather"] > 0 and dec["flops"] > 0
