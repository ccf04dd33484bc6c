"""The contract auditor's twin (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU: a twin of each test of
``tests/test_analysis.py`` and of ``tests/test_probes.py``'s five lint
tests.

As the reference's, the load-bearing tests are the MUTATION tests: each
reintroduces, in torch idiom, a performance bug the port has engineered
out — a scatter formulation in the backward, a host sync inside a device
program, a dense intermediate, f64 drift, a dropped donation, an
allocation over its ceiling, host-hostile source idioms — and asserts the
audit fails naming the reference's check id and waiver id, while the
designed formulation (the positive control) passes. Where both packages
can run the same seeded case, the twin also compares the two audits'
``(program, check)`` sets; each lint twin runs the reference's lint on the
reference test's source and compares the rules found.
"""
import dataclasses
import os
import textwrap
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's machine has none
import jax.numpy as jnp  # noqa: E402

from repro.analysis import jaxpr_audit as j_jaxpr_audit  # noqa: E402
from repro.analysis import lint as j_lint  # noqa: E402
from repro.analysis import registry as j_registry  # noqa: E402
from repro.analysis import waivers as j_waivers  # noqa: E402
from repro.analysis.__main__ import main as j_main  # noqa: E402
from repro.analysis.registry import Contract as JContract  # noqa: E402
from repro.models.mlp import SparseMLP as JSparseMLP  # noqa: E402
from repro.models.mlp import SparseMLPConfig as JSparseMLPConfig  # noqa: E402
from repro.optim.sgd import MomentumSGD as JMomentumSGD  # noqa: E402
from repro.train.trainer import make_segment_program as j_make_segment_program  # noqa: E402
from repro_torch.analysis import hlo_audit, hlo_parser, jaxpr_audit, lint, registry, waivers  # noqa: E402
from repro_torch.analysis.__main__ import CARD_CHECKS  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.analysis.compilecheck import expect_compiles, snapshot  # noqa: E402
from repro_torch.analysis.hlo_parser import alias_pairs, shape_bytes  # noqa: E402
from repro_torch.analysis.registry import AuditProgram, Contract  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models.mlp import SparseMLP, SparseMLPConfig  # noqa: E402
from repro_torch.optim.sgd import MomentumSGD  # noqa: E402
from repro_torch.serve.engine import EngineConfig, SparseInferenceEngine  # noqa: E402
from repro_torch.train.trainer import make_segment_program  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checks(violations):
    return {v.check for v in violations}


def _pairs(violations):
    return {(v.program, v.check) for v in violations}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_collects_every_hot_subsystem():
    specs = registry.collect()
    names = [s.name for s in specs]
    assert len(names) == len(set(names))
    subsystems = {s.subsystem for s in specs}
    assert set(registry.HOOK_MODULES) <= subsystems
    for expected in ("train.segment", "wasap.phase1_epoch", "xl.shard_acc",
                     "xl.shard_dw", "serve.prefill", "serve.decode"):
        assert expected in names
    # the reference's programs, in its order, with its contracts field for
    # field (the forbidden ops are each package's own host-sync ops)
    ref = j_registry.collect()
    assert names == [s.name for s in ref]
    assert registry.HOOK_MODULES == tuple(
        m.replace("repro.", "repro_torch.", 1) for m in j_registry.HOOK_MODULES)
    for mine, theirs in zip(specs, ref):
        a, b = dataclasses.asdict(mine.contract), dataclasses.asdict(theirs.contract)
        assert a.pop("forbidden_primitives") == registry.HOST_SYNC_OPS
        assert b.pop("forbidden_primitives") == j_registry.HOST_CALLBACK_PRIMITIVES
        assert a == b, mine.name
        assert mine.subsystem == theirs.subsystem.replace("repro.", "repro_torch.", 1)


def test_registry_get_unknown_raises():
    with pytest.raises(KeyError, match="no registered hot-path program"):
        registry.get("no.such.program")
    assert registry.expected_compiles("train.segment") >= 1
    assert registry.expected_compiles("train.segment") == j_registry.expected_compiles(
        "train.segment")


# ---------------------------------------------------------------------------
# mutation: scatter reintroduced into the backward
# ---------------------------------------------------------------------------

SEG_DIMS, SEG_BATCH, SEG_STEPS = (40, 32, 10), 8, 2


def _segment_contract(contract_cls):
    return contract_cls(
        max_unsorted_scatter=1,  # the reference's CE-loss label scatter
        max_unsorted_scatter_elems=SEG_BATCH * SEG_DIMS[-1],
    )


def _segment_case(element_impl):
    cfg = SparseMLPConfig(layer_dims=SEG_DIMS, epsilon=6, dropout=0.0,
                          element_impl=element_impl)
    model = SparseMLP(cfg, seed=0, device="cpu")
    opt = MomentumSGD(momentum=0.9, weight_decay=2e-4)
    n = SEG_STEPS * SEG_BATCH
    key = torch.Generator()
    key.manual_seed(0)
    args = (
        model.params(), opt.init(model.params()), model.topo_arrays(),
        torch.zeros((n, SEG_DIMS[0])), torch.zeros((n,), dtype=torch.int64),
        torch.arange(n).reshape(SEG_STEPS, SEG_BATCH),
        torch.full((SEG_STEPS,), 0.01), key,
    )
    return make_segment_program(cfg, opt), args, _segment_contract(Contract)


def _j_segment_violations(element_impl):
    cfg = JSparseMLPConfig(layer_dims=SEG_DIMS, epsilon=6, dropout=0.0,
                           element_impl=element_impl)
    model = JSparseMLP(cfg, seed=0)
    opt = JMomentumSGD(momentum=0.9, weight_decay=2e-4)
    n = SEG_STEPS * SEG_BATCH
    args = (
        model.params(), opt.init(model.params()), model.topo_arrays(),
        jnp.zeros((n, SEG_DIMS[0]), jnp.float32), jnp.zeros((n,), jnp.int32),
        jnp.arange(n, dtype=jnp.int32).reshape(SEG_STEPS, SEG_BATCH),
        jnp.full((SEG_STEPS,), 0.01, jnp.float32), jax.random.PRNGKey(0),
    )
    return j_jaxpr_audit.trace_and_audit(
        jax.jit(j_make_segment_program(cfg, opt)), args, _segment_contract(JContract),
        "train.segment")


def _scatter_train_T(hT, values, topo, out_dim, *, bias, slope=None, chunk=None):
    """The mutation: an element training layer in the scatter formulation
    (``espmm(impl="scatter")``: gather the inputs by row, scatter-add by
    column under autograd), whose backward scatter-adds into the input's
    gradient by row — unsorted."""
    y = tops.espmm(hT.T, values, topo, out_dim, impl="scatter") + bias
    if slope is not None:
        y = torch.where(y > 0, y, slope * y)
    return y.T


def test_mutation_scatter_backward_fails_named_contract(monkeypatch):
    """Swapping the element layer for the scatter formulation reintroduces
    unsorted scatter-adds into the backward (one a step per layer whose
    input needs a gradient) — the audit must fail the train.segment
    contract by name, as the reference's does."""
    monkeypatch.setattr(tmlp.kops, "espmm_train_T", _scatter_train_T)
    fn, args, contract = _segment_case("scatter")
    vs = jaxpr_audit.trace_and_audit(fn, args, contract, "train.segment")
    assert "unsorted-scatter" in _checks(vs)
    v = next(v for v in vs if v.check == "unsorted-scatter")
    assert v.program == "train.segment"
    assert v.waiver_id == "train.segment:unsorted-scatter"
    assert "aten.index_put" in v.message
    assert _pairs(vs) == _pairs(_j_segment_violations("scatter"))


def test_custom_impl_passes_same_contract():
    """Positive control: the designed formulation (kernels A and F; their
    plain versions' index_add_ walks sorted segment ids) satisfies the very
    contract the mutation fails, as the reference's custom VJP does."""
    fn, args, contract = _segment_case("custom")
    assert jaxpr_audit.trace_and_audit(fn, args, contract, "train.segment") == []
    assert _j_segment_violations("custom") == []


def test_sortedness_reads_the_index_order():
    """``index_add_`` over a non-decreasing index is a segment sum; the
    same add over a shuffled index is the unsorted hazard."""
    src = torch.ones(6, 2)
    for index, sorted_ in (([0, 0, 1, 2, 2, 3], True), ([2, 0, 1, 3, 0, 2], False)):
        _, rec = jaxpr_audit.record_call(
            lambda i: torch.zeros(4, 2).index_add_(0, i, src), (torch.tensor(index),))
        (op,) = [o for o in jaxpr_audit.iter_eqns(rec) if o.scatter is not None]
        assert jaxpr_audit._sorted(op.scatter) is sorted_


# ---------------------------------------------------------------------------
# mutation: host sync leaked into a device program
# ---------------------------------------------------------------------------


def test_mutation_host_callback_fails_forbidden_primitive():
    def leaky(x):
        y = torch.sin(x)
        return torch.full_like(y, y.sum().item())  # the host reads a value

    vs = jaxpr_audit.trace_and_audit(leaky, (torch.ones(4),), Contract(), "train.segment")
    assert _checks(vs) == {"forbidden-primitive"}
    assert vs[0].program == "train.segment"
    assert "aten._local_scalar_dense" in vs[0].message
    assert "test_torch_analysis.py" in vs[0].message  # the line it came from

    def j_leaky(x):
        y = jnp.sin(x)
        return jax.pure_callback(lambda a: np.asarray(a),
                                 jax.ShapeDtypeStruct(x.shape, x.dtype), y)

    assert _pairs(vs) == _pairs(j_jaxpr_audit.trace_and_audit(
        jax.jit(j_leaky), (jnp.ones((4,)),), JContract(), "train.segment"))


# ---------------------------------------------------------------------------
# mutation: dense materialization + f64 drift
# ---------------------------------------------------------------------------


def test_mutation_dense_materialization_fails_budget():
    def dense(a, b):
        return torch.outer(a, b).sum(dim=1)  # (512, 512) intermediate

    vs = jaxpr_audit.trace_and_audit(
        dense, (torch.ones(512), torch.ones(512)),
        Contract(max_intermediate_elems=1024), "xl.shard_acc",
    )
    assert "dense-materialization" in _checks(vs)
    assert vs[0].waiver_id == "xl.shard_acc:dense-materialization"
    assert _pairs(vs) == _pairs(j_jaxpr_audit.trace_and_audit(
        jax.jit(lambda a, b: jnp.outer(a, b).sum(axis=1)),
        (jnp.ones((512,)), jnp.ones((512,))), JContract(max_intermediate_elems=1024),
        "xl.shard_acc"))


def test_mutation_f64_drift_detected():
    """The contract the reference test describes: an f32 value cast to f64
    inside the program is drift (held here whatever the reference's own run
    gives)."""

    def drift(x):
        return x.to(torch.float64) * 2.0

    vs = jaxpr_audit.trace_and_audit(drift, (torch.ones(4),), Contract(), "train.segment")
    assert "f64-drift" in _checks(vs)
    assert vs[0].waiver_id == "train.segment:f64-drift"
    assert jaxpr_audit.trace_and_audit(
        drift, (torch.ones(4),), Contract(allow_f64=True), "train.segment") == []


def test_audit_recurses_into_scan_bodies():
    """The record holds every iteration of a loop body, and autograd's
    backward and checkpoint's recompute, as the reference's walk reaches
    into scan bodies."""

    def body(c, x):
        big = torch.outer(x, x)  # hidden inside the loop body
        return c + big.sum()

    def scanned(xs):
        c = torch.zeros(())
        for x in xs:
            c = body(c, x)
        return c

    contract = Contract(max_intermediate_elems=1024)
    vs = jaxpr_audit.trace_and_audit(scanned, (torch.ones(3, 128),), contract, "p")
    assert "dense-materialization" in _checks(vs)

    def recomputed(x):
        x = x.detach().requires_grad_(True)
        y = torch.utils.checkpoint.checkpoint(lambda t: (t * 2).sum(), x, use_reentrant=False)
        (g,) = torch.autograd.grad(y, x)
        return torch.outer(g, g)  # the backward's gradient, made dense

    vs = jaxpr_audit.trace_and_audit(recomputed, (torch.ones(128),), contract, "p")
    assert "dense-materialization" in _checks(vs)

    def j_body(c, x):
        return c + jnp.outer(x, x).sum(), None

    assert _pairs(j_jaxpr_audit.trace_and_audit(
        jax.jit(lambda xs: jax.lax.scan(j_body, 0.0, xs)[0]), (jnp.ones((3, 128)),),
        JContract(max_intermediate_elems=1024), "p")) == {("p", "dense-materialization")}


# ---------------------------------------------------------------------------
# mutation: dropped donation (run-level aliasing check)
# ---------------------------------------------------------------------------


def test_mutation_dropped_donation_fails_aliasing():
    """An AuditProgram whose ``make`` ignores the donate request models a
    refactor that silently dropped the in-place update: the call returns a
    new tensor, no donated buffer comes back, and the audit fails."""

    def step(acc, x):
        return acc + x, x.sum()

    def step_donated(acc, x):
        return acc.add_(x), x.sum()

    args = (torch.ones(64, 64), torch.ones(64, 64))
    contract = Contract(donate_argnums=(0,))

    dropped = AuditProgram(make=lambda donate: step, args=args)
    vs = hlo_audit.audit_compiled(dropped, contract, "xl.shard_acc")
    assert _checks(vs) == {"donation-aliasing"}
    assert vs[0].program == "xl.shard_acc"

    honored = AuditProgram(make=lambda donate: step_donated if donate else step, args=args)
    report = {}
    assert hlo_audit.audit_compiled(honored, contract, "xl.shard_acc", report) == []
    assert report["alias_pairs"] == [(0, 0)]
    assert torch.equal(args[0], torch.ones(64, 64))  # the donated call ran on copies


def test_mutation_dropped_donation_on_registered_program():
    """Same mutation through a real registered spec (the XL shard
    accumulator), proving the registry's plumbing reaches the run-level
    check; the designed build hands its accumulator back."""
    spec = registry.get("xl.shard_acc")
    prog = spec.build("cpu")
    dropped = AuditProgram(
        make=lambda donate: prog.make(()), args=prog.args, kwargs=prog.kwargs
    )
    vs = hlo_audit.audit_compiled(dropped, spec.contract, spec.name)
    assert "donation-aliasing" in _checks(vs)
    assert vs[0].waiver_id == "xl.shard_acc:donation-aliasing"
    assert hlo_audit.audit_compiled(prog, spec.contract, spec.name) == []


def test_temp_bytes_ceiling_enforced():
    def hungry(x):
        y = torch.outer(x, x)          # ~4 MB f32 temp
        return torch.tanh(y).sum()

    prog = AuditProgram(make=lambda donate: hungry, args=(torch.ones(1024),))
    report = {}
    vs = hlo_audit.audit_compiled(prog, Contract(max_temp_bytes=64 * 1024), "p", report)
    assert "temp-bytes" in _checks(vs)
    assert report["temp_bytes"] >= 2 * 1024 * 1024 * 4  # outer and tanh alive at once
    assert hlo_audit.audit_compiled(prog, Contract(max_temp_bytes=64 << 20), "p") == []


# ---------------------------------------------------------------------------
# run-level facts: aliasing, shapes
# ---------------------------------------------------------------------------


def test_hlo_parser_alias_header_nested_braces():
    """The twin of the header's ``{ {0}: (0, ...), {1}: (2, ...) }``: output
    0 is parameter 0's buffer, output 1 parameter 2's."""
    p = [torch.ones(8, 4), torch.ones(8, 4), torch.ones(8, 4)]
    assert alias_pairs(p, [p[0].add_(1), p[2].mul_(2), p[1] + 1]) == [(0, 0), (1, 2)]


def test_hlo_parser_no_alias_header():
    p = [torch.ones(3), torch.ones(0)]
    assert alias_pairs(p, [p[0] * 2, p[1]]) == []  # new buffer; empties never alias


def test_unknown_dtype_warns_once_and_is_recorded():
    unknown = set()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        n = shape_bytes("mystery9[3,5]", unknown=unknown)
        shape_bytes("mystery9[2]", unknown=unknown)  # second use: no rewarn
    assert n == 3 * 5 * 4  # documented 4-byte fallback
    assert unknown == {"mystery9"}
    msgs = [str(w.message) for w in caught if "mystery9" in str(w.message)]
    assert len(msgs) == 1
    assert shape_bytes("bfloat16[4,2]") == 16 and shape_bytes("int64[3]") == 24


def test_kernel_census_counts_scatters_not_gathers():
    """The census's scatter kernels: index-put, atomic index_add and
    scatter-like kernels; PyTorch's gather (the shared kernel with
    is_scatter_like false) and the hand kernels are not."""

    class Evt:
        def __init__(self, name, device_type="DeviceType.CUDA"):
            self.name, self.device_type = name, device_type

    gather = "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::" \
             "_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4>, int>"
    scatter_add = gather.replace("<false", "<true")
    put = "void at::native::index_elementwise_kernel<at::native::index_put_kernel_impl<...>>"
    add = "void at::native::indexFuncLargeIndex<float, long, unsigned int, 2, 2, -2, true>"
    mine = "void coo_matmul_T_f32_staged(float const*, ...)"
    events = [Evt(n) for n in (gather, gather, scatter_add, put, add, mine)]
    events.append(Evt("aten::index_put_", "DeviceType.CPU"))  # host op: not a device event
    cen = hlo_parser.kernel_census(events)
    assert sum(cen.values()) == 6 and cen[gather] == 2
    assert hlo_parser.scatter_kernels(cen) == {scatter_add: 1, put: 1, add: 1}
    assert hlo_parser.dtoh_copies({"Memcpy DtoH (Device -> Pinned)": 2, mine: 1}) == {
        "Memcpy DtoH (Device -> Pinned)": 2}


def test_hand_kernel_match_holds_census_against_launch_counters():
    """The hand kernels' events by family, demangled or mangled, beside
    the launches their wrappers counted: K8's shard dW counts on coo_dw,
    kernel G's standalone pass runs kernel F's kernel, bsmm_fwd's split-sum
    helper is not a launch of its own."""
    cen = {
        "void coo_matmul_T_kernel(float const*, float const*, int const*, long const*)": 2,
        "_Z19coo_matmul_T_stagedILb1EEvPKfS1_PKiPKlS1_S1_PfPhiff": 1,
        "void coo_dw_kernel<true, 4>(float const*, float const*, unsigned char const*)": 3,
        "void bias_all_relu_vec4<true>(float4 const*, float4 const*, float4*, long)": 1,
        "void bsmm_fwd_bf16_decode<16>(__nv_bfloat16 const*, ...)": 4,
        "sum_parts_bf16(float const*, __nv_bfloat16*, long, int, int, float)": 4,
        "void at::native::index_elementwise_kernel<128, 4, ...>": 5,
    }
    launches = {"coo_matmul_T": 3, "coo_matmul_T.epilogue": 2, "coo_dw": 2,
                "xl_shard_dw": 1, "all_relu_bwd": 1, "bias_all_relu": 1, "bsmm_fwd": 4}
    assert hlo_parser.hand_kernel_match(cen, launches) == {
        "coo_matmul_T": (3, 3), "coo_dw": (3, 3), "bias_all_relu": (1, 1),
        "bsmm_fwd": (4, 4)}
    # a capture that lost events, and one that lost them all
    lost = dict(cen)
    lost.pop("_Z19coo_matmul_T_stagedILb1EEvPKfS1_PKiPKlS1_S1_PfPhiff")
    assert hlo_parser.hand_kernel_match(lost, launches)["coo_matmul_T"] == (2, 3)
    assert hlo_parser.hand_kernel_match({}, {"bsmm_dx": 2}) == {"bsmm_dx": (0, 2)}
    # the census's leading spins are torch.cuda._sleep's kernel, no hand kernel's
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    assert hlo_parser.SPIN_KERNEL_RE.search(spin)
    assert not any(hlo_parser.SPIN_KERNEL_RE.search(k) for k in cen)
    assert hlo_parser.hand_kernel_match({spin: 1024}, {}) == {}


@pytest.mark.parametrize("whole_at", [1, 2, None])
def test_checked_census_retakes_a_capture_that_lost_events(monkeypatch, whole_at):
    """A census whose hand-kernel events differ from the launches counted
    over the same call is retaken behind a longer burst of leading spins,
    up to three takes; one still short after them is reported incomplete,
    and the run-level audit fails it with ``census-incomplete``."""
    counter = {"coo_matmul_T": 0}
    leads = []

    def fake_census(fn, args, kwargs=None, lead=0):
        leads.append(lead)
        fn(*args)
        seen = 2 if whole_at is not None and len(leads) >= whole_at else 1
        return {"void coo_matmul_T_kernel(float const*)": seen, "Memset (Device)": 1}

    def call():
        counter["coo_matmul_T"] += 2

    monkeypatch.setattr(hlo_audit, "census", fake_census)
    monkeypatch.setattr(hlo_audit, "launch_counts", lambda: dict(counter))
    taken = hlo_audit.checked_census(call, ())
    assert taken["complete"] == (whole_at is not None)
    assert taken["attempts"] == (whole_at or 3)
    assert leads == list(hlo_audit.CENSUS_LEADS[: taken["attempts"]])
    assert taken["launches"] == {"coo_matmul_T": 2}
    assert taken["hand_kernels"] == {
        "coo_matmul_T": (2 if whole_at is not None else 1, 2)}
    assert "census-incomplete" in CARD_CHECKS


def test_served_lm_programs_write_the_callers_caches_in_place():
    """``serve.prefill`` and ``serve.decode`` update the caller's KV caches
    in place on the CPU as on the card: the plain build hands back the
    very tensors it was given, and no copy of them is made."""
    for name in ("serve.prefill", "serve.decode"):
        prog = registry.get(name).build("cpu")
        caches = prog.args[2]
        before = [t.data_ptr() for t in jaxpr_audit._tensors(caches)]
        _, out = prog.make(())(*prog.args)
        assert out is caches
        assert [t.data_ptr() for t in jaxpr_audit._tensors(out)] == before


# ---------------------------------------------------------------------------
# AST lint: seeded violations
# ---------------------------------------------------------------------------

HOT_PATH = "src/repro_torch/train/trainer.py"  # any HOT_FILE_SUFFIXES member
J_HOT_PATH = "src/repro/train/trainer.py"


def _rules(src, relpath="src/repro_torch/models/thing.py"):
    findings = lint.lint_source(textwrap.dedent(src), relpath)
    return [f.rule for f in findings], findings


def _j_rules(src, relpath="src/repro/models/thing.py"):
    return [f.rule for f in j_lint.lint_source(textwrap.dedent(src), relpath)]


def test_lint_host_sync_item_in_jitted_fn():
    rules, findings = _rules(
        """
        import torch

        def f(x):
            return x.sum().item()

        def run(x):
            return torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False)
        """
    )
    assert rules == ["host-sync"]
    assert findings[0].qualname == "f"
    assert findings[0].waiver_id == (
        "lint:host-sync:src/repro_torch/models/thing.py:f"
    )
    assert rules == _j_rules(
        """
        import jax

        @jax.jit
        def f(x):
            return x.sum().item()
        """
    )


@pytest.mark.parametrize("method", ["tolist", "cpu", "numpy", "nonzero"])
def test_lint_host_sync_methods_in_autograd_function(method):
    rules, findings = _rules(
        f"""
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.{method}()

            @staticmethod
            def backward(ctx, dy):
                return dy
        """
    )
    assert rules == ["host-sync"]
    assert findings[0].qualname == "Op.forward"


def test_lint_host_sync_float_on_traced_param_only():
    rules, _ = _rules(
        """
        import torch
        from torch.utils.checkpoint import checkpoint

        def f(x, *, zeta):
            n = int(zeta * 10)      # static keyword-only config: fine
            return float(x) + n     # tensor param: flagged

        def run(x):
            return checkpoint(f, x, zeta=0.3, use_reentrant=False)
        """
    )
    assert rules == ["host-sync"]
    assert rules == _j_rules(
        """
        import jax

        @jax.jit
        def f(x, *, zeta):
            n = int(zeta * 10)
            return float(x) + n
        """
    )


def test_lint_tracer_branch():
    rules, findings = _rules(
        """
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                if x > 0:
                    return x
                return -x
        """
    )
    assert rules == ["tracer-branch"]
    assert "torch.where" in findings[0].message
    assert rules == _j_rules(
        """
        import jax

        @jax.jit
        def f(x):
            if x > 0:
                return x
            return -x
        """
    )


def test_lint_shape_branch_exempt():
    rules, _ = _rules(
        """
        import torch

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                if x.ndim == 2 and x.device.type == "cuda":
                    return x.sum()
                return x
        """
    )
    assert rules == [] == _j_rules(
        """
        import jax

        @jax.jit
        def f(x):
            if x.ndim == 2:
                return x.sum()
            return x
        """
    )


def test_lint_nested_def_inherits_traced_region():
    rules, findings = _rules(
        """
        import torch

        def outer(x):
            def inner(y):
                return float(y)
            return inner(x)

        def run(x):
            return torch.func.vmap(outer)(x)
        """
    )
    assert rules == ["host-sync"]
    assert findings[0].qualname == "outer.inner"


def test_lint_obs_span_in_jitted_fn():
    rules, findings = _rules(
        """
        import torch
        from repro_torch import obs

        def make_step():
            def step(x):
                with obs.span("step"):
                    return x * 2
            return step
        """,
        relpath=HOT_PATH,
    )
    assert rules == ["obs-in-jit"]
    assert findings[0].waiver_id == f"lint:obs-in-jit:{HOT_PATH}:make_step.step"


def test_lint_obs_bare_point_in_scan_body():
    rules, findings = _rules(
        """
        import torch
        from repro_torch.obs import point

        class Step(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                point("tick", i=0)
                return x * 2
        """
    )
    assert rules == ["obs-in-jit"]
    assert findings[0].qualname == "Step.forward"


def test_lint_obs_host_side_span_around_jit_is_clean():
    rules, _ = _rules(
        """
        import torch
        from repro_torch import obs

        def f(x):
            return x * 2

        def epoch(x):
            with obs.span("epoch") as sp:
                return sp.block_on(torch.utils.checkpoint.checkpoint(f, x))
        """
    )
    assert rules == []


def test_lint_graph_capture_body_is_a_device_region():
    rules, findings = _rules(
        """
        import torch

        def capture(x, g):
            with torch.cuda.graph(g):
                y = x * 2
                torch.cuda.synchronize()
            return y
        """
    )
    assert rules == ["host-sync"]
    assert findings[0].qualname == "capture"


def test_lint_missing_donation_hot_file_only():
    src = """
        def make_step():
            def step(params, opt_state, x):
                return params, opt_state
            return step
        """
    rules, findings = _rules(src, relpath=HOT_PATH)
    assert rules == ["jit-missing-donation"]
    assert findings[0].waiver_id == (
        f"lint:jit-missing-donation:{HOT_PATH}:make_step.step"
    )
    # same source outside the hot set: silent
    rules, _ = _rules(src, relpath="src/repro_torch/models/thing.py")
    assert rules == []
    assert _j_rules(
        """
        import jax

        @jax.jit
        def step(params, opt_state, x):
            return params, opt_state
        """, J_HOT_PATH) == ["jit-missing-donation"]


def test_lint_donation_satisfied_by_keyword():
    rules, _ = _rules(
        """
        from repro_torch.runtime import donation

        def make_step(donate=None):
            donated = donation.donate_argnums(1, override=donate)
            def step(params, opt_state, x):
                return params, opt_state
            return step

        def make_apply(donate=None):
            if 0 in donation.donate_argnums(0, override=donate):
                def _impl(acc, u):
                    return acc.add_(u)
            else:
                def _impl(acc, u):
                    return acc + u
            return _impl
        """,
        relpath=HOT_PATH,
    )
    assert rules == []


def test_lint_call_form_missing_donation():
    rules, _ = _rules(
        """
        import functools

        def _build_apply(scale):
            def _impl(acc, u, *, scale):
                return acc + scale * u
            return functools.partial(_impl, scale=scale)
        """,
        relpath=HOT_PATH,
    )
    assert rules == ["jit-missing-donation"]
    assert rules == _j_rules(
        """
        import jax

        def _impl(acc, u):
            return acc + u

        applied = jax.jit(_impl)
        """, J_HOT_PATH)


def test_lint_src_tree_is_clean_modulo_waivers():
    """The port's own source passes its own lint, modulo the documented
    waiver file — the zero-undocumented-waivers acceptance gate — and every
    waiver of the file carries a reason."""
    findings = lint.lint_tree(REPO_ROOT)
    wlist = waivers.load_waivers(
        os.path.join(REPO_ROOT, waivers.DEFAULT_WAIVERS_PATH)
    )
    unwaived, _, _ = waivers.apply_waivers(findings, wlist)
    assert unwaived == [], "\n".join(str(f) for f in unwaived)
    assert all(w.reason.strip() for w in wlist)
    # the reference's lint walks the port's tree too and stays clean there
    ref = [f for f in j_lint.lint_tree(REPO_ROOT, "src") if "repro_torch" in f.path]
    assert ref == [], "\n".join(str(f) for f in ref)


# ---------------------------------------------------------------------------
# lint: probe reductions allowlisted in device regions, recording is not
# (twins of tests/test_probes.py's lint tests)
# ---------------------------------------------------------------------------


def test_lint_probe_reduction_in_jit_allowlisted():
    rules, _ = _rules(
        """
        import torch
        from repro_torch.obs import probes

        def f(params, grads, topo, preacts, dims):
            return probes.segment_probe(params, grads, topo, preacts, dims)

        def run(*a):
            return torch.utils.checkpoint.checkpoint(f, *a)
        """
    )
    assert rules == []


def test_lint_probe_from_import_reduction_allowlisted():
    rules, _ = _rules(
        """
        import torch
        from repro_torch.obs.probes import value_l2 as vl2

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return vl2(x)
        """
    )
    assert rules == []


def test_lint_probe_record_in_jit_still_flagged():
    rules, findings = _rules(
        """
        import torch
        from repro_torch.obs import probes

        class Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                probes.record_snapshot(0, "train", {"grad_l2": x})
                return x
        """
    )
    assert rules == ["obs-in-jit"]
    assert "record_snapshot" in findings[0].message


def test_lint_probe_set_transform_in_jit_flagged_even_renamed():
    rules, _ = _rules(
        """
        from repro_torch.obs.probes import set_snapshot_transform as sst

        def make_step():
            def step(x):
                sst(None)
                return x
            return step
        """,
        relpath=HOT_PATH,
    )
    assert rules == ["obs-in-jit"]


def test_lint_probe_reduction_outside_jit_clean():
    rules, _ = _rules(
        """
        from repro_torch.obs import probes

        def host(x):
            return probes.record_snapshot(0, "t", {"grad_l2": x})
        """
    )
    assert rules == []


# ---------------------------------------------------------------------------
# waivers
# ---------------------------------------------------------------------------

WAIVER_TEXT = (
    '# header comment\n'
    '[[waiver]]\n'
    'id = "a:b"  # trailing comment\n'
    'reason = "says \\"why\\""\n'
    '\n'
    '[[waiver]]\n'
    'id = "c:d"\n'
    'reason = "other"\n'
)


def test_waiver_parse_roundtrip():
    ws = waivers.parse_waivers(WAIVER_TEXT)
    assert [(w.id, w.reason) for w in ws] == [
        ("a:b", 'says "why"'), ("c:d", "other"),
    ]
    assert [dataclasses.astuple(w) for w in ws] == [
        dataclasses.astuple(w) for w in j_waivers.parse_waivers(WAIVER_TEXT)]
    assert waivers.DEFAULT_WAIVERS_PATH == os.path.join("analysis", "waivers_torch.toml")


@pytest.mark.parametrize("bad,match", [
    ('[[waiver]]\nid = "a:b"\n', "needs both"),
    ('[[waiver]]\nid = "a:b"\nreason = "  "\n', "empty reason"),
    ('[[waiver]]\nid = "a"\nreason = "r"\n'
     '[[waiver]]\nid = "a"\nreason = "r"\n', "duplicate"),
    ('[table]\nid = "a"\n', "unsupported syntax"),
])
def test_waiver_parse_errors(bad, match):
    for mod in (waivers, j_waivers):
        with pytest.raises(ValueError, match=match):
            mod.parse_waivers(bad)


def test_apply_waivers_splits_and_flags_stale():
    def run(ja, wv):
        vs = [ja.Violation("p", "unsorted-scatter", "m1"), ja.Violation("q", "f64-drift", "m2")]
        ws = [wv.Waiver("p:unsorted-scatter", "known", 1), wv.Waiver("gone:check", "stale", 5)]
        unwaived, waived, unused = wv.apply_waivers(vs, ws)
        return ([v.waiver_id for v in unwaived], [(v.waiver_id, w.reason) for v, w in waived],
                [w.id for w in unused])

    got = run(jaxpr_audit, waivers)
    assert got == (["q:f64-drift"], [("p:unsorted-scatter", "known")], ["gone:check"])
    assert got == run(j_jaxpr_audit, j_waivers)


# ---------------------------------------------------------------------------
# compilecheck helper
# ---------------------------------------------------------------------------


def _mlp_engine():
    cfg = SparseMLPConfig(layer_dims=(32, 24, 6), epsilon=6, dropout=0.0)
    return SparseInferenceEngine(SparseMLP(cfg, seed=0, device="cpu"),
                                 engine=EngineConfig(batch_buckets=(1, 8)), device="cpu")


def test_expect_compiles_jitted_fn():
    """The twin of a jitted function's executables: the engine's bucket
    entries (its ``_cache_size``): a new bucket builds one, a warm one
    none, another bucket one more."""
    eng = _mlp_engine()
    x = np.zeros((3, 32), np.float32)
    with expect_compiles(eng._cache, 1):
        eng.classify(x)
    with expect_compiles(eng._cache, 0):
        eng.classify(x)  # warm: same bucket
    with pytest.raises(AssertionError, match="contract expects exactly"):
        with expect_compiles(eng._cache, 0):
            eng.classify(x[:1])  # new bucket -> new entry


def test_expect_compiles_counter_sources():
    counts = {"a": 0, "b": 0}
    with expect_compiles(lambda: dict(counts), 3):
        counts["a"] += 2
        counts["b"] += 1
    with expect_compiles(counts, 2):  # a live dict of counts
        counts["b"] += 2
    n = [0]
    with expect_compiles(lambda: n[0], 1, at_most=True):
        n[0] += 1
    with pytest.raises(TypeError, match="neither a jitted function"):
        snapshot(object())


def test_expect_compiles_registry_backed():
    assert registry.expected_compiles("xl.shard_acc") == 1
    n = [0]
    with expect_compiles(lambda: n[0], program="xl.shard_acc"):
        n[0] += 1
    with pytest.raises(TypeError, match="explicit count or a registered"):
        with expect_compiles(lambda: 0):
            pass
    eng = _mlp_engine()
    with expect_compiles(lambda: eng.stats["compiles"], program="serve.classify"):
        eng.classify(np.zeros((2, 32), np.float32))
        eng.classify(np.zeros((5, 32), np.float32))  # the same bucket


# ---------------------------------------------------------------------------
# CLI end-to-end
# ---------------------------------------------------------------------------


def test_cli_audits_program_clean(capsys):
    rc = analysis_main(["xl.shard_acc", "xl.shard_dw", "--no-lint", "--root", REPO_ROOT,
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[ok  ] xl.shard_acc" in out
    assert "PASS" in out
    assert j_main(["xl.shard_acc", "xl.shard_dw", "--no-lint", "--root", REPO_ROOT]) == rc


def test_cli_audits_every_program_and_the_tree_clean(capsys):
    """The whole audit on the CPU: the reference's eight programs in its
    order, each clean or waived, the lint clean modulo the waiver file."""
    reports, summary = {}, {}
    rc = analysis_main(["--root", REPO_ROOT, "--device", "cpu"], reports=reports,
                       summary=summary)
    out = capsys.readouterr().out
    assert rc == 0, out
    # the waived count of the last line holds the lint's waivers too
    assert summary == {"programs": 8, "unwaived": 0, "waived": 8, "stale": 0}
    assert f"{summary['waived']} waived" in out
    assert list(reports) == [s.name for s in j_registry.collect()]
    for name in reports:
        assert f"] {name} (" in out
    assert "0 unwaived violation(s)" in out and "0 stale waiver(s) -> PASS" in out
    assert reports["train.segment"]["waived"] == ["train.segment:donation-aliasing"]
    for name, ceiling in (("train.segment", 8 << 20), ("xl.shard_acc", 1 << 20)):
        assert 0 < reports[name]["temp_bytes"] <= ceiling


def test_cli_fails_on_stale_waiver(tmp_path, capsys):
    stale = tmp_path / "waivers.toml"
    stale.write_text(
        '[[waiver]]\nid = "xl.shard_acc:never-fires"\nreason = "stale"\n'
    )
    rc = analysis_main([
        "xl.shard_acc", "--no-lint", "--no-hlo", "--device", "cpu",
        "--root", REPO_ROOT, "--waivers", str(stale),
    ])
    out = capsys.readouterr().out
    assert rc == 1
    assert "STALE WAIVERS" in out


def test_cli_rejects_unknown_program(capsys):
    rc = analysis_main(["no.such.program", "--no-lint", "--root", REPO_ROOT,
                        "--device", "cpu"])
    assert rc == 2


def test_cli_refuses_without_a_card(capsys):
    """The programs run on the card unless --device cpu is given; without a
    card the CLI refuses instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is real")
    rc = analysis_main(["xl.shard_acc", "--no-lint", "--root", REPO_ROOT])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err
