"""AST lint for host-hostile idioms in the port's device regions. Twin of
``repro.analysis.lint``, with its rule ids and waiver ids.

Static-analysis companion to the record and run audits: those check what
one call of a program did; this checks what the *source* says, so it
catches hazards on code paths the audit scales never exercise.

A **device region** is the code a CUDA graph capture would record, the
port's twin of the reference's traced region:

* ``forward``/``backward`` (and ``setup_context``/``jvp``) of
  ``torch.autograd.Function`` subclasses;
* functions passed to ``torch.utils.checkpoint.checkpoint``, the
  ``torch.func`` transforms (``vmap``, ``grad``, ``vjp``, ...),
  ``torch.cuda.make_graphed_callables`` or ``torch.compile``, and the body
  of a ``with torch.cuda.graph(...)`` block;
* in the hot files (:data:`HOT_FILE_SUFFIXES`), the inner functions that a
  ``make_*`` / ``_build_*`` builder returns: the programs the
  ``analysis_programs()`` hooks register are built that way;
* every ``def`` nested in one.

Rules (each finding carries a stable waiver id
``lint:<rule>:<relpath>:<qualname>``):

* ``host-sync`` — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``.nonzero()``/``torch.nonzero``, a ``.synchronize()``
  (``torch.cuda.synchronize``), ``float(x)``/``int(x)``/``bool(x)`` on a
  value that references a tensor parameter, and ``np.asarray(x)`` /
  ``np.array(x)`` inside a device region. Each makes the host wait for
  the device, and a CUDA graph capture refuses it.
* ``tracer-branch`` — a Python ``if``/``while`` on a tensor parameter
  (positional, not keyword-only: keyword-only parameters are static config
  by the repo's convention) inside a device region: the branch reads the
  tensor's value on the host, and a captured graph replays one side only.
* ``jit-missing-donation`` — in the hot files only: a builder whose
  program takes a known big mutable buffer (``opt_state``, ``caches``,
  ``big_caches``, ``acc``, ``carry_acc``) and threads no ``donate``
  through ``runtime.donation.donate_argnums``. Donation policy is central
  (``repro_torch.runtime.donation``).
* ``obs-in-jit`` — any ``repro_torch.obs`` call inside a device region.
  Instrumentation lives host-side between device programs (DESIGN.md
  §11); inside a captured graph a span would time the capture, not the
  replays. The pure reductions of ``repro_torch.obs.probes``
  (``segment_probe``, ``value_l2``, ...) are tensor-only functions composed
  into probe program variants and are allowlisted (DESIGN.md §12); the
  module's host-side halves (``record_*``/``set_*`` names) stay hard
  failures.

Static parameters (keyword-only ones, and ``self``/``ctx``/``cls``) are
exempt from ``tracer-branch`` and the builtin ``host-sync`` rule.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LintFinding", "lint_file", "lint_tree", "HOT_FILE_SUFFIXES"]

# files under the donation rule and the builder rule: the registered
# hot-path subsystems plus the kernel layer they call into (matched by path
# suffix, OS-independent)
HOT_FILE_SUFFIXES: Tuple[str, ...] = (
    "repro_torch/train/trainer.py",
    "repro_torch/core/wasap.py",
    "repro_torch/xl/stream.py",
    "repro_torch/serve/engine.py",
    "repro_torch/launch/steps.py",
    "repro_torch/kernels/ops.py",
)

# parameter names that mean "big mutable buffer the caller won't reuse"
_BIG_BUFFER_PARAMS = frozenset(
    {"opt_state", "caches", "big_caches", "acc", "carry_acc"}
)

# callables that run their function argument as a device program
_DEVICE_TRANSFORMS = frozenset({
    "checkpoint", "vmap", "grad", "grad_and_value", "vjp", "jvp", "jacrev",
    "jacfwd", "hessian", "functional_call", "make_graphed_callables", "compile",
})
_FUNCTION_METHODS = frozenset({"forward", "backward", "setup_context", "jvp"})
_STATIC_SELF = frozenset({"self", "ctx", "cls"})
_BUILDER_PREFIXES = ("make_", "_build_")

_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "nonzero", "synchronize"})
_HOST_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
_HOST_SYNC_NP = frozenset({"asarray", "array"})


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str       # repo-relative
    line: int
    rule: str
    qualname: str   # enclosing function ("<module>" at top level)
    message: str

    @property
    def waiver_id(self) -> str:
        return f"lint:{self.rule}:{self.path}:{self.qualname}"

    def __str__(self) -> str:
        return f"[{self.waiver_id}] {self.path}:{self.line}: {self.message}"


def _dotted(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = _dotted(base)
        if name.split(".")[-1] == "Function" and (
            "." not in name or "autograd" in name or name.startswith("torch.")
        ):
            return True
    return False


def _is_transform(call: ast.Call) -> bool:
    name = _dotted(call.func)
    tail = name.split(".")[-1]
    if tail not in _DEVICE_TRANSFORMS:
        return False
    # torch.autograd.grad(outputs, inputs) takes tensors, not a function
    return not (tail == "grad" and "autograd" in name)


def _is_graph_capture(item: ast.withitem) -> bool:
    ctx = item.context_expr
    return isinstance(ctx, ast.Call) and _dotted(ctx.func).endswith("cuda.graph")


def _returned_names(fn: ast.AST) -> Set[str]:
    """Names in the builder's own return statements (not nested defs')."""
    out: Set[str] = set()

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                                  ast.ClassDef)):
                continue
            if isinstance(child, ast.Return) and child.value is not None:
                out.update(n.id for n in ast.walk(child.value) if isinstance(n, ast.Name))
            walk(child)

    walk(fn)
    return out


def _own_defs(fn: ast.AST) -> List[ast.FunctionDef]:
    """The defs whose nearest enclosing function is ``fn``."""
    out: List[ast.FunctionDef] = []

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            elif not isinstance(child, (ast.Lambda, ast.ClassDef)):
                walk(child)

    walk(fn)
    return out


def _threads_donation(fn: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _dotted(n.func).split(".")[-1] == "donate_argnums"
               for n in ast.walk(fn))


class _DeviceRegionFinder(ast.NodeVisitor):
    """First pass: the function-def nodes that open a device region, and
    the hot files' builder programs (program node -> builder node)."""

    def __init__(self, hot_file: bool) -> None:
        self.hot_file = hot_file
        self.regions: Set[ast.AST] = set()
        self.programs: Dict[ast.AST, ast.AST] = {}
        self._defs: Dict[str, ast.AST] = {}

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if _is_autograd_function(node):
            for item in node.body:
                if isinstance(item, ast.FunctionDef) and item.name in _FUNCTION_METHODS:
                    self.regions.add(item)
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._defs[node.name] = node
        if self.hot_file and node.name.startswith(_BUILDER_PREFIXES):
            returned = _returned_names(node)
            for item in _own_defs(node):
                if item.name in returned:
                    self.regions.add(item)
                    self.programs[item] = node
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Call(self, node: ast.Call) -> None:
        if _is_transform(node):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name) and arg.id in self._defs:
                    self.regions.add(self._defs[arg.id])
                elif isinstance(arg, ast.Lambda):
                    self.regions.add(arg)
        self.generic_visit(node)


def _obs_bindings(
    tree: ast.AST,
) -> Tuple[Set[str], Set[str], Set[str], Dict[str, str]]:
    """Names this module binds to ``repro_torch.obs``: ``(module aliases,
    bare function names, probes-module aliases, probe name -> original)``,
    as the reference's rule reads ``repro.obs``; the probe sets track
    bindings of ``repro_torch.obs.probes`` specifically, whose pure
    reductions are allowlisted while its ``record_*``/``set_*`` halves are
    not."""
    aliases: Set[str] = set()
    names: Set[str] = set()
    probe_aliases: Set[str] = set()
    probe_names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "repro_torch.obs" or a.name.startswith("repro_torch.obs."):
                    if a.asname:
                        if a.name == "repro_torch.obs.probes":
                            probe_aliases.add(a.asname)
                        else:
                            aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "repro_torch":
                for a in node.names:
                    if a.name == "obs":
                        aliases.add(a.asname or "obs")
            elif mod == "repro_torch.obs":
                for a in node.names:
                    if a.name == "probes":
                        probe_aliases.add(a.asname or "probes")
                    else:
                        names.add(a.asname or a.name)
            elif mod == "repro_torch.obs.probes":
                for a in node.names:
                    probe_names[a.asname or a.name] = a.name
            elif mod.startswith("repro_torch.obs."):
                for a in node.names:
                    names.add(a.asname or a.name)
    return aliases, names, probe_aliases, probe_names


def _probe_host_side(name: str) -> bool:
    """Probes-module names that must stay host-side (never in a device
    region)."""
    return name.startswith("record_") or name.startswith("set_")


def _param_names(fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(positional-or-normal, keyword-only) parameter names."""
    args = getattr(fn, "args", None)
    if args is None:
        return set(), set()
    pos = {a.arg for a in list(args.posonlyargs) + list(args.args)}
    if args.vararg is not None:
        pos.add(args.vararg.arg)
    kw = {a.arg for a in args.kwonlyargs}
    return pos, kw


def _test_exempt(test: ast.expr) -> bool:
    """Branch tests that read no tensor value: None checks, isinstance,
    shape/dtype/device introspection, len(), literals."""
    for node in ast.walk(test):
        if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            return True
        if isinstance(node, ast.Call):
            callee = _dotted(node.func).split(".")[-1]
            if callee in ("isinstance", "len", "hasattr", "getattr"):
                return True
        if isinstance(node, ast.Attribute) and node.attr in (
            "shape", "ndim", "dtype", "size", "device", "is_cuda", "requires_grad",
            "numel", "dim",
        ):
            return True
    return False


class _RuleVisitor(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        regions: Set[ast.AST],
        programs: Dict[ast.AST, ast.AST],
        hot_file: bool,
        obs_aliases: Set[str] = frozenset(),
        obs_names: Set[str] = frozenset(),
        probe_aliases: Set[str] = frozenset(),
        probe_names: Optional[Dict[str, str]] = None,
    ) -> None:
        self.path = path
        self.regions = regions
        self.programs = programs
        self.hot_file = hot_file
        self.obs_aliases = set(obs_aliases)
        self.obs_names = set(obs_names)
        self.probe_aliases = set(probe_aliases)
        self.probe_names = dict(probe_names or {})
        self.findings: List[LintFinding] = []
        # stack of (node, tensor param names) for enclosing device regions
        self._stack: List[Tuple[ast.AST, Set[str]]] = []
        self._qual: List[str] = []

    # -- helpers -----------------------------------------------------------

    def _qualname(self) -> str:
        return ".".join(self._qual) if self._qual else "<module>"

    def _in_region(self) -> bool:
        return bool(self._stack)

    def _tensor_params(self) -> Set[str]:
        out: Set[str] = set()
        for _, names in self._stack:
            out |= names
        return out

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(LintFinding(
            path=self.path,
            line=getattr(node, "lineno", 0),
            rule=rule,
            qualname=self._qualname(),
            message=message,
        ))

    # -- device-region tracking -------------------------------------------

    def _enter_fn(self, node: ast.AST, name: str) -> None:
        self._qual.append(name)
        inside = node in self.regions or self._in_region()
        if inside:
            pos, kw = _param_names(node)
            self._stack.append((node, pos - kw - _STATIC_SELF))
        self.generic_visit(node)
        if inside:
            self._stack.pop()
        self._qual.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_donation(node)
        self._enter_fn(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._enter_fn(node, "<lambda>")

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item)
        if any(_is_graph_capture(item) for item in node.items):
            self._stack.append((node, set()))
            for stmt in node.body:
                self.visit(stmt)
            self._stack.pop()
        else:
            for stmt in node.body:
                self.visit(stmt)

    # -- rule: jit-missing-donation ---------------------------------------

    def _check_donation(self, node: ast.FunctionDef) -> None:
        builder = self.programs.get(node)
        if builder is None:
            return
        pos, _ = _param_names(node)
        bufs = pos & _BIG_BUFFER_PARAMS
        if bufs and not _threads_donation(builder):
            self._qual.append(node.name)
            self._emit(
                node, "jit-missing-donation",
                f"{builder.name} builds {node.name}({', '.join(sorted(bufs))}, ...) "
                "and threads no donate — route it through "
                "repro_torch.runtime.donation.donate_argnums",
            )
            self._qual.pop()

    def visit_Call(self, node: ast.Call) -> None:
        if self._in_region():
            self._check_obs(node)
            self._check_host_sync(node)
        self.generic_visit(node)

    # -- rule: obs-in-jit --------------------------------------------------

    def _check_obs(self, node: ast.Call) -> None:
        callee_full = _dotted(node.func)
        root = callee_full.split(".")[0]
        tail = callee_full.split(".")[-1]
        if "." not in callee_full and callee_full in self.probe_names:
            probe_binding, probe_orig = True, self.probe_names[callee_full]
        elif "." in callee_full and (
            root in self.probe_aliases
            or callee_full.startswith("repro_torch.obs.probes.")
        ):
            probe_binding, probe_orig = True, tail
        else:
            probe_binding, probe_orig = False, tail
        is_obs = (
            root in self.obs_aliases
            or callee_full.startswith("repro_torch.obs.")
            or ("." not in callee_full and callee_full in self.obs_names)
            or probe_binding
        )
        if is_obs and not (probe_binding and not _probe_host_side(probe_orig)):
            self._emit(
                node, "obs-in-jit",
                f"{callee_full}() reachable inside a device region — "
                "obs instrumentation must stay host-side between device "
                "programs (DESIGN.md §11)",
            )

    # -- rule: host-sync ---------------------------------------------------

    def _check_host_sync(self, node: ast.Call) -> None:
        callee = _dotted(node.func)
        tail = callee.split(".")[-1]
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_METHODS
            and not (node.func.attr == "item" and node.args)
        ):
            self._emit(
                node, "host-sync",
                f".{node.func.attr}() inside a device region makes the host "
                "wait for the device",
            )
        elif (
            isinstance(node.func, ast.Name)
            and tail in _HOST_SYNC_BUILTINS
            and node.args
            and not isinstance(node.args[0], ast.Constant)
            and not _test_exempt(node.args[0])
            and any(
                isinstance(n, ast.Name) and n.id in self._tensor_params()
                for n in ast.walk(node.args[0])
            )
        ):
            # only flagged when the argument references a tensor parameter:
            # int(zeta * n) over static config and shapes is host
            # arithmetic, not a sync
            self._emit(
                node, "host-sync",
                f"{tail}() on a tensor parameter reads its value on the host "
                "(a device->host sync)",
            )
        elif (
            tail in _HOST_SYNC_NP
            and callee.split(".")[0] in ("np", "numpy")
            and node.args
        ):
            self._emit(
                node, "host-sync",
                f"{callee}() copies a device value to the host inside a "
                "device region",
            )

    # -- rule: tracer-branch ----------------------------------------------

    def _check_branch(self, node, test: ast.expr) -> None:
        if not self._in_region() or _test_exempt(test):
            return
        params = self._tensor_params()
        if not params:
            return
        for sub in ast.walk(test):
            if isinstance(sub, ast.Name) and sub.id in params:
                self._emit(
                    node, "tracer-branch",
                    f"Python branch on tensor parameter {sub.id!r} — use "
                    "torch.where or make it static (keyword-only)",
                )
                return

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node, node.test)
        self.generic_visit(node)


def _is_hot_file(relpath: str) -> bool:
    norm = relpath.replace(os.sep, "/")
    return any(norm.endswith(suffix) for suffix in HOT_FILE_SUFFIXES)


def lint_source(source: str, relpath: str) -> List[LintFinding]:
    tree = ast.parse(source, filename=relpath)
    hot = _is_hot_file(relpath)
    finder = _DeviceRegionFinder(hot)
    finder.visit(tree)
    obs_aliases, obs_names, probe_aliases, probe_names = _obs_bindings(tree)
    visitor = _RuleVisitor(
        path=relpath.replace(os.sep, "/"),
        regions=finder.regions,
        programs=finder.programs,
        hot_file=hot,
        obs_aliases=obs_aliases,
        obs_names=obs_names,
        probe_aliases=probe_aliases,
        probe_names=probe_names,
    )
    visitor.visit(tree)
    return visitor.findings


def lint_file(path: str, root: Optional[str] = None) -> List[LintFinding]:
    rel = os.path.relpath(path, root) if root else path
    with open(path, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), rel)


def lint_tree(root: str, subdir: str = os.path.join("src", "repro_torch")) -> List[LintFinding]:
    """Lint every .py under root/subdir; paths in findings are root-relative."""
    findings: List[LintFinding] = []
    top = os.path.join(root, subdir)
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                findings.extend(lint_file(os.path.join(dirpath, fn), root))
    return findings

