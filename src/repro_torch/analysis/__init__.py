"""Hot-path contract auditor (DESIGN.md §10). Twin of ``repro.analysis``.

Machine-checks the port's performance invariants, in the card's terms:

* ``registry`` — subsystems declare their device programs + contracts;
* ``jaxpr_audit`` — record-level checks on the aten ops of one call,
  forward and backward (host-sync ops, unsorted scatters, dense
  materialization, f64 drift);
* ``hlo_audit`` — run-level checks (donation aliasing, temp bytes, and on
  the card host syncs and the kernel census) on the shared ``hlo_parser``;
* ``lint`` — AST pass for host-hostile source idioms in device regions;
* ``waivers`` — explicit, justified exception list
  (``analysis/waivers_torch.toml``);
* ``compilecheck`` — registry-backed zero-rebuild test helper.

Run ``python -m repro_torch.analysis`` for the full audit on the card, or
with ``--device cpu`` on the plain versions (nonzero exit on any unwaived
violation or stale waiver).
"""
from repro_torch.analysis import registry  # noqa: F401
from repro_torch.analysis.compilecheck import expect_compiles  # noqa: F401
from repro_torch.analysis.jaxpr_audit import Violation  # noqa: F401
