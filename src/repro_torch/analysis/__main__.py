"""``python -m repro_torch.analysis`` — audit every registered hot-path
program against its contract, lint the port's source tree, and reconcile
the result with the explicit waiver file. Twin of the reference's CLI:
exit nonzero on any unwaived violation, any stale waiver, any audit crash,
or an unknown program.

The programs run on the card unless ``--device cpu`` is given; with no
card the CLI refuses (exit 2) instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback
from typing import Dict, List, Optional

from repro_torch.analysis import hlo_audit, jaxpr_audit, lint, registry, waivers
from repro_torch.analysis.jaxpr_audit import Violation
from repro_torch.device import resolve_device

# checks that need the run-level pass; "host-sync", "hlo-scatter" and
# "census-incomplete" also need the card
HLO_CHECKS = frozenset({
    "temp-bytes", "hlo-scatter", "host-sync", "census-incomplete", "unknown-dtype",
    "donation-aliasing", "compile-error",
})
CARD_CHECKS = frozenset({"host-sync", "hlo-scatter", "census-incomplete"})


def _audit_spec(spec: registry.ProgramSpec, run_hlo: bool, device,
                report: Optional[dict] = None) -> List[Violation]:
    out: List[Violation] = []
    report = {} if report is None else report
    try:
        prog = spec.build(device)
    except Exception:
        return [Violation(
            spec.name, "build-error",
            "program build crashed:\n" + traceback.format_exc(limit=4),
        )]
    report["meta"] = prog.meta
    try:
        out.extend(jaxpr_audit.trace_and_audit(
            prog.make(()), prog.args, spec.contract, spec.name,
            kwargs=prog.kwargs,
        ))
    except Exception:
        out.append(Violation(
            spec.name, "trace-error",
            "op record crashed:\n" + traceback.format_exc(limit=4),
        ))
    if run_hlo:
        try:
            out.extend(hlo_audit.audit_compiled(prog, spec.contract, spec.name, report))
        except Exception:
            out.append(Violation(
                spec.name, "compile-error",
                "run-level audit crashed:\n" + traceback.format_exc(limit=4),
            ))
    return out


def main(argv=None, reports: Optional[Dict[str, dict]] = None,
         summary: Optional[dict] = None) -> int:
    """The CLI. ``reports`` (a dict, if given) receives each audited
    program's measurements (``hlo_audit.audit_compiled``'s report, its
    violations and its waivers) by name; ``summary`` (a dict, if given)
    the counts of the last line: ``programs``, ``unwaived``, ``waived``
    (the lint's waived findings included) and ``stale``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="hot-path contract auditor (DESIGN.md §10)",
    )
    ap.add_argument("programs", nargs="*",
                    help="audit only these registered programs")
    ap.add_argument("--root", default=os.getcwd(),
                    help="repo root (waivers + lint paths resolve here)")
    ap.add_argument("--waivers", default=None,
                    help="waiver file (default <root>/analysis/waivers_torch.toml)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the run-level checks (record only, faster)")
    ap.add_argument("--list", action="store_true",
                    help="list registered programs and exit")
    ap.add_argument("--device", default=None,
                    help="where the programs run: the card (default) or cpu")
    args = ap.parse_args(argv)

    specs = registry.collect()
    if args.list:
        for spec in specs:
            print(f"{spec.name:28s} [{spec.subsystem}] "
                  f"expected_compiles={spec.contract.expected_compiles}")
        return 0
    if args.programs:
        known = {s.name for s in specs}
        unknown = [p for p in args.programs if p not in known]
        if unknown:
            print(f"unknown program(s): {unknown}; known: {sorted(known)}",
                  file=sys.stderr)
            return 2
        specs = tuple(s for s in specs if s.name in args.programs)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"python -m repro_torch.analysis: {e} (--device cpu)", file=sys.stderr)
        return 2
    card = device.type == "cuda"

    findings: List = []
    reports = {} if reports is None else reports
    for spec in specs:
        report = reports.setdefault(spec.name, {})
        vs = _audit_spec(spec, not args.no_hlo, device, report)
        report["violations"] = vs
        status = "FAIL" if vs else "ok"
        print(f"[{status:4s}] {spec.name} ({spec.subsystem})"
              + (f" — {spec.notes}" if spec.notes and vs else ""))
        findings.extend(vs)

    if not args.no_lint:
        lint_findings = lint.lint_tree(args.root)
        print(f"[{'FAIL' if lint_findings else 'ok':4s}] lint "
              f"(src/repro_torch/, {len(lint.HOT_FILE_SUFFIXES)} hot files under "
              "the donation rule)")
        findings.extend(lint_findings)

    waiver_path = args.waivers or os.path.join(
        args.root, waivers.DEFAULT_WAIVERS_PATH
    )
    try:
        wlist = waivers.load_waivers(waiver_path)
    except ValueError as e:
        print(f"\nwaiver file error: {e}", file=sys.stderr)
        return 2
    unwaived, waived, unused = waivers.apply_waivers(findings, wlist)
    for v, w in waived:
        if getattr(v, "program", None) in reports:
            reports[v.program].setdefault("waived", []).append(w.id)

    # staleness is only meaningful for waivers this run could have matched:
    # lint waivers need the lint pass, run-level waivers need the run-level
    # checks (the card's two need the card), program waivers need their
    # program in the audited set
    audited = {s.name for s in specs}

    def _in_scope(w: waivers.Waiver) -> bool:
        if w.id.startswith("lint:"):
            return not args.no_lint
        prog, _, check = w.id.rpartition(":")
        if args.no_hlo and check in HLO_CHECKS:
            return False
        if not card and check in CARD_CHECKS:
            return False
        return prog in audited

    unused = [w for w in unused if _in_scope(w)]

    if waived:
        print(f"\nwaived ({len(waived)}):")
        for v, w in waived:
            print(f"  ~ {v}")
            print(f"    waiver: {w.reason}")
    if unwaived:
        print(f"\nVIOLATIONS ({len(unwaived)}):")
        for v in unwaived:
            print(f"  ! {v}")
    if unused:
        print(f"\nSTALE WAIVERS ({len(unused)}) — matched nothing, remove:")
        for w in unused:
            print(f"  ? {w.id} ({waiver_path}:{w.line})")

    failed = bool(unwaived or unused)
    n_programs = len(specs)
    if summary is not None:
        summary.update(programs=n_programs, unwaived=len(unwaived), waived=len(waived),
                       stale=len(unused))
    print(f"\n{n_programs} program(s) audited on {device.type}, "
          f"{len(unwaived)} unwaived violation(s), "
          f"{len(waived)} waived, {len(unused)} stale waiver(s) -> "
          + ("FAIL" if failed else "PASS"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
