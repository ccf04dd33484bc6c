"""``python -m repro_torch.obs`` — trace- and timeline-file tooling.

Twin of ``python -m repro.obs``, a copy (it needs no framework).

* ``summarize <trace.jsonl>``: per-span count/total/self/percentile table
  (validates first; refuses malformed traces).
* ``validate <trace.jsonl>``: schema-check every JSONL event, exit nonzero
  on any error — the CI obs-smoke job runs this on freshly captured
  train + serve traces.
* ``report <timeline.jsonl>``: per-layer training-dynamics health tables
  from a probe timeline (validates first); ``--validate-only`` schema-
  checks and exits — the CI dynamics-smoke job runs both modes.
* ``diff <timeline_a> <timeline_b>``: per-layer B/A stat ratios between
  two runs' final snapshots, for regression triage.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import export, timeline


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="obs trace tooling (DESIGN.md §11)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize", help="per-span time breakdown")
    p_sum.add_argument("trace")
    p_sum.add_argument("--json", action="store_true",
                       help="machine-readable output")
    p_val = sub.add_parser("validate", help="schema-check every event")
    p_val.add_argument("trace")
    p_rep = sub.add_parser(
        "report", help="per-layer health table from a probe timeline"
    )
    p_rep.add_argument("timeline")
    p_rep.add_argument("--validate-only", action="store_true",
                       help="schema-check the timeline and exit")
    p_diff = sub.add_parser(
        "diff", help="compare two probe timelines (B/A stat ratios)"
    )
    p_diff.add_argument("timeline_a")
    p_diff.add_argument("timeline_b")
    args = ap.parse_args(argv)

    if args.cmd == "report":
        events = timeline.read_timeline(args.timeline)
        errors = timeline.validate_timeline(events)
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        if args.validate_only:
            print(f"{len(events)} event(s), {len(errors)} error(s) -> "
                  + ("FAIL" if errors else "PASS"))
            return 1 if errors else 0
        if errors:
            return 1
        print(timeline.render_report(events))
        return 0
    if args.cmd == "diff":
        ev_a = timeline.read_timeline(args.timeline_a)
        ev_b = timeline.read_timeline(args.timeline_b)
        bad = timeline.validate_timeline(ev_a) + timeline.validate_timeline(ev_b)
        for e in bad:
            print(f"INVALID: {e}", file=sys.stderr)
        if bad:
            return 1
        print(timeline.render_diff(ev_a, ev_b))
        return 0

    events = export.read_events(args.trace)
    errors = export.validate_events(events)
    if args.cmd == "validate":
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        print(f"{len(events)} event(s), {len(errors)} error(s) -> "
              + ("FAIL" if errors else "PASS"))
        return 1 if errors else 0

    if errors:
        print(f"trace failed validation ({len(errors)} error(s)); "
              "run `python -m repro_torch.obs validate` for details",
              file=sys.stderr)
        return 1
    summary = export.summarize_events(events)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print(export.format_summary(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
