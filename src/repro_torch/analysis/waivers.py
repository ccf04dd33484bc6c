"""Explicit waiver file for the contract auditor. Twin of
``repro.analysis.waivers``.

A waiver acknowledges ONE known violation by its stable id and must carry a
justification — the audit fails on any undocumented violation AND on any
waiver that no longer matches anything (stale waivers rot into blanket
exemptions otherwise).

The port's waivers live in ``analysis/waivers_torch.toml`` (the
reference's ``analysis/waivers.toml`` is its own), in the reference's small
TOML subset (parsed here, so the audit grows no dependency):

    [[waiver]]
    id = "train.segment:donation-aliasing"
    reason = "the segment is not donated: retry_step re-enters it"

Only ``[[waiver]]`` tables with ``key = "string"`` pairs and ``#`` comments
are understood; anything else is a parse error, loudly.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Sequence, Set, Tuple

__all__ = ["Waiver", "load_waivers", "apply_waivers", "DEFAULT_WAIVERS_PATH"]

DEFAULT_WAIVERS_PATH = os.path.join("analysis", "waivers_torch.toml")

_KV_RE = re.compile(r'^([A-Za-z_][\w\-]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*$')


@dataclasses.dataclass(frozen=True)
class Waiver:
    id: str
    reason: str
    line: int  # source line in the waiver file, for error messages


def _strip_comment(line: str) -> str:
    out = []
    in_str = False
    prev = ""
    for ch in line:
        if ch == '"' and prev != "\\":
            in_str = not in_str
        if ch == "#" and not in_str:
            break
        out.append(ch)
        prev = ch
    return "".join(out).strip()


def parse_waivers(text: str, path: str = "<waivers>") -> List[Waiver]:
    waivers: List[Waiver] = []
    current: Dict[str, str] = {}
    current_line = 0

    def flush() -> None:
        if not current:
            return
        if "id" not in current or "reason" not in current:
            raise ValueError(
                f"{path}:{current_line}: waiver needs both 'id' and a "
                f"non-empty 'reason' (got keys {sorted(current)})"
            )
        if not current["reason"].strip():
            raise ValueError(
                f"{path}:{current_line}: waiver {current['id']!r} has an "
                "empty reason — every waiver must be justified"
            )
        waivers.append(
            Waiver(id=current["id"], reason=current["reason"],
                   line=current_line)
        )

    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        if line == "[[waiver]]":
            flush()
            current = {}
            current_line = lineno
            continue
        m = _KV_RE.match(line)
        if m and current_line:
            current[m.group(1)] = (
                m.group(2).replace('\\"', '"').replace("\\\\", "\\")
            )
            continue
        raise ValueError(
            f"{path}:{lineno}: unsupported syntax {raw.strip()!r} — only "
            "[[waiver]] tables with key = \"string\" pairs are allowed"
        )
    flush()

    seen: Set[str] = set()
    for w in waivers:
        if w.id in seen:
            raise ValueError(f"{path}: duplicate waiver id {w.id!r}")
        seen.add(w.id)
    return waivers


def load_waivers(path: str) -> List[Waiver]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        return parse_waivers(fh.read(), path)


def apply_waivers(
    violations: Sequence, waivers: Sequence[Waiver]
) -> Tuple[List, List[Tuple[object, Waiver]], List[Waiver]]:
    """Split violations into (unwaived, waived-with-waiver, unused-waivers).

    Each violation must expose ``waiver_id``. A waiver may match several
    violations (e.g. one lint rule firing twice in a function).
    """
    by_id: Dict[str, Waiver] = {w.id: w for w in waivers}
    used: Set[str] = set()
    unwaived: List = []
    waived: List[Tuple[object, Waiver]] = []
    for v in violations:
        w = by_id.get(v.waiver_id)
        if w is None:
            unwaived.append(v)
        else:
            used.add(w.id)
            waived.append((v, w))
    unused = [w for w in waivers if w.id not in used]
    return unwaived, waived, unused
