"""Findings baseline: pin pre-existing accepted findings, fail new ones.

The baseline stores ``(rule, file, anchor, count)`` records — line-free
keys, so edits elsewhere in a file never churn it.  ``diff`` classifies a
fresh run into *new* (fail CI), *matched*, and *stale* (baseline entries
whose finding was fixed; reported as warnings so the baseline gets
pruned, but non-fatal)."""
from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Iterable

from .core import Finding

BASELINE_VERSION = 1


def _aggregate(findings: Iterable[Finding]) -> Counter:
    return Counter(f.key for f in findings)


def save(path: Path, findings: Iterable[Finding]) -> None:
    counts = _aggregate(findings)
    recs = [{"rule": r, "file": f, "anchor": a, "count": n}
            for (r, f, a), n in sorted(counts.items())]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": recs}, indent=2) + "\n")


def load(path: Path) -> Counter:
    doc = json.loads(path.read_text())
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}")
    out: Counter = Counter()
    for rec in doc.get("findings", []):
        out[(rec["rule"], rec["file"], rec["anchor"])] = int(rec["count"])
    return out


def diff(findings: list, baseline: Counter):
    """Return (new_findings, matched_count, stale_keys)."""
    budget = Counter(baseline)
    new, matched = [], 0
    for f in sorted(findings, key=lambda f: (f.file, f.line)):
        if budget[f.key] > 0:
            budget[f.key] -= 1
            matched += 1
        else:
            new.append(f)
    stale = sorted(k for k, n in budget.items() if n > 0)
    return new, matched, stale
