"""tridentlint CLI over the port (invoked via scripts/tridentlint_torch.py).

Default run walks ``src/repro_torch/`` with every rule and diffs against
the committed baseline (``analysis/baseline_torch.json``); extra file
arguments (with ``--pretend-path``) let CI inject a synthetic violation
and assert the gate trips."""
from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

from . import baseline as bl
from .core import Module, all_rules, load_tree, run_rules


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tridentlint_torch",
        description="protocol-invariant static analyzer + concurrency audit")
    p.add_argument("extra", nargs="*", type=Path,
                   help="additional files to scan (see --pretend-path)")
    p.add_argument("--root", type=Path, default=None,
                   help="tree to scan (default: <repo>/src/repro_torch)")
    p.add_argument("--baseline", type=Path, default=None,
                   help="committed findings baseline to diff against")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite --baseline from this run's findings")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule IDs (default: all)")
    p.add_argument("--pretend-path", default=None,
                   help="treat each extra file as living at this relpath "
                        "under the scan root (enables path-scoped rules)")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, rule in sorted(all_rules().items()):
            print(f"{rid:9s} {rule.name:32s} {rule.doc.splitlines()[0]}")
        return 0

    root = args.root
    if root is None:
        root = Path(__file__).resolve().parents[2] / "repro_torch"
    rules = args.rules.split(",") if args.rules else None

    modules = load_tree(root) if root.exists() else []
    findings = run_rules(modules, rules=rules)

    for path in args.extra:
        rel = args.pretend_path or path.name
        mod = Module.load(path, rel)
        findings.extend(run_rules([mod], rules=rules,
                                  force=args.pretend_path is None))

    findings.sort(key=lambda f: (f.file, f.line, f.rule))

    if args.baseline and args.update_baseline:
        bl.save(args.baseline, findings)
        print(f"baseline updated: {args.baseline} "
              f"({len(findings)} finding(s) pinned)")
        return 0

    base = bl.load(args.baseline) if args.baseline and args.baseline.exists() \
        else Counter()
    new, matched, stale = bl.diff(findings, base)

    for f in new:
        print(f.render())
    if matched:
        print(f"# {matched} pre-existing finding(s) matched the baseline")
    for key in stale:
        print(f"# stale baseline entry (finding fixed — prune with "
              f"--update-baseline): {key[0]} {key[1]} [{key[2]}]")
    if new:
        print(f"tridentlint: {len(new)} new finding(s)")
        return 1
    print("tridentlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
