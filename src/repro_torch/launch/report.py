"""Render a dry run's JSON as a roofline table (``repro/launch/
report.py``).  A value the port's dry run does not have (a compiler's,
None) prints as "-".

    PYTHONPATH=src python -m repro_torch.launch.report dryrun_results.json
"""
from __future__ import annotations

import json
import sys

from .dryrun import MESH


def fmt_t(x):
    if x is None:
        return "-"
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def fmt_b(x):
    if x is None or x < 0:
        return "-"
    for unit, k in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= k:
            return f"{x/k:.1f}{unit}"
    return f"{x:.0f}B"


def fmt_num(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def render(results, mesh_filter: str = MESH) -> str:
    rows = ["| arch | shape | t_compute(limb) | t_memory | t_collective | "
            "bottleneck | useful | HLO flops | HLO bytes | coll bytes | "
            "arg+tmp mem/dev | fits | compile |",
            "|" + "---|" * 13]
    for r in results:
        if r.get("mesh") != mesh_filter:
            continue
        if "skipped" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | skipped: "
                        f"{r['skipped']} | | | | | | | | | | |")
            continue
        if "error" in r:
            rows.append(f"| {r['arch']} | {r['shape']} | FAILED: "
                        f"{r['error'][:60]} | | | | | | | | | | |")
            continue
        mem = r.get("mem", {})
        argb = (mem.get("argument_size_bytes") or 0) + \
            (mem.get("temp_size_bytes") or 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{fmt_t(r.get('t_compute_limb'))} | {fmt_t(r.get('t_memory'))} "
            f"| {fmt_t(r.get('t_collective'))} | "
            f"{(r.get('bottleneck') or '-').replace('t_', '')} | "
            f"{fmt_num(r.get('useful_ratio'), '.3f')} | "
            f"{fmt_num(r.get('flops'), '.2e')} | "
            f"{fmt_b(r.get('bytes_accessed'))} | "
            f"{fmt_b(r.get('collective_bytes'))} | {fmt_b(argb)} | "
            f"{'-' if r.get('fits') is None else r['fits']} | "
            f"{fmt_num(r.get('compile_s'), '')} |")
    return "\n".join(rows)


def report(results) -> str:
    failed = [r for r in results if "error" in r]
    skipped = [r for r in results if "skipped" in r]
    done = len(results) - len(failed) - len(skipped)
    return (f"## Dry-run status: {done} cells sized, {len(failed)} "
            f"failed, {len(skipped)} skipped\n\n### One H100 ({MESH})\n\n{render(results)}\n")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "dryrun_results.json"
    with open(path) as f:
        print(report(json.load(f)))


if __name__ == "__main__":
    main()
