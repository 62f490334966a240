"""Assemble an experiments document from the dry run's and the hill
climb's JSON (``repro/launch/assemble.py``): the roofline table replaces
``(REPORT_PLACEHOLDER ...)`` and the hill-climb table
``(PERF_TABLE_PLACEHOLDER)``.

    PYTHONPATH=src python -m repro_torch.launch.assemble \
        [--dryrun dryrun_results.json] [--perf perf_results.json] \
        [--doc EXPERIMENTS.md]
"""
from __future__ import annotations

import argparse
import json
import os

from . import report as R

REPORT_PLACEHOLDER = ("(REPORT_PLACEHOLDER — table generated from "
                      "dryrun_results.json)")
PERF_PLACEHOLDER = "(PERF_TABLE_PLACEHOLDER)"


def perf_table(perf: dict) -> str:
    rows = ["| iter | cell | HLO flops | HLO bytes | t_memory | "
            "t_compute_limb | t_collective | arg mem/dev | temp/dev | fsdp | "
            "verdict |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    for name, m in perf.items():
        if "error" in m:
            rows.append(f"| {name} | - | FAILED: {m['error'][:60]} "
                        f"| | | | | | | | |")
            continue
        rows.append(
            f"| {name} | {m['arch']}×{m['shape']} | "
            f"{R.fmt_num(m['flops'], '.3e')} | "
            f"{R.fmt_b(m['bytes_accessed'])} | {R.fmt_t(m['t_memory'])} | "
            f"{R.fmt_t(m['t_compute_limb'])} | "
            f"{R.fmt_t(m['t_collective'])} | "
            f"{R.fmt_b(m['mem']['argument_size_bytes'])} | "
            f"{R.fmt_b(m['mem']['temp_size_bytes'])} | {m['fsdp']} | |")
    notes = []

    def ratio(a, b, key, sub=None):
        if a in perf and b in perf and "error" not in perf[a] \
                and "error" not in perf[b]:
            va = perf[a][key] if sub is None else perf[a][key][sub]
            vb = perf[b][key] if sub is None else perf[b][key][sub]
            if va is not None and vb:
                return va / vb
        return None

    r = ratio("A0_faithful", "A1_collapse", "t_compute_limb")
    if r:
        notes.append(f"* A0→A1: ring products ×{1 / r:.2f} (collapse: 4 "
                     f"ring products a secure MAC for 16).")
    r = ratio("B0_ring64", "B1_ring32", "mem", "argument_size_bytes")
    if r:
        notes.append(f"* B0→B1: argument bytes ×{1 / r:.2f} (ring32).")
    r = ratio("C1_nofsdp", "C0_fsdp", "mem", "argument_size_bytes")
    c = ratio("C1_nofsdp", "C0_fsdp", "collective_bytes")
    if r and c:
        notes.append(f"* C1→C0: per-device argument bytes ×{1 / r:.2f} with "
                     f"FSDP on (the sharding rules' ratio), collective "
                     f"bytes ×{1 / c:.2f}: the weights' residency traded "
                     f"for their all-gathers.")
    return "\n".join(rows) + "\n\n" + "\n".join(notes)


def assemble(results: list, perf: dict | None, src: str) -> str:
    """`src` with both placeholders filled."""
    src = src.replace(REPORT_PLACEHOLDER, R.report(results))
    return src.replace(PERF_PLACEHOLDER, perf_table(perf) if perf else "")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="dryrun_results.json")
    ap.add_argument("--perf", default="perf_results.json")
    ap.add_argument("--doc", default="EXPERIMENTS.md")
    args = ap.parse_args(argv)
    with open(args.dryrun) as f:
        res = json.load(f)
    perf = None
    if os.path.exists(args.perf):
        with open(args.perf) as f:
            perf = json.load(f)
    with open(args.doc) as f:
        src = f.read()
    with open(args.doc, "w") as f:
        f.write(assemble(res, perf, src))
    print(f"{args.doc} assembled: "
          f"{len([r for r in res if 'mem' in r])} cells, perf iters: "
          f"{len(perf or {})}")


if __name__ == "__main__":
    main()
