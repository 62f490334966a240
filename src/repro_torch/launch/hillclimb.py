"""The perf hill-climb's cells (``repro/launch/hillclimb.py``): each
iteration's configuration sized by the dry run, its roofline terms
recorded before and after.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \
        --out perf_results.json [--only A]

The C pair differs only in ``fsdp``, which shards weights over a pod's
data axis; on one card it changes nothing, so C0 and C1 size alike and
each records ``fsdp_effect``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

ITERS = [
    # --- Cell A: qwen3-1.7b x train_4k (the paper's technique end to end)
    ("A0_faithful", dict(arch="qwen3_1_7b", shape_name="train_4k",
                         collapse=False)),
    ("A1_collapse", dict(arch="qwen3_1_7b", shape_name="train_4k",
                         collapse=True)),
    # --- Cell B: qwen3-1.7b x decode_32k (memory-bound serving)
    ("B0_ring64", dict(arch="qwen3_1_7b", shape_name="decode_32k",
                       collapse=True)),
    ("B1_ring32", dict(arch="qwen3_1_7b", shape_name="decode_32k",
                       collapse=True, ring=32)),
    # --- Cell C: minitron-8b x train_4k (FSDP: the weights' residency)
    ("C0_fsdp", dict(arch="minitron_8b", shape_name="train_4k",
                     collapse=True, fsdp=True)),
    ("C1_nofsdp", dict(arch="minitron_8b", shape_name="train_4k",
                       collapse=True, fsdp=False)),
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="perf_results.json")
    ap.add_argument("--only", default=None)
    args = ap.parse_args(argv)

    from ..core.ring import RING32, RING64
    from .dryrun import run_cell
    from .report import fmt_b, fmt_t

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name, kw in ITERS:
        if args.only and args.only not in name:
            continue
        if name in results:
            continue
        kw = dict(kw, ring=RING32 if kw.get("ring") == 32 else RING64)
        t0 = time.time()
        try:
            m = run_cell(verbose=False, **kw)
            m["iter"] = name
            print(f"[hillclimb] {name}: sized in {time.time() - t0:.2f}s "
                  f"args={fmt_b(m['mem']['argument_size_bytes'])} "
                  f"out={fmt_b(m['mem']['output_size_bytes'])} "
                  f"t_memory={fmt_t(m['t_memory'])} "
                  f"t_compute_limb={fmt_t(m['t_compute_limb'])} "
                  f"fsdp={m['fsdp']} ({m['fsdp_effect']})", flush=True)
        except Exception as e:  # noqa: BLE001
            m = {"iter": name, "error": repr(e)[:400]}
            print(f"[hillclimb] {name} FAILED: {e!r}"[:200], flush=True)
        results[name] = m
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
