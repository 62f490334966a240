"""Dry-run sweep driver (``repro/launch/sweep.py``): every cell, cheapest
first, single- then multi-pod per cell, with incremental JSON output so
partial progress is usable.

    PYTHONPATH=src python -m repro_torch.launch.sweep --out results.json \
        [--collapse] [--max-minutes 120] [--start 0] \
        [--meshes single,multi,one]

``--meshes`` takes JAX's "single" (16x16) and "multi" (2x16x16), and
"one": the cell whole on one H100 (1xH100, ROADMAP D5).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ARCH_ORDER = [
    "whisper_tiny", "xlstm_350m", "qwen3_1_7b", "phi_3_vision_4_2b",
    "deepseek_7b", "minitron_8b", "zamba2_7b", "mixtral_8x7b",
    "nemotron_4_15b", "qwen3_moe_235b_a22b",
]
SHAPE_ORDER = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]


def cell_list():
    from .. import configs as CFGS
    cells = []
    for shape in SHAPE_ORDER:
        for arch in ARCH_ORDER:
            if shape == "long_500k" and arch not in CFGS.LONG_CONTEXT_ARCHS:
                continue
            cells.append((arch, shape))
    return cells


def _dump(results, path):
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--collapse", action="store_true")
    ap.add_argument("--max-minutes", type=float, default=1e9)
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--start", type=int, default=0)
    args = ap.parse_args(argv)

    from .dryrun import run_cell
    from .mesh import ONE_CARD, make_production_mesh
    t_start = time.time()
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r.get("arch"), r.get("shape"), r.get("mesh")) for r in results}

    chosen = args.meshes.split(",")
    meshes = [m for key, m in (
        ("single", make_production_mesh()),
        ("multi", make_production_mesh(multi_pod=True)),
        ("one", ONE_CARD)) if key in chosen]

    for arch, shape in cell_list()[args.start:]:
        for mesh in meshes:
            if (arch, shape, mesh.name) in done:
                continue
            if (time.time() - t_start) / 60 > args.max_minutes:
                print("[sweep] time budget reached", file=sys.stderr)
                _dump(results, args.out)
                return results
            t0 = time.time()
            try:
                m = run_cell(arch, shape, collapse=args.collapse,
                             verbose=False, mesh=mesh)
                print(f"[sweep] OK  {arch} x {shape} x {mesh.name} "
                      f"({time.time() - t0:.1f}s) bottleneck="
                      f"{m['bottleneck']} fits={m['fits']}", flush=True)
            except Exception as e:  # noqa: BLE001
                m = {"arch": arch, "shape": shape, "mesh": mesh.name,
                     "error": repr(e)[:400]}
                print(f"[sweep] ERR {arch} x {shape} x {mesh.name}: "
                      f"{e!r}"[:200], flush=True)
            results.append(m)
            _dump(results, args.out)
    return results


if __name__ == "__main__":
    main()
