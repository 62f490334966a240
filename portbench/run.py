#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and the device's busy and window
seconds.  The last line of standard output is the result; the last lines
of standard error give each number that decided ``correct`` beside its
limit.  Without as many CUDA cards as the cell asks for, or without the
program beside the benchmark, the run fails and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        harness.cache_env()
        c = harness.cell(args.workload)
        harness.require_cards(c["workload"]["chips"])
        result = harness.run_cell(c, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    harness.emit(*result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
