#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since this started.

    python3 -u chip_smoke.py 2>&1 | python3 -u tools/stamp_lines.py > log

Reads the wall of each phase of a run that does not print its own (a
parent checkout's ``chip_smoke.py``): the time between the lines that
open two phases.
"""
import sys
import time


def main() -> None:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:9.2f} {line}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
