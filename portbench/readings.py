#!/usr/bin/env python3
"""The readings the limits of ``limits/<workload>.json`` are set from: the
numbers of ``compare`` for many seeds in one process, for the program as
the cell runs it, for the control, or with a fault planted.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \
        [--mode program|control|noise[:<units>]|fault:<name>] \
        [--seconds 10] [--out FILE] [--detail]

``program``: the lower readings.  ``control``: the program on its own
32-bit ring (Z_2^32, the same 13 fractional bits), the nearest precision
below the configuration's 64-bit words; for serving it is fed the sound
run's prompts and tokens, and its largest logit at each position is read
in the reference.  ``fault:<name>``: a fault of ``faults`` planted in the
program.  ``noise[:<units>]`` (training): the reference with a
zero-mean noise of each truncation, uniform within that many units (1)
either side, put in the program's place: the witness of what the
truncations' noise alone moves.  Each seed prints one JSON line (also appended to --out).  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from portbench import compare, faults, harness  # noqa: E402


# the control: the program's own 32-bit ring (its fractional bits unchanged)
CONTROL_RING = 32


def train_reading(c, seed, mode, device, detail=False):
    d = harness.driver("train_steps")
    cfg, traffic = c["config"], c["traffic"]
    if mode.startswith("noise"):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 1)
        units = float(mode[6:]) if mode.startswith("noise:") else 1.0
        prog = d.reference_readings(cfg, traffic, seed, device, noise=gen,
                                    noise_units=units)
    else:
        remove = faults.plant(mode[6:]) if mode.startswith("fault:") \
            else None
        try:
            p = d.Program(cfg, traffic, seed, device, ring_bits=CONTROL_RING
                          if mode == "control" else None)
            prog = p.check_readings()
            p.free()
            del p
        finally:
            if remove:
                remove()
    refr = d.reference_readings(cfg, traffic, seed, device)
    out = d.numbers(cfg, prog, refr)
    out["loss_gap"] = max(abs(a - b) for a, b in zip(prog["losses"],
                                                     refr["losses"]))
    if detail:
        out["leaves"] = {k: {"grad": [prog["grad"][k], refr["grad"][k]],
                             "change": [prog["change"][k],
                                        refr["change"][k]]}
                         for k in refr["grad"]}
        out["losses"] = [prog["losses"], refr["losses"]]
    return out


def serve_reading(c, seed, mode, device, seconds):
    d = harness.driver("serve_closed")
    cfg, traffic = c["config"], c["traffic"]
    remove = faults.plant(mode[6:]) if mode.startswith("fault:") else None
    try:
        p = d.Program(cfg, traffic, seed, device)
        d.warm_up(p)
        w = d.window(p, seconds)
        p.free()
        del p
    finally:
        if remove:
            remove()
    served = d.check_sample(traffic, w["requests"], seed)
    out = {"requests": len(w["requests"])}
    if mode == "control":
        ctl = d.Program(cfg, traffic, seed, device,
                        ring_bits=CONTROL_RING)
        forced = []
        for r in served:
            got = ctl.serve(r["i"], force=r["tokens"])
            forced.append({**r, "logits": got["logits"],
                           "tokens": [int(lg.argmax())
                                      for lg in got["logits"]]})
        ctl.free()
        del ctl
        served = forced
    gaps, err = d.reference_gaps(cfg, traffic, seed, device, served)
    out.update(compare.serve_numbers(gaps, err))
    out["tokens"] = sum(len(r) for r in gaps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", action="store_true",
                    help="each leaf's norms beside the numbers")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.cache_env()
    c = harness.cell(args.workload)
    kind = c["traffic"]["kind"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if kind == "train_steps":
            nums = train_reading(c, seed, args.mode, args.device,
                                 args.detail)
        else:
            nums = serve_reading(c, seed, args.mode, args.device,
                                 args.seconds)
        line = json.dumps({"workload": args.workload, "mode": args.mode,
                           "seed": seed, **nums,
                           "wall_s": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
