#!/usr/bin/env python3
"""Host cost of the observability instruments on one in-process batch.

    python3 tools/torch_obs_cost.py [--tree DIR] [--label NAME] [--rounds N]

Serves the paper's 784-128-128-10 NN (one batch of 128 queries, random
weights and queries from seed 11, as ``chip_smoke.py`` step 4) through
``PartyPredictionServer`` on the card with the "hopper" backend, from the
``repro_torch`` package of the checkout at DIR (this one by default), and
prints one JSON line: the batch walls with tracing off and, where the
package has a recording tracer, with a ``Tracer`` installed (then drained;
its drain time apart), in turns (off, on, off, on, ...) after two warm-up
batches, beside the card's name and power limit.  With a recording
tracer it also splits the tracing cost: the host time of one pair of CUDA
timing events created and recorded (what ``TracedKernels`` adds to each
backend call), of one recorded span, and of one ``elapsed_time`` read
after a synchronize (what ``drain`` spends a call).  To compare two trees,
run both in one call, in turns: parent, this, this, parent.

Needs one NVIDIA GPU; exits 2 without one.  Builds the tree's kernels into
its own ``build/`` directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 128
SEED = 11


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rounds", type=int, default=8,
                    help="timed batches in each mode")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))

    import torch
    if not torch.cuda.is_available():
        print("torch_obs_cost: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import obs
    from repro_torch.configs.paper_models import NN
    from repro_torch.core.ring import RING64
    from repro_torch.kernels import build
    from repro_torch.serve.party_server import PartyPredictionServer
    from repro_torch.train.paper_ml import (MLPNet, mlp_net_init,
                                            mlp_net_predict_runtime,
                                            params_from_numpy)

    build.build_all()
    net = MLPNet(NN["features"], NN["layers"])
    enc = params_from_numpy(mlp_net_init(np.random.RandomState(SEED), net),
                            RING64, "cuda")
    X = np.random.RandomState(SEED + 1).randn(BATCH, net.features)
    traceable = hasattr(obs, "Tracer")

    def one_batch(traced: bool) -> tuple:
        tracer = obs.Tracer("cost") if traced else None
        prev = obs.install_tracer(tracer) if traced else None
        try:
            srv = PartyPredictionServer(
                lambda rt, Xb: mlp_net_predict_runtime(rt, enc, net, Xb),
                batch_size=BATCH, seed=SEED, device="cuda")
            for q in X:
                srv.submit(q)
            srv.flush()
        finally:
            if traced:
                obs.install_tracer(prev)
        drain_s = 0.0
        if traced:
            t0 = time.perf_counter()
            tracer.drain()
            drain_s = time.perf_counter() - t0
        return srv.stats.batch_walls_s[0], drain_s

    for _ in range(2):
        one_batch(False)
    out = {"label": args.label or args.tree, "card": card(),
           "torch": torch.__version__, "off_ms": [], "on_ms": [],
           "drain_ms": []}
    for _ in range(args.rounds):
        for traced in ((False, True) if traceable else (False,)):
            wall, drain = one_batch(traced)
            out["on_ms" if traced else "off_ms"].append(wall * 1e3)
            if traced:
                out["drain_ms"].append(drain * 1e3)
    if traceable:
        out.update(split_us(torch, obs))
    print(json.dumps(out))
    return 0


def split_us(torch, obs, n: int = 2000) -> dict:
    """Host microseconds a unit of the tracing cost, averaged over `n`."""
    stream = torch.cuda.current_stream()
    t0 = time.perf_counter()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        end.record(stream)
        pairs.append((start, end))
    event_pair = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start, end in pairs:
        start.elapsed_time(end)
    elapsed = time.perf_counter() - t0
    tracer = obs.Tracer("split")
    t0 = time.perf_counter()
    for k in range(n):
        tracer.raw_span("kernel.prf_bits", "kernel", 0.0, 0.0,
                        backend="hopper", kind="prf_bits", shape=[128, 1],
                        group=1)
    span = time.perf_counter() - t0
    return {"event_pair_us": event_pair / n * 1e6,
            "elapsed_time_us": elapsed / n * 1e6,
            "span_us": span / n * 1e6}


if __name__ == "__main__":
    sys.exit(main())
