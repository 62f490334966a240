"""Secure NN inference across four OS processes over TCP, on the port.

The acceptance demo of the distributed transport subsystem: a small MLP
with fused-truncation linear layers and real nonlinear activations
(ReLU + sigmoid via the ported conversions) runs three ways --

  1. the joint simulation (one trace, analytic CostTally),
  2. the party-sliced runtime over the in-memory LocalTransport,
  3. four OS processes over SocketTransport (TCP mesh, framed messages),

and the script checks the reconstructed predictions are *bit-identical*
across all three, and that the bytes/rounds measured on the real wire
equal the in-memory measurement and the analytic tally.  A WAN network
model wraps the socket backend, so the run also reports modeled
wall-clock under the paper's WAN environment next to the measured
single-machine wall-clock.

    PYTHONPATH=src python examples_torch/secure_inference_sockets.py \
        [--device cpu]

Every world runs on the card (``--device cuda``, the default; refused
without one; each daemon loads the built kernels) or on the CPU.  The
daemons import this file by name (spawn): its top level is definitions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import activations as ACT
from repro_torch.core import protocols as PR
from repro_torch.core.context import make_context, resolve_device
from repro_torch.core.ring import RING64
from repro_torch.runtime import FourPartyRuntime
from repro_torch.runtime import activations as RA
from repro_torch.runtime import protocols as RT
from repro_torch.runtime.net import WAN, PartyCluster

rng = np.random.RandomState(0)
D, H, O, BATCH = 12, 8, 3, 4
W1 = rng.randn(D, H) * 0.3
W2 = rng.randn(H, O) * 0.3
X = rng.randn(BATCH, D)
SEED = 17
TIMEOUT = 300


def predict_parties(rt, rank):
    """share -> matmul_tr -> relu -> matmul_tr -> sigmoid -> reconstruct."""
    xs = RT.share(rt, rt.encode(X))
    w1 = RT.share(rt, rt.encode(W1))
    w2 = RT.share(rt, rt.encode(W2))
    h = RA.relu(rt, RT.matmul_tr(rt, xs, w1))
    out = RA.sigmoid(rt, RT.matmul_tr(rt, h, w2))
    return RT.reconstruct(rt, out)[rank]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    # 1. joint simulation (same program order as predict_parties, so the
    # PRF counter streams -- and hence every share -- line up exactly)
    ctx = make_context(RING64, seed=SEED, device=device)
    xs, w1, w2 = (PR.share(ctx, ctx.encode(a)) for a in (X, W1, W2))
    h = ACT.relu(ctx, PR.matmul_tr(ctx, xs, w1))
    out = ACT.sigmoid(ctx, PR.matmul_tr(ctx, h, w2))
    ref = PR.reconstruct(ctx, out).cpu().numpy()

    # 2. party-sliced runtime, in-memory transport
    rt = FourPartyRuntime(RING64, seed=SEED, device=device)
    local = predict_parties(rt, 1).cpu().numpy()
    assert np.array_equal(local, ref), "local runtime != joint simulation"
    assert rt.transport.totals() == ctx.tally.totals()
    assert not rt.abort_flag() and not ctx.abort_flag()
    print("joint == local runtime (bit-identical), measured == tally ✓")

    # 3. four OS processes over TCP, WAN network model on top
    t0 = time.time()
    with PartyCluster(net_model=WAN, timeout=TIMEOUT,
                      device=str(device)) as cluster:
        results = cluster.submit(predict_parties, seed=SEED,
                                 timeout=TIMEOUT)
    wall = time.time() - t0
    for res in results:
        assert np.array_equal(np.asarray(res.result).view(np.int64), ref), \
            f"P{res.rank} diverged"
        assert res.totals == rt.transport.totals(), f"P{res.rank} traffic"
        assert not res.abort
    print("socket (4 processes) == joint (bit-identical), "
          "wire bytes == tally ✓")

    t = results[0].totals
    print("\nmeasured on the TCP wire (each of 4 processes agrees):")
    for phase in ("offline", "online"):
        print(f"  {phase:7s} {t[phase]['rounds']:3d} rounds  "
              f"{t[phase]['bits']:8d} bits")
    m = results[0].modeled_s
    print(f"modeled WAN wall-clock: offline {m['offline']:.2f} s, "
          f"online {m['online']:.2f} s "
          f"(rtt {WAN.default.rtt_s*1e3:.0f} ms, "
          f"{WAN.default.bandwidth_bps/1e6:.0f} Mbps)")
    print(f"single-machine: {max(r.wall_s for r in results):.1f} s/party, "
          f"{wall:.1f} s end-to-end (spawn + torch import dominated)")
    print("\nprediction sample (P1's reconstruction):")
    p1 = torch.from_numpy(np.asarray(results[1].result).view(np.int64))
    print(RING64.decode(p1)[:2].numpy())
    print("malicious checks passed:", not any(r.abort for r in results))
    return {"words": ref, "totals": t}


if __name__ == "__main__":
    main()
