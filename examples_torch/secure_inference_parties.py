"""Secure prediction end-to-end across four Party instances, on the port.

A small square-activation MLP (CryptoNets-style: matmul_tr -> square via
mult_tr -> matmul_tr) runs twice -- once on the joint simulation, once on
the party-sliced runtime -- and the script checks that

  * the reconstructed predictions are bit-identical between the backends,
  * the bytes/rounds measured on the LocalTransport equal the joint
    trace's analytic CostTally,

then serves a batch stream through PartyPredictionServer and prints the
measured per-link online traffic.

    PYTHONPATH=src python examples_torch/secure_inference_parties.py \
        [--device cpu]

Both worlds run on the card (``--device cuda``, the default; refused
without one) or on the CPU.
"""
import argparse

import numpy as np

from repro_torch.core import protocols as PR
from repro_torch.core.context import make_context, resolve_device
from repro_torch.core.ring import RING64
from repro_torch.runtime import FourPartyRuntime
from repro_torch.runtime import protocols as RT
from repro_torch.serve.party_server import PartyPredictionServer

rng = np.random.RandomState(0)
D, H, O, BATCH = 16, 8, 3, 8
W1 = rng.randn(D, H) * 0.3
W2 = rng.randn(H, O) * 0.3
X = rng.randn(BATCH, D)
STREAM = rng.randn(3 * BATCH, D)


def predict_joint(ctx, Xb):
    xs = PR.share(ctx, ctx.encode(Xb))
    w1 = PR.share(ctx, ctx.encode(W1))
    w2 = PR.share(ctx, ctx.encode(W2))
    h = PR.matmul_tr(ctx, xs, w1)
    a = PR.mult_tr(ctx, h, h)                      # square activation
    out = PR.matmul_tr(ctx, a, w2)
    return PR.reconstruct(ctx, out)


def predict_parties(rt, Xb):
    xs = RT.share(rt, rt.encode(Xb))
    w1 = RT.share(rt, rt.encode(W1))
    w2 = RT.share(rt, rt.encode(W2))
    h = RT.matmul_tr(rt, xs, w1)
    a = RT.mult_tr(rt, h, h)
    out = RT.matmul_tr(rt, a, w2)
    opened = RT.reconstruct(rt, out)
    # every receiver opened the same value; serve P1's copy
    return opened[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    # --- cross-check: joint simulation vs four parties on the wire -------
    ctx = make_context(RING64, seed=11, device=device)
    ref = predict_joint(ctx, X).cpu()

    rt = FourPartyRuntime(RING64, seed=11, device=device)
    got = predict_parties(rt, X).cpu()

    assert np.array_equal(ref.numpy(), got.numpy()), \
        "party-sliced != joint simulation"
    assert rt.transport.totals() == ctx.tally.totals(), \
        f"measured {rt.transport.totals()} != tally {ctx.tally.totals()}"
    assert not bool(rt.abort_flag()) and not bool(ctx.abort_flag())
    print("bit-identical predictions across backends ✓")
    print(f"measured == analytic tally ✓  {rt.transport.totals()}")
    plain = np.allclose(RING64.decode(got).numpy(), (X @ W1) ** 2 @ W2,
                        atol=0.05)
    print("plaintext check:", plain)

    # --- serve a query stream through the party runtime ------------------
    srv = PartyPredictionServer(
        lambda r, Xb: RING64.decode(predict_parties(r, Xb)),
        batch_size=BATCH, seed=11, device=device)
    try:
        for x in STREAM:
            srv.submit(x)
        preds = srv.flush()
        rep = srv.report()
    finally:
        srv.close()
    print(f"\nserved {len(preds)} queries in {srv.stats.batches} secure "
          f"batches")
    for k, v in rep.items():
        if k == "link_online_bits":
            print("  measured online bits per directed link:")
            for link, bits in v.items():
                print(f"    {link}: {bits}")
        else:
            print(f"  {k:24s} {v}")
    print("malicious checks passed:", not rep["aborted"])
    if not plain or rep["aborted"]:
        raise SystemExit("secure_inference_parties: a check failed")
    return {"words": got, "totals": rt.transport.totals(),
            "preds": np.stack([np.asarray(p) for p in preds]),
            "report": rep}


if __name__ == "__main__":
    main()
