"""Quickstart: the Trident 4PC protocol suite in 20 lines, on the port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The joint simulation runs on the card (``--device cuda``, the default;
refused without one) or on the CPU (``--device cpu``).
"""
import argparse

import numpy as np

from repro_torch.core import activations as ACT
from repro_torch.core import protocols as PR
from repro_torch.core.context import make_context, resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    ctx = make_context(seed=0, device=device)  # F_setup keys + cost tally
    ring = ctx.ring                      # Z_2^64, 13 fractional bits

    # --- secret-share two private matrices (Pi_Sh) ----------------------
    A = np.random.RandomState(0).randn(4, 6)
    B = np.random.RandomState(1).randn(6, 3)
    a, b = PR.share(ctx, ctx.encode(A)), PR.share(ctx, ctx.encode(B))

    # --- secure matmul with free truncation (Pi_MatMulTr, Fig. 18) ------
    c = PR.matmul_tr(ctx, a, b)

    # --- secure comparison + ReLU (Fig. 19 + BitInj) --------------------
    r = ACT.relu(ctx, c)

    # --- reconstruct (Pi_Rec) --------------------------------------------
    opened = PR.reconstruct(ctx, r)
    result = ring.decode(opened).cpu().numpy()
    print("secure relu(A @ B) =\n", result.round(3))
    print("max |err| vs plaintext:",
          float(np.abs(result - np.maximum(A @ B, 0)).max()))
    print("\nMPC communication this program would send (per the paper's"
          " accounting):")
    print(ctx.tally.summary())
    ok = not bool(ctx.abort_flag())
    print("\nmalicious checks passed:", ok)
    if not ok:
        raise SystemExit("quickstart: a malicious check failed")
    return {"opened": opened.cpu(), "summary": ctx.tally.summary(),
            "ok": ok}


if __name__ == "__main__":
    main()
