"""Batched secure prediction serving (paper Section VI-B), on the port.

    PYTHONPATH=src python examples_torch/secure_inference.py [--device cpu]

Each batch runs the joint simulation on a fresh context on the card
(``--device cuda``, the default; refused without one) or the CPU.
"""
import argparse

import numpy as np

from repro_torch.core.context import resolve_device
from repro_torch.nn.engine import TridentEngine
from repro_torch.serve.engine import PredictionServer
from repro_torch.train import data as D
from repro_torch.train import paper_ml as PML


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    rng = np.random.RandomState(0)
    net = PML.MLPNet(features=64, layers=(32, 10))
    params_np = PML.mlp_net_init(rng, net)
    data = D.MNISTLike(n=512, seed=1, features=64)

    def predict(ctx, X):
        eng = TridentEngine(ctx)
        params = {k: eng.from_plain(v) for k, v in params_np.items()}
        p, _ = PML.mlp_net_fwd(eng, params, net, eng.from_plain(X))
        return eng.to_plain(p)

    srv = PredictionServer(predict, batch_size=32, device=device)
    X, _, labels = data.batch(0, 96)
    for x in X:
        srv.submit(x)
    preds = srv.flush()
    print(f"served {len(preds)} queries in {srv.stats.batches} secure "
          f"batches")
    for k, v in srv.report().items():
        print(f"  {k:22s} {v:.4g}")
    print("malicious checks passed:", not srv.stats.aborted)
    if srv.stats.aborted or len(preds) != 96:
        raise SystemExit("secure_inference: a batch aborted or was lost")
    return {"preds": np.stack([np.asarray(p) for p in preds]),
            "report": srv.report()}


if __name__ == "__main__":
    main()
