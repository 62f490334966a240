"""End-to-end secure training driver (the paper's NN workload), on the
port.

Trains the paper's 784-128-128-10 network on MNIST-like data under the
full 4PC protocol stack with checkpointing; prints accuracy + the online
communication a real deployment would pay per iteration.

    PYTHONPATH=src python examples_torch/secure_training.py [--steps 300] \
        [--device cpu]

The joint simulation runs on the card (``--device cuda``, the default;
refused without one) or on the CPU.
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.context import make_context, resolve_device
from repro_torch.core.costs import LAN, WAN
from repro_torch.nn.engine import TridentEngine
from repro_torch.train import data as D
from repro_torch.train import paper_ml as PML
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--features", type=int, default=784)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "trident_nn_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    net = PML.MLPNet(features=args.features, layers=(128, 128, 10))
    data = D.MNISTLike(n=8192, seed=0, features=args.features)
    rng = np.random.RandomState(0)

    ctx = make_context(seed=0, device=device)
    eng = TridentEngine(ctx)
    params = {k: eng.from_plain(v)
              for k, v in PML.mlp_net_init(rng, net).items()}

    accs = []

    def step_fn(params, step, X, onehot, labels):
        new_params, probs = PML.mlp_net_step(
            eng, params, net, eng.from_plain(X), onehot, lr=0.25)
        acc = float(np.mean(np.argmax(
            eng.to_plain(probs).cpu().numpy(), -1) == labels))
        accs.append(acc)
        return new_params, 1.0 - acc, ctx.abort_flag()

    tr = Trainer(TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt,
                               ckpt_every=50), step_fn, params,
                 lambda s: data.batch(s, args.batch))
    t0 = time.time()
    tr.run()
    dt = time.time() - t0

    # per-iteration online cost of ONE iteration (fresh tally)
    c2 = make_context(seed=1, device=device)
    e2 = TridentEngine(c2)
    p2 = {k: e2.from_plain(v) for k, v in PML.mlp_net_init(rng, net).items()}
    X, onehot, _ = data.batch(0, args.batch)
    PML.mlp_net_step(e2, p2, net, e2.from_plain(X), onehot, 0.25)
    r, b = c2.tally.online.rounds, c2.tally.online.bits

    print(f"\ntrained {args.steps} secure iterations in {dt:.1f}s "
          f"(joint simulation on {device})")
    print(f"accuracy: first10={np.mean(accs[:10]):.3f} "
          f"last10={np.mean(accs[-10:]):.3f}")
    print(f"online cost/iter: {r} rounds, {b/8e6:.2f} MB "
          f"-> LAN {LAN.seconds(r, b)*1e3:.1f} ms, "
          f"WAN {WAN.seconds(r, b):.2f} s")
    print(f"events: {tr.events[-3:]}")
    ok = not ctx.abort_flag() and not c2.abort_flag()
    print("malicious checks passed:", ok)
    if not ok or not all(np.isfinite(tr.losses)):
        raise SystemExit("secure_training: a check failed")
    return {"accs": accs, "losses": tr.losses, "events": tr.events}


if __name__ == "__main__":
    main()
