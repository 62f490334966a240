"""Tour: train + decode a (reduced) assigned architecture under 4PC, on
the port.

    PYTHONPATH=src python examples_torch/transformer_tour.py \
        --arch qwen3-1.7b [--steps 2] [--device cpu]

The collapsed joint simulation runs on the card (``--device cuda``, the
default; refused without one) or on the CPU.
"""
import argparse

import numpy as np

from repro_torch import configs as CFGS
from repro_torch.core.context import make_context, resolve_device
from repro_torch.core.costs import LAN, WAN
from repro_torch.nn import model as M
from repro_torch.nn.engine import TridentEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b",
                    help=f"one of {sorted(CFGS.ALIASES)}")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (refused without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    cfg = CFGS.get(args.arch).SMOKE
    print(f"arch {args.arch} (reduced config: {cfg.n_layers}L "
          f"d={cfg.d_model} {cfg.family})")
    rng = np.random.RandomState(0)
    ctx = make_context(seed=0, collapse=True, device=device)
    eng = TridentEngine(ctx)
    params = M.params_to_engine(eng, M.init_params(cfg, seed=0))

    B, S = 2, 8
    kw = {}
    if cfg.family == "vlm":
        kw["frontend_embs"] = eng.from_plain(
            rng.randn(B, cfg.frontend_tokens, cfg.d_model) * 0.1)
    if cfg.family == "encdec":
        kw["enc_inputs"] = eng.from_plain(
            rng.randn(B, cfg.frontend_tokens, cfg.d_model) * 0.1)
    losses = []
    for step in range(args.steps):
        ids = rng.randint(0, cfg.vocab, (B, S))
        labels = rng.randint(0, cfg.vocab, (B, S))
        params, loss, _ = M.train_step(eng, cfg, params, ids, labels,
                                       lr=2.0 ** -6, **kw)
        losses.append(float(loss))
        print(f"  step {step}: loss {float(loss):.4f}  "
              f"abort={bool(ctx.abort_flag())}")

    tok = None
    if cfg.family not in ("encdec", "vlm"):
        ids = rng.randint(0, cfg.vocab, (B, S + 1))
        _, caches = M.serve_prefill(eng, cfg, params, ids[:, :S])
        logits, _ = M.serve_decode(eng, cfg, params, ids[:, S:], caches,
                                   pos=S)
        tok = np.argmax(eng.to_plain(logits).cpu().numpy()[:, 0], -1)
        print(f"  decoded next tokens: {tok}")

    r, b = ctx.tally.online.rounds, ctx.tally.online.bits
    print(f"total online: {r} rounds, {b/8e6:.2f} MB "
          f"(LAN {LAN.seconds(r, b)*1e3:.0f} ms / "
          f"WAN {WAN.seconds(r, b):.1f} s)")
    ok = not bool(ctx.abort_flag())
    print("malicious checks passed:", ok)
    if not ok or not all(np.isfinite(losses)):
        raise SystemExit("transformer_tour: a check failed")
    return {"losses": losses, "tokens": tok}


if __name__ == "__main__":
    main()
