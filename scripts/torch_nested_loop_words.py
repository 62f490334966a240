"""Show that a loop nested in a loop body draws the same PRF words in
every outer iteration (ROADMAP N2).

``scan_loop`` reproduces a JAX ``lax.scan``: each iteration runs under its
own key from ``_layer_keys(eng, n, tag)``, which derives the keys from the
context's master key and the loop's tag, and restarts at the counter the
loop began with.  A loop inside a loop body therefore takes the same keys
(master, tag) and the same counters in every outer iteration: its draws
repeat.  This runs an outer loop "inf_retention" of 2 iterations, each
drawing once and then running an inner loop "ret_fwd" of 2 iterations
that draw once each (``ctx.sample((0, 1, 2), (3,))``), on the port's
joint context on the CPU, and prints every draw's words and whether the
outer and the inner draws repeat, as one JSON object.  With ``--jax`` it
runs the same program as nested ``lax.scan`` bodies on the JAX package's
context and asserts the same words.

    PYTHONPATH=src python scripts/torch_nested_loop_words.py [--seed 5]
        [--jax]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core.context import make_context
from repro_torch.core.ring import RING64, words_to_numpy
from repro_torch.nn import recurrent as R
from repro_torch.nn.engine import TridentEngine

SUBSET, SHAPE = (0, 1, 2), (3,)


def port_draws(seed: int) -> dict:
    eng = TridentEngine(make_context(RING64, seed=seed, device="cpu"))
    ctx = eng.ctx
    draws = {"outer": [], "inner": []}

    def inner(carry, j):
        draws["inner"].append(words_to_numpy(ctx.sample(SUBSET, SHAPE)))
        return carry, None

    def outer(carry, i):
        draws["outer"].append(words_to_numpy(ctx.sample(SUBSET, SHAPE)))
        R.scan_loop(eng, 2, "ret_fwd", inner)
        return carry, None

    R.scan_loop(eng, 2, "inf_retention", outer)
    return draws


def jax_draws(seed: int) -> dict:
    import jax
    from repro.core.context import make_context as jmake
    from repro.core.ring import RING64 as J64
    from repro.nn import recurrent as JR
    from repro.nn.engine import TridentEngine as JEngine
    eng = JEngine(jmake(J64, seed=seed))
    ctx = eng.ctx

    def inner(carry, key):
        with ctx.scan_keys(key):
            return carry, ctx.sample(SUBSET, SHAPE)

    def outer(carry, key):
        with ctx.scan_keys(key):
            o = ctx.sample(SUBSET, SHAPE)
            _, ys = jax.lax.scan(inner, 0, JR._layer_keys(eng, 2, "ret_fwd"))
        return carry, (o, ys)

    _, (o, ys) = jax.lax.scan(outer, 0,
                              JR._layer_keys(eng, 2, "inf_retention"))
    return {"outer": list(np.asarray(o)),
            "inner": list(np.asarray(ys).reshape(4, *SHAPE))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    d = port_draws(args.seed)
    # inner draws in order: outer 0's chunks 0 and 1, then outer 1's
    out = {
        "seed": args.seed,
        "outer_words": [w.view(np.int64).tolist() for w in d["outer"]],
        "inner_words": [w.view(np.int64).tolist() for w in d["inner"]],
        "outer_draws_equal": bool(np.array_equal(*d["outer"])),
        "inner_chunk0_equal_across_outer": bool(
            np.array_equal(d["inner"][0], d["inner"][2])),
        "inner_chunk1_equal_across_outer": bool(
            np.array_equal(d["inner"][1], d["inner"][3]))}
    if args.jax:
        j = jax_draws(args.seed)
        out["jax_words_equal"] = all(
            np.array_equal(a, b) for k in ("outer", "inner")
            for a, b in zip(d[k], j[k]))
        assert out["jax_words_equal"], "the JAX package draws other words"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
