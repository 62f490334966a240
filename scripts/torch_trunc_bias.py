"""Measure the bias of the port's truncating protocols.

Runs ``truncate_share``, ``mult_tr`` (Pi_MultTr) and ``matmul_tr``
(Pi_MatMulTr) of ``repro_torch.runtime.protocols`` on random fixed-point
inputs on the CPU party runtime, and compares each output word with the
exact quotient ``v / 2^frac`` of the untruncated word ``v``.  Prints, for
each protocol, the mean error in units of 2^-frac (one ulp of the output)
and how the output falls against ``floor(v / 2^frac)``, as one JSON
object.

    PYTHONPATH=src python scripts/torch_trunc_bias.py [--n 65536] [--seed 0]

Every word is independent of the others' masks only through the runtime's
PRF draws, so one call on n words samples the protocol's error n times.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from repro_torch.core.ring import RING64
from repro_torch.runtime import FourPartyRuntime
from repro_torch.runtime import protocols as RT


def _stats(out: torch.Tensor, v: torch.Tensor, frac: int) -> dict:
    """Error of `out` against v / 2^frac, in ulps; `v` is exact (int64)."""
    fl = torch.div(v, 1 << frac, rounding_mode="floor")
    rem = (v - fl * (1 << frac)).to(torch.float64) / (1 << frac)
    off = (out - fl).to(torch.int64)             # out - floor(v / 2^frac)
    err = off.to(torch.float64) - rem            # out - v / 2^frac
    vals, counts = torch.unique(off, return_counts=True)
    n = out.numel()
    return {"n": n,
            "mean_err_ulp": float(err.mean()),
            "std_err_ulp": float(err.std()),
            "stderr_of_mean_ulp": float(err.std()) / math.sqrt(n),
            "min_err_ulp": float(err.min()), "max_err_ulp": float(err.max()),
            "out_minus_floor": {int(a): int(c) / n
                                for a, c in zip(vals.tolist(),
                                                counts.tolist())}}


def measure(n: int, seed: int) -> dict:
    ring = RING64
    rt = FourPartyRuntime(ring, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)

    def share(words):
        return RT.share(rt, rt.words(words))

    def opened(x):
        return RT.reconstruct(rt, x)[1]

    res = {}
    # a lone truncation of words at scale 2^(2 frac), as a product leaves
    v = torch.from_numpy(rng.randint(-(1 << 40), 1 << 40, size=n,
                                     dtype=np.int64))
    res["truncate_share"] = _stats(opened(RT.truncate_share(rt, share(v))),
                                   v, ring.frac)
    # Pi_MultTr on fixed-point values in [-4, 4)
    x = ring.encode(rng.uniform(-4, 4, n))
    y = ring.encode(rng.uniform(-4, 4, n))
    res["mult_tr"] = _stats(opened(RT.mult_tr(rt, share(x), share(y))),
                            x * y, ring.frac)
    # Pi_MatMulTr at the backward pass's contraction (K = 128)
    k = 128
    m = max(1, n // 64)
    a = ring.encode(rng.uniform(-1, 1, (m, k)))
    b = ring.encode(rng.uniform(-1, 1, (k, 64)))
    res["matmul_tr"] = _stats(opened(RT.matmul_tr(rt, share(a), share(b))),
                              a @ b, ring.frac)
    if rt.abort_flag():
        raise SystemExit("the runtime's malicious checks failed")
    return {"ring_ell": ring.ell, "frac": ring.frac, "seed": seed,
            "protocols": res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n, args.seed), indent=1))


if __name__ == "__main__":
    main()
