"""PREP001 clean fixture in the port's idiom: every sanctioned sampling
context with the port's samplers.

Scanned with pretend-path runtime/protocols.py; must produce no
PREP001 findings.
"""
import torch

from repro_torch.kernels import ops


def mult(rt, x, y):
    def build():
        return rt.sample_group([((0, 1), x.shape)]), _offline_half(rt, x)
    lam = rt.prep.acquire(rt.next_tag("mul"), "triple", build)
    return lam


def _offline_half(rt, x):
    # drawn only from builds: build-only helper (fixpoint context)
    return ops.lambda_masks_group(rt.keys, [x.shape])


def bit_extract(rt, x):
    if rt.prep.consuming:
        lam = rt.prep.acquire(rt.next_tag("bx"), "pair", lambda: None)
    else:
        lam = rt.sample_group([((0, 1), x.shape)])[0]   # consuming guard
    return lam


def share(rt, v):
    return rt.prep.acquire(
        rt.next_tag("sh"), "pair",
        lambda: torch.randint(0, 7, v.shape,
                              generator=torch.Generator().manual_seed(1)))
