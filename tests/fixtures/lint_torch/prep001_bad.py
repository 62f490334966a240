"""PREP001 negative fixture in the port's idiom: sampling outside the
prep.acquire seam.

Scanned with pretend-path runtime/protocols.py.  Six violations: a
grouped draw in a protocol body, torch's host RNG, a fresh torch
Generator, the JAX idiom's lone draw, a helper reachable from a public
entry that calls the PRF kernel's wrapper, and an in-place sampler.  The
JAX package's rule sees only the lone draw.
"""
import torch

from repro_torch.kernels import ops


def mult(rt, x, y):
    lam = rt.sample_group([((0, 1), x.shape)])[0]   # PREP001: online draw
    noise = torch.randint(0, 1 << 16, (1,))         # PREP001: host RNG
    gen = torch.Generator().manual_seed(7)          # PREP001: fresh seed
    r = rt.sample((0, 1), x.shape)                  # PREP001: (JAX's too)
    return _leak_helper(rt, x), lam, noise, gen, r


def _leak_helper(rt, x):
    return ops.lambda_masks_group(rt.keys, [x.shape])   # PREP001 via mult


def jitter(rt, x):
    return torch.empty(x.shape, dtype=torch.float64).uniform_()  # PREP001


def share(rt, v):
    def build():
        return rt.sample_group([((0, 1), v.shape)])  # OK: build
    return rt.prep.acquire(rt.next_tag("sh"), "pair", build)
