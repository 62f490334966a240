"""Loop helpers of the model stack (``repro/nn/recurrent.py``): the
leaf/wrap plumbing of its layer and chunk loops, the per-layer PRF keys,
the checks of a loop body, and ``scan_loop``, which runs a loop body with
the semantics of the JAX package's ``lax.scan``.  A loop body indexes its
inputs itself, so the JAX package's scan-layout moves (``_scan_leaf``,
``_unscan_leaf``) and its null scope for the plain engine (``_scan_ctx``)
have no counterpart here.

A ``lax.scan`` body is traced ONCE.  So every iteration draws the same PRF
counters ``c0 .. c0 + k - 1``, each under its own key (``ctx.scan_keys``
with the iteration's ``_layer_keys`` key), and the counter stands at
``c0 + k`` after the loop; the body's tally counts once, scaled by the
iteration count; the body's checks leave it folded into one boolean an
iteration.  ``scan_loop`` runs the body once an iteration and reproduces
all three: it sets the counter back to ``c0`` before each iteration,
tallies the first iteration scaled by the count and the others not at
all, and folds each iteration's checks.  A loop that kept counting would
draw other words from the second iteration on.

The recurrent blocks themselves (retention, sLSTM) are not ported yet.
"""
from __future__ import annotations

import zlib

import torch

from ..core.shares import AShare
from .engine import TridentEngine


def _is_triv(eng) -> bool:
    return isinstance(eng, TridentEngine)


def _leaf(eng, x):
    """Engine tensor -> raw tensor (a share's (4, ...) stack)."""
    return x.data if _is_triv(eng) else x


def _wrap(eng, x):
    """Raw tensor -> engine tensor."""
    return AShare(x) if _is_triv(eng) else x


def _checks_begin(eng):
    return eng.ctx.ledger.begin_body() if _is_triv(eng) else 0


def _checks_end(eng, mark):
    return eng.ctx.ledger.end_body(mark) if _is_triv(eng) else None


def _checks_absorb(eng, oks) -> None:
    if _is_triv(eng) and eng.ctx.malicious_checks:
        eng.ctx.ledger.absorb(oks)


def _layer_keys(eng, n: int, tag: str) -> list:
    """Per-iteration PRF keys of a loop: ``split(fold_in(master,
    crc32(tag)), n)``, the JAX package's for the same tag."""
    if not _is_triv(eng):
        return [None] * n
    tid = zlib.crc32(tag.encode()) & 0x7FFFFFFF
    return eng.ctx.keys.master.fold_in(tid).split(n)


def scan_loop(eng, n: int, tag: str, body, carry=None):
    """``lax.scan`` of ``body(carry, i) -> (carry, out)`` over i < n, as
    the JAX package traces it (module docstring); returns (carry, [out for
    each i]).  On the plain engine a plain loop."""
    if not _is_triv(eng):
        outs = []
        for i in range(n):
            carry, out = body(carry, i)
            outs.append(out)
        return carry, outs
    ctx = eng.ctx
    keys = _layer_keys(eng, n, tag)
    c0 = ctx._counter
    outs, oks = [], []
    for i in range(n):
        ctx._counter = c0
        mark = _checks_begin(eng)
        with ctx.tally.scaled(n if i == 0 else 0), ctx.scan_keys(keys[i]):
            carry, out = body(carry, i)
        oks.append(_checks_end(eng, mark))
        outs.append(out)
    _checks_absorb(eng, oks)
    return carry, outs


def stack_outs(outs: list, dim: int = 0):
    """Loop outputs (tensors, or dicts and lists of them) stacked along a
    new axis `dim`, leaf by leaf (``lax.scan``'s ys)."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: stack_outs([o[k] for o in outs], dim) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_outs([o[i] for o in outs], dim)
                           for i in range(len(first)))
    return torch.stack(outs, dim)
