"""Analytic cost formulas from the paper (``repro/core/paper_costs.py``).

Tables I, II, IX, X of the paper give exact (rounds, bits) per protocol for
Trident ("this") and ABY3; Appendix E compares against Gordon et al.  The
executed ``CostTally`` of the joint simulation and the runtime's measured
traffic are held to these formulas, and the Trident-vs-ABY3 comparison
reads them.

All formulas are per element, in bits; ell = ring width, kappa = 128.
log = log2(ell).  d = vector length (dot product).
"""
from __future__ import annotations

import math

KAPPA = 128


def _log(ell: int) -> int:
    return int(math.log2(ell))


# (offline_rounds, offline_bits, online_rounds, online_bits) as callables of ell
TRIDENT = {
    "share":    lambda l: (0, 0, 1, 3 * l),
    "rec":      lambda l: (0, 0, 1, 4 * l),
    "mult":     lambda l: (1, 3 * l, 1, 3 * l),
    "dotp":     lambda l, d=1: (1, 3 * l, 1, 3 * l),   # independent of d
    "mult_tr":  lambda l: (2, 6 * l, 1, 3 * l),
    "a2b":      lambda l: (1, 3 * l * _log(l) + 2 * l,
                           1 + _log(l), 3 * l * _log(l) + l),
    "b2a":      lambda l: (2, 3 * l * l + l, 1, 3 * l),
    "bit2a":    lambda l: (2, 3 * l + 1, 1, 3 * l),
    "bitinj":   lambda l: (2, 6 * l + 1, 1, 3 * l),
    "bitext":   lambda l: (1, 4 * l + 1, 3, 5 * l + 2),
    "relu":     lambda l: (3, 8 * l + 2, 4, 8 * l + 2),
    "sigmoid":  lambda l: (3, 15 * l + 7, 5, 16 * l + 7),
    "g2b":      lambda l: (1, KAPPA + 1, 1, 3),
    "g2a":      lambda l: (1, l * KAPPA + l, 1, 3 * l),
    "b2g":      lambda l: (1, KAPPA, 1, KAPPA),
    "a2g":      lambda l: (1, l * KAPPA, 1, l * KAPPA),
}

# Implementation-exact formulas where our honest accounting differs from the
# paper's idealized tables by a documented delta:
#  * A2B: the paper counts the PPA at l*log(l) ANDs / log(l) depth (ABY3's
#    idealized convention).  A real Sklansky adder needs the initial
#    generate level g = x AND y too: +l gates (= +3l bits offline & online,
#    +1 online round).
#  * ReLU offline bits: paper Table X says 8l+2 but its own Lemma D.4
#    composes D.3 (4l+1) + C.11 (6l+1) = 10l+2; we match the lemmas.
#  * Sigmoid offline bits: Table X says 15l+7; composing the lemmas
#    (2x BitExt + AND + BitInj + Bit2A) gives 17l+7; we match the lemmas.
TRIDENT_IMPL = dict(TRIDENT)
TRIDENT_IMPL.update({
    "a2b":     lambda l: (1, 3 * l * (_log(l) + 1) + 2 * l,
                          2 + _log(l), 3 * l * (_log(l) + 1) + l),
    "relu":    lambda l: (3, 10 * l + 2, 4, 8 * l + 2),
    "sigmoid": lambda l: (3, 17 * l + 7, 5, 16 * l + 7),
})

ABY3 = {
    "mult":     lambda l: (1, 3 * l, 1, 9 * l),          # malicious
    "dotp":     lambda l, d=1: (1, 3 * l * d, 1, 9 * l * d),
    "mult_tr":  lambda l: (2 * l - 2, 96 * l - 84, 1, 12 * l),
    "a2b":      lambda l: (3, 12 * l * _log(l) + 12 * l,
                           1 + _log(l), 9 * l * _log(l) + 9 * l),
    "b2a":      lambda l: (3, 12 * l * _log(l) + 12 * l,
                           1 + _log(l), 9 * l * _log(l) + 9 * l),
    "bit2a":    lambda l: (1, 24 * l, 2, 18 * l),
    "bitinj":   lambda l: (1, 36 * l, 3, 27 * l),
    "bitext":   lambda l: (1, 24 * l * _log(l), _log(l), 18 * l * _log(l)),
    "relu":     lambda l: (3, 60 * l, 3 + _log(l), 45 * l),
    "sigmoid":  lambda l: (3, 108 * l + 12, 4 + _log(l), 81 * l + 9),
    "g2b":      lambda l: (1, 0, 1, KAPPA),
    "g2a":      lambda l: (1, 2 * l * KAPPA, 1, 2 * l * KAPPA),
    "b2g":      lambda l: (0, 0, 1, 2 * KAPPA),
    "a2g":      lambda l: (1, 3 * l * KAPPA, 1, 2 * l * KAPPA),
}

# ABY3 semi-honest (Appendix E-B): mult = 3 elements online, 1 round.
ABY3_SEMI = {
    "mult":    lambda l: (0, 0, 1, 3 * l),
    "dotp":    lambda l, d=1: (0, 0, 1, 3 * l * d),
    "mult_tr": lambda l: (2 * l - 2, 32 * l, 1, 4 * l),
}

# Gordon et al. 4PC (Appendix E-A): 4 elements online / mult, all four
# parties active online; total 6 elements.
GORDON = {
    "mult": lambda l: (1, 2 * l, 1, 4 * l),
}


def dotp_tr_cost(scheme: str, ell: int, d: int) -> tuple[int, int, int, int]:
    """Dot product of length d WITH truncation, per output element.

    Trident: communication independent of d (Pi_MultTr generalizes to dot
    products, Figs. 9/18).  ABY3 malicious: online 9*ell*d for the dot
    product + 3*ell for truncation; offline includes the (2*ell-2)-round RCA
    pair generation (Table X row MultTr, d features).
    """
    lg = _log(ell)
    if scheme == "trident":
        return (2, 6 * ell, 1, 3 * ell)
    if scheme == "aby3":
        return (2 * ell - 2, 96 * ell - 42 * d - 84, 1, 9 * ell * d + 3 * ell)
    if scheme == "aby3_semi":
        return (2 * ell - 2, 32 * ell, 1, 3 * ell + ell)
    raise ValueError(scheme)


def model_iteration_cost(scheme: str, ell: int, d: int, batch: int,
                         kind: str = "linreg",
                         layers: tuple = ()) -> tuple[int, int, int, int]:
    """(off_rounds, off_bits, on_rounds, on_bits) of one GD iteration,
    composed exactly as Section VI-A describes.

    linreg: fwd X@w (B dots of length d) + bwd X^T(err) (d dots of length B).
    logreg: linreg + sigmoid on B activations.
    nn/cnn: `layers` = (n0, n1, ...) widths; fwd/bwd matmuls + relu per
    hidden layer + smx at the output (division counted via the G-world).
    """
    table = {"trident": TRIDENT, "aby3": ABY3, "aby3_semi": ABY3_SEMI}[scheme]

    def op(name, n_out, d_len=1):
        if name == "dotp_tr":
            r = dotp_tr_cost(scheme, ell, d_len)
        else:
            f = table.get(name) or ABY3.get(name) if scheme != "trident" \
                else table[name]
            if f is None:
                f = TRIDENT[name]
            r = f(ell)
        return (r[0], r[1] * n_out, r[2], r[3] * n_out)

    ops = [op("dotp_tr", batch, d), op("dotp_tr", d, batch)]
    if kind == "logreg":
        ops.append(op("sigmoid", batch))
    if kind in ("nn", "cnn"):
        dims = (d,) + tuple(layers)
        for i in range(1, len(dims)):
            n_fwd = batch * dims[i]
            ops.append(op("dotp_tr", n_fwd, dims[i - 1]))       # fwd matmul
            if i < len(dims) - 1:
                ops.append(op("relu", n_fwd))
            ops.append(op("dotp_tr", batch * dims[i - 1], dims[i]))  # dX
            ops.append(op("dotp_tr", dims[i - 1] * dims[i], batch))  # dW
        # output smx: relu + garbled division on batch*out elements
        n_out = batch * dims[-1]
        ops.append(op("relu", n_out))
        ops.append(op("a2g", n_out))
        ops.append(op("g2a", n_out))
    # offline material generation is data-independent => fully parallel
    # (rounds = max); the online phase is the sequential gate depth.
    off_r = max((o[0] for o in ops), default=0)
    off_b = sum(o[1] for o in ops)
    on_r = sum(o[2] for o in ops)
    on_b = sum(o[3] for o in ops)
    return off_r, off_b, on_r, on_b
