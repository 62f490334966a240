"""The numbers that decide ``correct``, each held to its limit in
``limits/<workload>.json``.

Training, from the program's state and the reference's, leaf by leaf (a
stacked leaf by layer); a leaf's gap is the gap between the program's
norm and the reference's over the larger of the reference's norm of that
leaf and the median leaf's:

- ``grad_gap.<group>``: the first step's gradient as the optimizer got
  it, read from its state after one step: the worst leaf of each
  parameter group (the configuration's layout names them: the embedding,
  the lm_head, the norms, attention's q and k, its v and o, the MLP's
  weights);
- ``change_gap.<group>``: the parameters' change after the checked
  steps, the worst leaf of each group but those the layout names in
  ``CHANGE_NOT_COMPARED``: attention's q and k, whose change after three
  steps the truncations' noise alone moves by up to a quarter of its
  norm, in the program as in the reference run against itself with a
  smaller noise (PERF.md).

Leaves whose reference norm is below a thousandth of the median leaf's
are nought to rounding and left out (a rule on the reference, not on
names).  The loss is not compared: neither the control nor a fault moves
it off the sound runs' readings (PERF.md).

Serving, over every served position of the checked requests:
``logit_gap``, the widest gap by which a served token's logit lies below
the reference's best at its position; ``logit_err``, the largest gap
between a logit the program served (opened to the client) and the
reference's.
"""
from __future__ import annotations

import statistics

NOUGHT = 1e-3


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{leaf: |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)}, leaves nought
    to rounding left out."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()
            if r >= NOUGHT * med}


def worst_by_group(gaps: dict, group, prefix: str, skip=()) -> dict:
    out = {}
    for k, g in gaps.items():
        if group(k) not in skip:
            key = f"{prefix}.{group(k)}"
            out[key] = max(out.get(key, 0.0), g)
    return out


def train_numbers(grad_prog, grad_ref, chg_prog, chg_ref, group,
                  skip_change=()) -> dict:
    """The training numbers; `group` names a leaf's parameter group,
    `skip_change` the groups whose change is not compared."""
    return {**worst_by_group(leaf_gaps(grad_prog, grad_ref), group,
                             "grad_gap"),
            **worst_by_group(leaf_gaps(chg_prog, chg_ref), group,
                             "change_gap", skip_change)}


def token_gaps(ref_logits, tokens) -> list:
    """Per served token: the reference's best logit at its position less
    the reference's logit of the token (ref_logits (n, V), tokens n)."""
    import torch
    t = torch.as_tensor(tokens, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, t[:, None])[:, 0]
    return (best - got).tolist()


def serve_numbers(gaps: list, err: float) -> dict:
    return {"logit_gap": max(g for r in gaps for g in r), "logit_err": err}
