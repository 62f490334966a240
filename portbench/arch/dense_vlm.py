"""The weights of a dense pre-norm decoder behind frontend embeddings (the
``dense_vlm`` reference): their leaves and init scales, and their layout
in the program's parameter tree and in the reference's.

A configuration names its layout and its reference by ``reference``; a
model of another kind adds a layout and a reference of its own."""
from __future__ import annotations

import math

# the leaves of a layer, stacked over the layers in one tensor each
STACKED = ("n1", "wq", "wk", "wv", "wo", "n2", "w_up", "w_gate", "w_down")
# the parameter groups the comparison holds apart, by leaf: attention's
# q and k, which make the scores the relu-softmax selects from, apart from
# its v and o
GROUPS = {"embed": "embed", "lm_head": "lm_head", "final_norm": "norms",
          "n1": "norms", "n2": "norms", "wq": "attn_scores",
          "wk": "attn_scores", "wv": "attn_values", "wo": "attn_values",
          "w_up": "mlp", "w_gate": "mlp", "w_down": "mlp"}
# the groups whose change over the checked steps is not compared: the
# truncations' noise alone moves q's and k's change by up to a quarter
# of its norm, as the reference shows against itself with a noise far
# below the program's (PERF.md); their first gradient is compared
CHANGE_NOT_COMPARED = ("attn_scores",)


def leaf_shapes(s: dict, embed_std: float) -> dict:
    """{leaf: (shape, std)} at the program's init scales: linear weights
    of d_in inputs N(0, 1/d_in), the lm_head N(0, 0.02^2), the embedding
    at `embed_std`, norms ones (std None)."""
    d, hd, f, v, n = s["d"], s["h"] * s["dh"], s["f"], s["v"], s["layers"]
    kd = s["hk"] * s["dh"]
    return {
        "embed": ((v, d), embed_std),
        "lm_head": ((d, v), 0.02),
        "final_norm": ((d,), None),
        "n1": ((n, d), None), "n2": ((n, d), None),
        "wq": ((n, d, hd), 1 / math.sqrt(d)),
        "wk": ((n, d, kd), 1 / math.sqrt(d)),
        "wv": ((n, d, kd), 1 / math.sqrt(d)),
        "wo": ((n, hd, d), 1 / math.sqrt(hd)),
        "w_up": ((n, d, f), 1 / math.sqrt(d)),
        "w_gate": ((n, d, f), 1 / math.sqrt(d)),
        "w_down": ((n, f, d), 1 / math.sqrt(f)),
    }


def program_tree(w: dict) -> dict:
    """The program's plain parameter tree: one segment of stacked attn_mlp
    layers (``repro_torch.nn.model.params_to_engine``'s input)."""
    return {"embed": {"table": w["embed"]},
            "final_norm": {"g": w["final_norm"]},
            "lm_head": {"w": w["lm_head"]},
            "segments": [{"n1": {"g": w["n1"]}, "n2": {"g": w["n2"]},
                          "attn": {k: w[k] for k in ("wq", "wk", "wv",
                                                     "wo")},
                          "mlp": {k: w[k] for k in ("w_up", "w_gate",
                                                    "w_down")}}]}


def program_leaves(tree: dict) -> dict:
    """{leaf: tensor} of a tree in the program's layout (its parameters,
    or an optimizer's state laid out alike)."""
    seg = tree["segments"][0]
    out = {"embed": tree["embed"]["table"],
           "final_norm": tree["final_norm"]["g"],
           "lm_head": tree["lm_head"]["w"],
           "n1": seg["n1"]["g"], "n2": seg["n2"]["g"]}
    out.update(seg["attn"])
    out.update(seg["mlp"])
    return out


def reference_tree(w: dict) -> dict:
    """The weights in the reference's layout (views, no copy)."""
    n = w["n1"].shape[0]
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "lm_head": w["lm_head"],
            "layers": [{k: w[k][i] for k in STACKED} for i in range(n)]}


def group(part: str) -> str:
    """The parameter group of a part (``leaf`` or ``leaf[i]``)."""
    return GROUPS[part.split("[")[0]]


def reference_parts(tree: dict) -> dict:
    """{part: tensor} of a tree in the reference's layout, a layer's leaf
    named ``leaf[i]``."""
    out = {k: tree[k] for k in ("embed", "final_norm", "lm_head")}
    for i, lp in enumerate(tree["layers"]):
        for k in STACKED:
            out[f"{k}[{i}]"] = lp[k]
    return out
