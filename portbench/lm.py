"""The language model of a configuration file: the program's model
config, the weights made from the seed on the card, the same weights in
the program's tree and in the reference's, and the program's state read
back for the check.

The weights are drawn in one call of a generator on the device, in
float64, at the program's init scales.  A layer's leaves lie stacked
in one buffer, as the program's segment layout wants them, so neither side
copies them.  The leaves and both sides' layouts are the configuration's
``arch/<reference>.py``.
"""
from __future__ import annotations

import math

import torch

def sizes(cfg: dict) -> dict:
    """The model's widths under short names, from the configuration's
    published keys."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return {"d": d, "h": h, "hk": cfg["num_key_value_heads"],
            "dh": cfg.get("head_dim") or d // h,
            "f": cfg["intermediate_size"], "v": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"],
            "front": cfg["frontend_tokens"]}


def ref_cfg(cfg: dict) -> dict:
    s = sizes(cfg)
    return {"n_heads": s["h"], "d_head": s["dh"],
            "rope_theta": float(cfg["rope_theta"])}


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.nn.model import ModelConfig
    s = sizes(cfg)
    run = cfg["program"]
    kw = dict(name=cfg["name"], family=run["family"], n_layers=s["layers"],
              d_model=s["d"], n_heads=s["h"], n_kv_heads=s["hk"],
              d_head=s["dh"], d_ff=s["f"], vocab=s["v"], act=run["act"],
              frontend=run["frontend"], frontend_tokens=s["front"],
              rope_theta=float(cfg["rope_theta"]), seq_chunk=run["seq_chunk"],
              q_chunk=run["q_chunk"], remat=run["remat"])
    return ModelConfig(**kw)


def layout(cfg: dict):
    """The module of the configuration's weight layout,
    ``arch/<reference>.py``."""
    from portbench import harness
    return harness.load_module(harness.BENCH / "arch"
                               / f"{cfg['reference']}.py")


def reference(cfg: dict):
    """The configuration's plain reference, ``reference/<reference>.py``."""
    from portbench import harness
    return harness.load_module(harness.BENCH / "reference"
                               / f"{cfg['reference']}.py")


def leaf_shapes(cfg: dict) -> dict:
    return layout(cfg).leaf_shapes(sizes(cfg), cfg["embed_std"])


def part_names(cfg: dict) -> list:
    """The parts the comparison reads: each leaf, a stacked one by layer."""
    stacked = layout(cfg).STACKED
    return [f"{k}[{i}]" if k in stacked else k
            for k, (shape, _) in leaf_shapes(cfg).items()
            for i in range(shape[0] if k in stacked else 1)]


def parameter_count(cfg: dict) -> int:
    return sum(math.prod(shape) for shape, _ in leaf_shapes(cfg).values())


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{leaf: float64 tensor} from the seed: one draw of every random leaf
    on `device`, scaled in place; norms ones."""
    shapes = leaf_shapes(cfg)
    rand = {k: v for k, v in shapes.items() if v[1] is not None}
    total = sum(math.prod(shape) for shape, _ in rand.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.float64,
                       device=device)
    out, off = {}, 0
    for k, (shape, std) in rand.items():
        n = math.prod(shape)
        out[k] = flat[off:off + n].view(shape).mul_(std)
        off += n
    for k, (shape, std) in shapes.items():
        if std is None:
            out[k] = torch.ones(shape, dtype=torch.float64, device=device)
    return out


def program_tree(cfg: dict, w: dict) -> dict:
    return layout(cfg).program_tree(w)


def reference_tree(cfg: dict, w: dict) -> dict:
    return layout(cfg).reference_tree(w)


def program_parts(cfg: dict, eng, tree: dict) -> dict:
    """{part: float64 tensor} of a tree in the program's layout read back
    (its parameters, or an optimizer's state), a stacked leaf by layer.
    A generator: each part is read as it is asked for."""
    lay = layout(cfg)
    for name, t in lay.program_leaves(tree).items():
        stacked = name in lay.STACKED
        x = open_leaf(eng, t, stacked)
        if stacked:
            for i in range(x.shape[0]):
                yield f"{name}[{i}]", x[i]
        else:
            yield name, x


def open_leaf(eng, t, stacked: bool):
    """A leaf of the program's state read back as float64 (a stacked
    segment leaf's share data is (n, 4, ...))."""
    from repro_torch.core.shares import AShare
    if isinstance(t, AShare) and stacked:
        t = AShare(torch.movedim(t.data, 0, 1))
    return eng.to_plain(t)


def reference_parts(cfg: dict, tree: dict) -> dict:
    return layout(cfg).reference_parts(tree)


def engine(cfg: dict, seed: int, device, ring_bits: int | None = None):
    """The program's secure engine over a fresh context from the seed:
    Trident shares of Z_2^ring_bits (the configuration's unless given),
    faithful."""
    from repro_torch.core.context import make_context
    from repro_torch.core.ring import Ring
    from repro_torch.nn.engine import TridentEngine
    run = cfg["program"]
    ring = Ring(ell=ring_bits or run["ring_bits"], frac=run["frac_bits"])
    return TridentEngine(make_context(ring, seed=seed, device=device))


def feed_generator(seed: int, i: int, device):
    """The generator of input i (a step's batch, a request) of a run: the
    same seed and index give the same input."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + 7_919 * (i + 1)) % (1 << 63))
    return gen


def frontend(cfg: dict, gen, batch: int, device):
    """Patch embeddings of one image a row, N(0, 0.5^2), float64."""
    s = sizes(cfg)
    return torch.randn((batch, s["front"], s["d"]), generator=gen,
                       dtype=torch.float64, device=device) * 0.5


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
