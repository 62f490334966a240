"""Roofline terms of a dry-run cell on a mesh of H100s
(``repro/launch/roofline.py``).

    compute term    = secure ring MACs x 36 limb-pair products x 2 ops
                      / (devices x the dense int8 tensor-core rate)
    memory term     = one device's arguments and outputs, each moved
                      once / HBM rate
    collective term = sum over the collectives the sharding implies of
                      their per-device operand bytes / the slowest link
                      their axis crosses

Hardware constants: NVIDIA H100 SXM5 data sheet, 3.35 TB/s HBM3 and
1,979 TOP/s dense int8 (the rates ``PERF.md`` §6 bounds the kernels by),
80 GB of HBM3.  A 64-bit ring MAC is 36 u8 x u8 limb-pair products on
the ``wgmma`` limb core (``kernels/csrc/limb_core.cuh``; the TPU route's
16-limb decomposition counts 136 MXU flops).  A secure matmul is 4 ring
products in the collapsed joint simulation (``mpc_matmul_fused``'s four
quadrants) and 16 in the faithful one (its component pairs).

There is no compiled program to read: the secure ring MACs come from the
model's MACs (``model_flops`` / 2, split evenly over the devices);
``model_flops`` and ``active_params`` are the JAX module's, unchanged.

The collective term is an ESTIMATE, as ROADMAP D3 says the memory is one:
the JAX dry run parses the collectives GSPMD put into the compiled HLO,
and the port, which runs eagerly and compiles nothing, counts the ones its
sharding rules imply (``collective_terms``), in JAX's convention: the
operand bytes of each all-gather, all-reduce, reduce-scatter and
all-to-all on one device.  Activations are 4-component shares of ring
words; a row-parallel product (model on the contracted dimension: ``wo``,
``w_down``, ``wout``, and the embedding lookup over a vocabulary split on
model) ends in one all-reduce over model of its output share a forward;
training adds the backward's all-reduce over model of each
column-parallel product's input gradient (``lm_head`` included); an FSDP
weight (data in its spec) is all-gathered over data once a forward and
once more in training (the backward, or the remat's re-forward), and its
gradient is reduce-scattered over data (then all-reduced over pod on the
2x16x16 mesh); without FSDP every weight gradient is all-reduced over
the data axes; MoE with experts over model makes two all-to-alls of its
routed tokens (tokens x top_k rows) a layer, two more in the backward.
Left out: the loss's reductions over a vocabulary split on model, and
whatever GSPMD would choose differently (``tools/
torch_dryrun_vs_jax.py`` prints the estimate beside XLA's own at SMOKE
on a 2x2 mesh).  The joint simulation's four components share a device:
their MPC traffic is the ``CostTally``, never a device collective.

Link rates, one direction a card: NVLink 4 within a node of 8 cards,
450 GB/s (H100 SXM5 data sheet: 900 GB/s bidirectional over 18 links);
across nodes one 400 Gb/s NDR InfiniBand adapter a card, 50 GB/s (HGX /
DGX H100: eight ConnectX-7 400 Gb/s ports for eight GPUs).
"""
from __future__ import annotations

import math

HBM_BW = 3.35e12             # bytes/s, H100 SXM5 HBM3
PEAK_INT8_OPS = 1979e12      # dense int8 tensor-core ops/s, H100 SXM5
HBM_BYTES = 80e9             # device memory, H100 80GB
NVLINK_BW = 450e9            # bytes/s a card, one way, NVLink 4 (H100 SXM5)
IB_BW = 50e9                 # bytes/s a card, 400 Gb/s NDR InfiniBand
LIMB_FACTOR_U64 = 36         # u8 limb-pair products per 64-bit ring MAC
PRODUCTS_PER_SECURE_MAC = {True: 4, False: 16}   # collapsed, faithful
SHARE_COMPONENTS = 4         # an activation share's components


def link_bw(mesh, axes) -> float:
    """The slowest link a collective over `axes` crosses, bytes/s."""
    return IB_BW if mesh.crosses_nodes(axes) else NVLINK_BW


def _ways(mesh, axes) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape[a] for a in axes)


def _on(axis: str, ent) -> bool:
    """Whether a spec entry names `axis`."""
    return ent == axis or (isinstance(ent, tuple) and axis in ent)


def _leaves(shardings, specs, path=()):
    """(path, Sharding, spec leaf) over a sharding tree and its specs."""
    if isinstance(shardings, dict):
        for k in sorted(shardings):
            yield from _leaves(shardings[k], specs[k], path + (k,))
    else:
        yield path, shardings, specs


def collective_terms(cfg, mesh, shardings: dict, specs: dict, kind: str,
                     batch: int, seq: int, word_bytes: int) -> list:
    """The collectives one step of `kind` makes on one device of `mesh`
    under the parameter `shardings` (``specs.param_shardings``) of the
    parameter `specs`: dicts of op, axes, what and operand bytes."""
    from .mesh import data_axes
    train = kind == "train"
    decode = kind not in ("train", "prefill")
    data = data_axes(mesh)
    dways = _ways(mesh, data)
    b_loc = batch // dways if batch % dways == 0 else batch
    front = cfg.frontend_tokens if cfg.family == "vlm" else 0
    dec_rows = b_loc if decode else b_loc * (seq + front)
    enc_rows = 0 if decode else b_loc * cfg.frontend_tokens
    terms = []

    def add(op, axes, what, nbytes):
        if nbytes and _ways(mesh, axes) > 1:
            terms.append({"op": op, "axes": axes, "what": what,
                          "bytes": float(nbytes)})

    def share(rows, width):
        return SHARE_COMPONENTS * rows * width * word_bytes

    def layer(where, shs, sps, pre, rows_of, times, gathers):
        """Each leaf's products (the 2-D weights past `pre` stack and
        component axes, on `rows_of(path)` rows; none without it), FSDP
        gathers and gradient reduction."""
        for path, sh, sp in _leaves(shs, sps):
            name = where + "/" + "/".join(path)
            shape = tuple(getattr(sp, "data", sp).shape)
            logical = sh.spec[pre:]
            if rows_of and len(logical) == 2 and path[0] != "moe":
                d_in, d_out = shape[-2:]
                if _on("model", logical[0]):        # row-parallel
                    add("all-reduce", "model", name + " out",
                        times * share(rows_of(path), d_out))
                elif train and _on("model", logical[1]):   # column
                    add("all-reduce", "model", name + " dx",
                        times * share(rows_of(path), d_in))
            nbytes = math.prod(sh.shard_shape(shape)) \
                * getattr(sp, "data", sp).element_size()
            if "data" in sh.axes():
                add("all-gather", "data", name + " w",
                    gathers * (2 if train else 1) * nbytes)
                if train:
                    add("reduce-scatter", "data", name + " dw",
                        nbytes * mesh.shape["data"])
                    if "pod" in mesh.axis_names:
                        add("all-reduce", "pod", name + " dw", nbytes)
            elif train:
                add("all-reduce", data, name + " dw", nbytes)

    # the embedding lookup (a vocabulary split on model) and the head
    if _on("model", shardings["embed"]["table"].spec[-2]):
        add("all-reduce", "model", "embed out", share(dec_rows, cfg.d_model))
    layer("embed", shardings["embed"], specs["embed"], 1, None, 1, 1)
    layer("final_norm", shardings["final_norm"], specs["final_norm"], 1,
          None, 1, 1)
    layer("lm_head", shardings["lm_head"], specs["lm_head"], 1,
          lambda _p: dec_rows if train else b_loc, 1, 1)
    kinds = [k for k, _ in cfg.segments()]
    uses = kinds.count("shared_attn")
    for i, (seg, count) in enumerate(cfg.segments()):
        if seg == "shared_attn" and i != kinds.index(seg):
            continue                       # the shared block: counted once
        shs = shardings["segments"][i] if seg != "shared_attn" else \
            shardings["shared_attn"]
        sps = specs["segments"][i] if seg != "shared_attn" else \
            specs["shared_attn"]

        def rows_of(path, seg=seg):
            if seg == "enc" or (path[0] == "xattn"
                                and path[1] in ("wk", "wv")):
                return enc_rows
            return dec_rows

        if seg == "shared_attn":
            layer(seg, shs, sps, 1, rows_of, uses, uses)
        else:                              # the encoder's kv is cached
            layer(seg, shs, sps, 2, rows_of, count,
                  0 if seg == "enc" and decode else 1)
        if "moe" in shs and _on("model", shs["moe"]["e_up"].spec[-3]):
            add("all-to-all", "model", f"{seg}/moe tokens",
                (4 if train else 2) * count
                * share(dec_rows * cfg.top_k, cfg.d_model))
    return terms


def collective_bytes(terms=()) -> float:
    """Per-device operand bytes of `terms` (``collective_terms``)."""
    return float(sum(t["bytes"] for t in terms))


def collective_seconds(mesh, terms=()) -> float:
    """Each term's bytes over the slowest link its axes cross."""
    return float(sum(t["bytes"] / link_bw(mesh, t["axes"]) for t in terms))


def model_flops(cfg, batch: int, seq: int, kind: str) -> float:
    """6*N*D (training) / 2*N*D (inference) with N = active params."""
    n_active = active_params(cfg)
    d_tokens = batch * seq if kind in ("train", "prefill") else batch
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * d_tokens


def active_params(cfg) -> float:
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    attn = d * H * dh + 2 * d * Hk * dh + H * dh * d
    if cfg.n_experts:
        ff = cfg.top_k * (3 if cfg.act == "swiglu" else 2) * d * f \
            + d * cfg.n_experts
    elif f:
        ff = (3 if cfg.act in ("swiglu", "sigmoid_glu") else 2) * d * f
    else:
        ff = 0
    if cfg.family == "ssm":
        r = cfg.ret_cfg()
        per = (2 * d * r.n_heads * r.d_k + 3 * d * r.n_heads * r.d_v
               + 4 * d * d) / 2
        core = L * per
    elif cfg.family == "hybrid":
        r = cfg.ret_cfg()
        ret = 2 * d * r.n_heads * r.d_k + 3 * d * r.n_heads * r.d_v
        core = L * ret + attn + ff        # shared attn counted once
    else:
        core = L * (attn + ff)
    return core + 2 * d * V


def roofline_terms(metrics: dict, cfg, batch: int, seq: int,
                   kind: str) -> dict:
    """The terms of one cell from its metrics (``devices``, ``collapse``,
    ``mem``'s per-device argument and output bytes, ``collective_s``)."""
    chips = metrics["devices"]
    mem = metrics["mem"]
    moved = (mem["argument_size_bytes"] or 0) + (mem["output_size_bytes"]
                                                  or 0)
    mf = model_flops(cfg, batch, seq, kind)
    ring_macs = mf / 2 * PRODUCTS_PER_SECURE_MAC[bool(metrics["collapse"])]
    terms = {"t_compute": None,
             "t_compute_limb": ring_macs * LIMB_FACTOR_U64 * 2
             / (chips * PEAK_INT8_OPS),
             "t_memory": moved / HBM_BW,
             "t_collective": metrics.get("collective_s", 0.0),
             "model_flops": mf, "ring_macs": ring_macs,
             "useful_ratio": None}
    terms["bottleneck"] = max(("t_compute_limb", "t_memory",
                               "t_collective"), key=lambda k: terms[k])
    return terms
