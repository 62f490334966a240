#!/usr/bin/env python3
"""The port's collective estimate beside XLA's collectives, at SMOKE on a
2x2 mesh.

    PYTHONPATH=src python3 tools/torch_dryrun_vs_jax.py \
        [--archs qwen3_1_7b,mixtral_8x7b] [--batch 4] [--seq 8]

For each arch's SMOKE config cut to one layer (one encoder layer too: a
collective inside the layer loop appears once in the HLO text however
often the loop runs), each step kind (train, prefill) and fsdp off and
on, it compiles the JAX package's step (``repro.launch.steps``)
with the JAX package's sharding rules on a 2x2 ("data", "model") mesh of
fake host devices (this process sets ``XLA_FLAGS`` before it imports
JAX), reads the operand bytes of every collective in the optimized HLO
(``xla_by_op``: the JAX dry run's convention, operands looked up by
name), and prints them beside ``repro_torch.launch.roofline.
collective_terms`` for the same cell: the bytes per op and the ratio.
They need not agree: GSPMD picks its own collectives (it may gather an
activation where the port's rules count an all-reduce, or keep a product
whole); the ratio says how far the estimate is from one compiler's
choice.  CPU only; compiling takes most of its minutes.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import time  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import roofline as TRL  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


_DEF_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\(.*?\)|\S+)\s+"
                     r"([\w\-]+)\((.*?)\)")


def xla_by_op(compiled) -> dict:
    """Operand bytes of each collective kind in the optimized HLO.  This
    XLA prints operands by name only (``all-reduce(%dot)``), which the
    JAX dry run's own parser (``repro.launch.roofline.collective_bytes``)
    reads as 0 bytes; so each operand's bytes come from the shape of the
    instruction that defined it (the latest definition of the name)."""
    shapes, out = {}, {op: 0.0 for op in OPS}
    for line in compiled.as_text().splitlines():
        m = _DEF_RE.match(line)
        if not m:
            continue
        name, shape, op, operands = m.groups()
        shapes[name] = JRL._shape_bytes(shape)
        base = op[:-len("-start")] if op.endswith("-start") else op
        if base in out:
            out[base] += float(sum(
                shapes.get(o.strip().lstrip("%"), 0)
                for o in operands.split(",") if o.strip()))
    return out


def jax_cell(cfg, kind: str, batch: int, seq: int, fsdp: bool, mesh):
    params = JSP.param_specs(cfg)
    p_shard = JSP.param_shardings(cfg, mesh, fsdp=fsdp)
    ids = jax.ShapeDtypeStruct((batch, seq), jnp.int32)
    i_shard = JSP.fit_sharding(mesh, (batch, seq), P(("data",), None))
    extra, e_shard = None, None
    if cfg.family in ("vlm", "encdec"):
        extra = JSP._share_sds((batch, cfg.frontend_tokens, cfg.d_model),
                               jnp.uint64, True)
        e_shard = JSP._share_shard(mesh, ("data",), True, (None, None),
                                   (batch, cfg.frontend_tokens,
                                    cfg.d_model))
    fe, enc = (extra, None) if cfg.family == "vlm" else (None, extra)
    fe_s, enc_s = (e_shard, None) if cfg.family == "vlm" else (None,
                                                                e_shard)
    if kind == "train":
        step = JST.make_train_step(cfg, collapse=True)
        args = (params, ids, ids, fe, enc)
        shards = (p_shard, i_shard, i_shard, fe_s, enc_s)
    else:
        step = JST.make_prefill_step(cfg, collapse=True)
        args = (params, ids, fe, enc)
        shards = (p_shard, i_shard, fe_s, enc_s)
    t0 = time.time()
    with mesh:
        compiled = jax.jit(step, in_shardings=shards).lower(*args).compile()
    return xla_by_op(compiled), time.time() - t0


def one_layer(cfg):
    kw = {"n_layers": 1}
    if getattr(cfg, "n_encoder_layers", 0):
        kw["n_encoder_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def port_cell(arch: str, kind: str, batch: int, seq: int, fsdp: bool):
    cfg = one_layer(TC.get(arch).SMOKE)
    mesh = TMESH.Mesh((2, 2), ("data", "model"))
    terms = TRL.collective_terms(cfg, mesh, TSP.param_shardings(
        cfg, mesh, fsdp=fsdp), TSP.param_specs(cfg), kind, batch, seq, 8)
    out = {op: 0.0 for op in OPS}
    for t in terms:
        out[t["op"]] += t["bytes"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen3_1_7b,mixtral_8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    rows = []
    for arch in args.archs.split(","):
        for kind in ("train", "prefill"):
            for fsdp in (False, True):
                xla, secs = jax_cell(one_layer(JC.get(arch).SMOKE), kind,
                                     args.batch, args.seq, fsdp, mesh)
                port = port_cell(arch, kind, args.batch, args.seq, fsdp)
                tx, tp = sum(xla.values()), sum(port.values())
                row = {"arch": arch, "kind": kind, "fsdp": fsdp,
                       "xla": xla, "port": port, "xla_total": tx,
                       "port_total": tp,
                       "port_over_xla": tp / tx if tx else None,
                       "compile_s": secs}
                rows.append(row)
                ratio = row["port_over_xla"]
                print(f"{arch} {kind} fsdp={fsdp}: XLA {tx:.4g} B, port "
                      f"{tp:.4g} B, port/XLA "
                      f"{'-' if ratio is None else f'{ratio:.3f}'} "
                      f"(compiled in {secs:.0f} s)", flush=True)
                for op in OPS:
                    if xla[op] or port[op]:
                        print(f"    {op:18s} XLA {xla[op]:12.0f}  port "
                              f"{port[op]:12.0f}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
