"""Dry run of every (arch x shape) cell on a mesh of H100s
(``repro/launch/dryrun.py``).

The JAX module lowers and compiles each cell's step for the 16x16 or
2x16x16 mesh and reads the compiler's memory and cost analyses per
device.  The port runs eagerly and has no compiler to ask, so a cell here
is sized from the abstract specs and the sharding rules (``specs.py``:
meta tensors, no memory and no device touched) on an abstract
``mesh.Mesh``: one device's argument bytes (the sum of each parameter's,
input's and cache's shard, which is what JAX's ``memory_analysis().
argument_size_in_bytes`` reports), its output bytes (a train step's new
params laid out as the params, its loss replicated; a serve step's
last-token logits with the batch over the data axes, and the caches, a
decode step's one position longer, as ``decode_cache_shardings`` lays
them), whether they fit one card's 80 GB, the collectives the sharding
implies (``roofline.collective_terms``, an estimate) and the roofline
terms.  ``fsdp`` (big archs by default, as JAX picks it) shards the big
weights over data too.  The keys only a compile gives (``lower_s``,
``compile_s``, ``flops``, ``bytes_accessed``, ``temp_size_bytes``,
``generated_code_size_bytes``) are None, and ``fits`` leaves the
temporaries out (ROADMAP D3).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--multi-pod] [--collapse] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 1xH100

The mesh is 16x16 unless ``--multi-pod`` (2x16x16) or ``--mesh`` says
otherwise.  ``--mesh 1xH100`` (``run_cell(..., mesh="1xH100")``) sizes a
cell whole on one card, as the launcher runs it (ROADMAP D5).  ``--all``
covers the 40 cells of ``configs.cells()``: the 33 it runs are sized, the
7 it skips (``long_500k`` of a full-attention arch) recorded as skipped.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import configs as CFGS
from ..core.ring import RING64
from . import roofline as RL
from . import specs as SP
from .mesh import ONE_CARD, data_axes, make_production_mesh, mesh_named

# the keys the JAX dry run reads from the compiled program
COMPILER_ONLY = ("lower_s", "compile_s", "flops", "bytes_accessed")
MESHES = ("16x16", "2x16x16", ONE_CARD.name)


def output_specs(cfg, seq: int, batch: int, kind: str, ring) -> list:
    """What the cell's step returns, as meta tensors."""
    if kind == "train":
        return [SP.param_specs(cfg, ring),
                torch.empty((), dtype=torch.float64, device=SP.META)]
    logits = SP._share((batch, 1, cfg.vocab), ring, True)
    positions = seq if kind == "prefill" else seq + 1
    return [logits, SP.decode_cache_specs(cfg, batch, positions, ring=ring,
                                          long_ctx=kind == "long_decode")]


def output_shardings(cfg, mesh, seq: int, batch: int, kind: str,
                     p_shard) -> list:
    """How ``output_specs`` lies on `mesh` (JAX lets its compiler choose;
    the port lays each output as its input counterpart)."""
    if kind == "train":
        return [p_shard, SP.Sharding(mesh, ())]
    bdims = data_axes(mesh)
    logits = SP._share_shard(mesh, bdims, True, (None, None),
                             (batch, 1, cfg.vocab))
    positions = seq if kind == "prefill" else seq + 1
    return [logits, SP.decode_cache_shardings(
        cfg, mesh, bdims, batch=batch, seq=positions,
        long_ctx=kind == "long_decode")]


def resolve_mesh(mesh=None, multi_pod: bool = False):
    """A Mesh from `mesh` (a Mesh or its name) or the production layout."""
    if mesh is None:
        return make_production_mesh(multi_pod=multi_pod)
    return mesh_named(mesh) if isinstance(mesh, str) else mesh


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             collapse: bool = False, verbose: bool = True,
             fsdp: bool | None = None, ring=None, cfg=None,
             dims: tuple | None = None, mesh=None) -> dict:
    """Size one (arch, shape) cell per device on the 16x16 mesh, or
    2x16x16 with `multi_pod`, or `mesh` (a ``mesh.Mesh`` or its name;
    "1xH100" sizes the cell whole on one card): the metrics dict.
    `cfg` (the arch's CONFIG unless given) and `dims` = (seq, batch,
    kind) (``configs.SHAPES[shape_name]`` unless given) size another
    cell, such as the launcher's."""
    cfg = cfg or CFGS.get(arch).CONFIG
    seq, batch, kind = dims or CFGS.SHAPES[shape_name]
    ring = ring or RING64
    mesh = resolve_mesh(mesh, multi_pod)
    if fsdp is None:
        # big archs need weights sharded over the data axis too
        fsdp = RL.active_params(cfg) >= 5e9
    params = SP.param_specs(cfg, ring)
    p_shard = SP.param_shardings(cfg, mesh, fsdp=fsdp)
    args, a_shard = SP.input_specs(cfg, shape_name, ring=ring,
                                   dims=(seq, batch, kind), mesh=mesh)
    param_bytes = SP.shard_bytes(params, p_shard)
    input_bytes = SP.shard_bytes(args, a_shard)
    outs = output_specs(cfg, seq, batch, kind, ring)
    out_bytes = SP.shard_bytes(outs, output_shardings(cfg, mesh, seq, batch,
                                                      kind, p_shard))
    terms = RL.collective_terms(cfg, mesh, p_shard, params, kind, batch,
                                seq, ring.ell // 8)
    by_op = {}
    for t in terms:
        by_op[t["op"]] = by_op.get(t["op"], 0.0) + t["bytes"]
    metrics = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "devices": mesh.size,
        "seq": seq, "batch": batch, "kind": kind, "ring": ring.ell,
        "collapse": collapse, "fsdp": bool(fsdp),
        **{k: None for k in COMPILER_ONLY},
        "collective_bytes": RL.collective_bytes(terms),
        "collective_bytes_by_op": by_op,
        "collective_s": RL.collective_seconds(mesh, terms),
        "mem": {"argument_size_bytes": param_bytes + input_bytes,
                "param_bytes": param_bytes, "input_bytes": input_bytes,
                "output_size_bytes": out_bytes,
                "temp_size_bytes": None,
                "generated_code_size_bytes": None,
                "param_bytes_all_devices": SP.tree_bytes(params),
                "input_bytes_all_devices": SP.tree_bytes(args)},
        "hbm_bytes": RL.HBM_BYTES,
        "fits": param_bytes + input_bytes + out_bytes <= RL.HBM_BYTES,
    }
    metrics.update(RL.roofline_terms(metrics, cfg, batch, seq, kind))
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh.name}] arguments "
              f"{metrics['mem']['argument_size_bytes']:.4g} B a device "
              f"(params {param_bytes:.4g}, inputs {input_bytes:.4g}), "
              f"outputs {out_bytes:.4g} B; fits one card: "
              f"{metrics['fits']}; fsdp {metrics['fsdp']}")
        print(f"  collective_bytes={metrics['collective_bytes']:.3e} "
              f"{ {k: f'{v:.3e}' for k, v in by_op.items()} }")
        for k in ("t_compute_limb", "t_memory", "t_collective",
                  "bottleneck", "model_flops", "ring_macs"):
            print(f"  {k} = {metrics[k]}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", choices=MESHES, default=None,
                    help="size on this mesh (overrides --multi-pod); "
                    "1xH100 is one card, whole")
    ap.add_argument("--collapse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh = resolve_mesh(args.mesh, args.multi_pod)

    results = []
    if args.all:
        cells = CFGS.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, "run")]
    for arch, shape, run in cells:
        if run == "skip":
            m = {"arch": arch, "shape": shape, "mesh": mesh.name,
                 "skipped": "long_500k is for the sub-quadratic archs"}
        else:
            try:
                m = run_cell(arch, shape, collapse=args.collapse, mesh=mesh)
            except Exception as e:  # noqa: BLE001 -- reports failures
                m = {"arch": arch, "shape": shape, "mesh": mesh.name,
                     "error": repr(e)[:500]}
                print(f"[{arch} x {shape}] FAILED: {e!r}", file=sys.stderr)
        results.append(m)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
