"""Dry run of every (arch x shape) cell for one H100
(``repro/launch/dryrun.py``).

The JAX module lowers and compiles each cell's step for a 16x16 or
2x16x16 TPU mesh and reads the compiler's memory and cost analyses.  The
port runs eagerly and has no compiler to ask, so a cell here is sized
from the abstract specs (``specs.py``: meta tensors, no memory and no
device touched): the argument bytes (params, inputs, caches), the output
bytes (a train step's new params and loss; a serve step's last-token
logits and caches, a decode step's one position longer), whether they
fit one card's 80 GB, and the roofline terms of ``roofline.py``.  The
keys only a compile gives (``lower_s``, ``compile_s``, ``flops``,
``bytes_accessed``, ``temp_size_bytes``, ``generated_code_size_bytes``)
are None, and ``fits`` leaves the temporaries out (ROADMAP D3).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--collapse] [--out out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out ...]

``--all`` covers the 40 cells of ``configs.cells()``: the 33 it runs are
sized, the 7 it skips (``long_500k`` of a full-attention arch) recorded
as skipped.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import configs as CFGS
from ..core.ring import RING64
from . import specs as SP
from .roofline import HBM_BYTES, active_params, roofline_terms

MESH = "1xH100"
# the keys the JAX dry run reads from the compiled program
COMPILER_ONLY = ("lower_s", "compile_s", "flops", "bytes_accessed")


def output_specs(cfg, seq: int, batch: int, kind: str, ring) -> list:
    """What the cell's step returns, as meta tensors."""
    if kind == "train":
        return [SP.param_specs(cfg, ring),
                torch.empty((), dtype=torch.float64, device=SP.META)]
    logits = SP._share((batch, 1, cfg.vocab), ring, True)
    positions = seq if kind == "prefill" else seq + 1
    return [logits, SP.decode_cache_specs(cfg, batch, positions, ring=ring,
                                          long_ctx=kind == "long_decode")]


def run_cell(arch: str, shape_name: str, collapse: bool = False,
             verbose: bool = True, fsdp: bool | None = None, ring=None,
             cfg=None, dims: tuple | None = None) -> dict:
    """Size one (arch, shape) cell on one H100: the metrics dict.
    `cfg` (the arch's CONFIG unless given) and `dims` = (seq, batch,
    kind) (``configs.SHAPES[shape_name]`` unless given) size another
    cell, such as the launcher's.  `fsdp` is recorded as the JAX dry run
    records it; on one card it changes nothing."""
    cfg = cfg or CFGS.get(arch).CONFIG
    seq, batch, kind = dims or CFGS.SHAPES[shape_name]
    ring = ring or RING64
    if fsdp is None:
        fsdp = active_params(cfg) >= 5e9
    param_bytes = SP.tree_bytes(SP.param_specs(cfg, ring))
    input_bytes = SP.tree_bytes(SP.input_specs(cfg, shape_name, ring=ring,
                                               dims=(seq, batch, kind)))
    out_bytes = SP.tree_bytes(output_specs(cfg, seq, batch, kind, ring))
    metrics = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "devices": 1,
        "seq": seq, "batch": batch, "kind": kind, "ring": ring.ell,
        "collapse": collapse, "fsdp": bool(fsdp),
        "fsdp_effect": "none on one card",
        **{k: None for k in COMPILER_ONLY},
        "collective_bytes": 0.0,
        "mem": {"argument_size_bytes": param_bytes + input_bytes,
                "param_bytes": param_bytes, "input_bytes": input_bytes,
                "output_size_bytes": out_bytes,
                "temp_size_bytes": None,
                "generated_code_size_bytes": None},
        "hbm_bytes": HBM_BYTES,
        "fits": param_bytes + input_bytes + out_bytes <= HBM_BYTES,
    }
    metrics.update(roofline_terms(metrics, cfg, batch, seq, kind))
    if verbose:
        print(f"[{arch} x {shape_name} x {MESH}] arguments "
              f"{metrics['mem']['argument_size_bytes']:.4g} B (params "
              f"{param_bytes:.4g}, inputs {input_bytes:.4g}), outputs "
              f"{out_bytes:.4g} B; fits one card: {metrics['fits']}")
        for k in ("t_compute_limb", "t_memory", "t_collective",
                  "bottleneck", "model_flops", "ring_macs"):
            print(f"  {k} = {metrics[k]}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--collapse", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    results = []
    if args.all:
        cells = CFGS.cells()
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, "run")]
    for arch, shape, run in cells:
        if run == "skip":
            m = {"arch": arch, "shape": shape, "mesh": MESH,
                 "skipped": "long_500k is for the sub-quadratic archs"}
        else:
            try:
                m = run_cell(arch, shape, collapse=args.collapse)
            except Exception as e:  # noqa: BLE001 -- reports failures
                m = {"arch": arch, "shape": shape, "mesh": MESH,
                     "error": repr(e)[:500]}
                print(f"[{arch} x {shape}] FAILED: {e!r}", file=sys.stderr)
        results.append(m)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
