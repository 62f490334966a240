"""Checkpoints of parameter dicts (``repro/train/checkpoint.py``), in the
JAX package's on-disk layout, so either package restores the other's
checkpoint of the same params:

  * ``step_<n>/`` holds ``shard_0.npz`` (leaf i under ``leaf_i``, the
    leaves in sorted key order, as JAX flattens a dict) and
    ``manifest.json`` (the step, the leaf count, which leaves are None, the
    tree's description, each file's SHA-256, and ``meta``);
  * atomic publish: written into ``step_<n>.tmp/``, the manifest fsynced,
    then renamed to ``step_<n>/``, so a crash mid-write never leaves a
    checkpoint that ``latest()`` would take;
  * ``latest()`` is the highest step whose manifest's checksums hold.

The tree is a flat dict of numpy arrays (float64 parameters, or None).
The JAX module's elastic re-shard across device counts (``reshard``) is
not ported: the port trains on one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np


def _flatten(tree: dict) -> tuple:
    """(leaves in sorted key order, the keys); JAX's order for a dict."""
    keys = sorted(tree)
    return [tree[k] for k in keys], keys


def _treedef(keys) -> str:
    """The description JAX writes for a flat dict of leaves."""
    return "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in keys) + "})"


def _checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree: dict,
         meta: dict | None = None) -> str:
    """Atomic checkpoint publish.  Returns the final directory."""
    leaves, keys = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shard = os.path.join(tmp, "shard_0.npz")
    np.savez(shard, **{f"leaf_{i}": np.asarray(x)
                       for i, x in enumerate(leaves) if x is not None})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "none_mask": [x is None for x in leaves],
        "treedef": _treedef(keys),
        "files": {os.path.basename(shard): _checksum(shard)},
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic publish
    return final


def verify(path: str) -> bool:
    mpath = os.path.join(path, "manifest.json")
    if not os.path.exists(mpath):
        return False
    with open(mpath) as f:
        manifest = json.load(f)
    for fname, want in manifest["files"].items():
        fpath = os.path.join(path, fname)
        if not os.path.exists(fpath) or _checksum(fpath) != want:
            return False
    return True


def latest(ckpt_dir: str) -> str | None:
    """Highest step with a checksum-valid manifest; ignores .tmp debris."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in reversed(steps):
        path = os.path.join(ckpt_dir, d)
        if verify(path):
            return path
    return None


def restore(path: str, tree_like: dict) -> tuple:
    """Restore into the keys of `tree_like`; returns (tree, manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _, keys = _flatten(tree_like)
    if manifest["n_leaves"] != len(keys):
        raise ValueError(f"checkpoint {path} holds {manifest['n_leaves']} "
                         f"leaves, the tree {len(keys)}")
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        out = {k: None if manifest["none_mask"][i] else data[f"leaf_{i}"]
               for i, k in enumerate(keys)}
    return out, manifest
