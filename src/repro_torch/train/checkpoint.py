"""Fault-tolerant checkpoints of parameter trees
(``repro/train/checkpoint.py``), in the JAX package's on-disk layout, so
either package restores the other's checkpoint of the same tree:

  * ``step_<n>/`` holds ``shard_<host>.npz`` (leaf i under ``leaf_i``) and
    ``manifest.json`` (the step, the leaf count, which leaves are None, the
    tree's description as ``str(treedef)`` of JAX prints it, each file's
    SHA-256, and ``meta``);
  * the leaves are in JAX's order (``jax.tree_util.tree_flatten(tree,
    is_leaf=lambda x: x is None)``): dict keys sorted, lists and tuples in
    order, a None kept as a leaf (``none_mask``), a share (``AShare``,
    ``BShare``) flattened to its ``data``;
  * ring words are written as the JAX package writes them: an int64
    (int32) tensor of the port, which holds ring words, as uint64
    (uint32), the same bits; float parameters as they are;
  * each leaf moves to the host on its own as it is written, so a tree on
    the card is never copied whole;
  * atomic publish: written into ``step_<n>.tmp/``, the manifest fsynced,
    then renamed to ``step_<n>/``, so a crash mid-write never leaves a
    checkpoint that ``latest()`` would take;
  * ``latest()`` is the highest step whose manifest's checksums hold;
  * ``reshard`` checks a change of device count as a multi-host restore
    would; checkpoints hold the logical (unsharded) arrays, so the tree
    is returned unchanged.

``restore`` returns the words in the structure of the tree it is given,
a share's place holding its data's words (numpy); ``rewrap`` puts them
back into the reference tree's containers and devices.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zipfile

import numpy as np
import torch

from ..core.ring import words_from_numpy, words_to_numpy
from ..core.shares import AShare, BShare

_SHARES = (AShare, BShare)


def _flatten(tree) -> tuple:
    """(leaves in JAX's order, the tree's description as JAX prints its
    treedef); a share is one node around its data."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(x) for x in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(x) for x in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if isinstance(node, _SHARES):
            leaves.append(node.data)
            return f"CustomNode({type(node).__name__}[None], [*])"
        leaves.append(node)
        return "*"

    return leaves, "PyTreeDef(" + walk(tree) + ")"


def _unflatten(tree_like, leaves):
    """`leaves` (in ``_flatten``'s order) in the structure of
    `tree_like`, a share's place holding its leaf."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x) for x in node)
        return next(it)

    return walk(tree_like)


def _host(x) -> np.ndarray:
    """A leaf as the JAX package writes it: ring words (int64 / int32
    tensors) as uint64 / uint32, other tensors and arrays as they are."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.int64, torch.int32):
            return words_to_numpy(x)
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _checksum(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write_npz(path: str, leaves) -> None:
    """``np.savez``'s layout (a stored zip of ``leaf_i.npy``), one leaf on
    the host at a time."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, x in enumerate(leaves):
            if x is None:
                continue
            with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _host(x), allow_pickle=False)


def save(ckpt_dir: str, step: int, tree, meta: dict | None = None,
         host: int = 0) -> str:
    """Atomic checkpoint publish of this host's shard.  Returns the final
    directory."""
    leaves, treedef = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shard = os.path.join(tmp, f"shard_{host}.npz")
    _write_npz(shard, leaves)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "none_mask": [x is None for x in leaves],
        "treedef": treedef,
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


def restore(path: str, tree_like, host: int = 0) -> tuple:
    """This host's shard in the structure of `tree_like` (numpy arrays as
    written; None where the checkpoint holds None); returns (tree,
    manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    refs, _ = _flatten(tree_like)
    if manifest["n_leaves"] != len(refs):
        raise ValueError(f"checkpoint {path} holds {manifest['n_leaves']} "
                         f"leaves, the tree {len(refs)}")
    with np.load(os.path.join(path, f"shard_{host}.npz")) as data:
        out = [None if manifest["none_mask"][i] else data[f"leaf_{i}"]
               for i in range(len(refs))]
    return _unflatten(tree_like, out), manifest


def rewrap(ref, restored):
    """`restored` (``restore``'s words) in `ref`'s containers: a share
    around its words on its data's device and in its word type, a tensor
    as a tensor on its device, anything else as a numpy array."""
    if ref is None or restored is None:
        return restored
    if isinstance(ref, dict):
        return {k: rewrap(ref[k], restored[k]) for k in sorted(ref)}
    if isinstance(ref, (list, tuple)):
        return type(ref)(rewrap(a, b) for a, b in zip(ref, restored))
    if isinstance(ref, _SHARES):
        return type(ref)(_like(ref.data, restored))
    if isinstance(ref, torch.Tensor):
        return _like(ref, restored)
    return np.asarray(restored)


def _like(ref: torch.Tensor, arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype in (np.uint64, np.uint32):
        return words_from_numpy(arr, device=ref.device)
    return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)


def reshard(tree, n_old: int, n_new: int):
    """Elastic rescale: checkpoints hold logical arrays, so a change of
    device count leaves the values as they are; the counts must divide
    one another, as a multi-host restore needs.  Returns the tree."""
    if n_old % n_new and n_new % n_old:
        raise ValueError(f"cannot reshard {n_old} -> {n_new}")
    return tree
