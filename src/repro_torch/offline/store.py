"""PrepStore: use-once preprocessing material, keyed by tag
(``repro/offline/store.py``).

One *entry* is the whole offline product of one protocol invocation --
lambda/gamma shares for Pi_Mult, the truncation pair (r, r^t), the <u>/<p>
conversion masks, vSh lambda masks (plus the exchanged masked value when
the vSh itself is offline), ... -- stored as **four per-party records**:
record i holds exactly what P_i holds after the offline phase.

Keys are the runtime's protocol tags ("multtr#3", "b2a#7.v0", ...): the
dealer pass and the online-only pass of the same program take the same
tags, so the online run finds its material by the tag it would have
sampled under.  Entries are use-once: a second pop raises
``PrepReplayError``, an unknown tag ``PrepMissingError`` and a kind
mismatch ``PrepKindError``.

In memory, records hold tensors where the dealer made them (on the
dealer runtime's device: no copy to the host per entry).  A store dealt on
the card carries a CUDA event recorded after its last write; the consuming
run's stream waits on it before its first read, and every popped tensor is
recorded on that stream, so the caching allocator does not hand its memory
to the dealer's next session while the online kernels still read it.

On disk (``save`` / ``load``) the format is the JAX package's, so either
package reads the other's stores: ``manifest.json`` (version 1, meta, party,
the ordered entries) plus one ``party{i}.npz`` per party, keys
``f"{tag}|{path}"`` with integer record keys written ``#<k>``, words as
``uint64`` (``RING64``) or ``uint32`` (``RING32``) views of the tensors.
``load`` gives CPU tensors; ``OnlinePrep`` moves them to the consuming
runtime's device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.ring import words_to_numpy_batch

PARTIES = (0, 1, 2, 3)

_SEP = "|"          # npz key = f"{tag}|{path}"; tags must not contain it
_PATH_SEP = "."     # nested record path; int keys encoded as "#<k>"

# the bit-preserving views between tensors and the JAX package's words
_TO_NP = {torch.int64: np.uint64, torch.int32: np.uint32}
_FROM_NP = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}


class PrepError(RuntimeError):
    """Base class for preprocessing-store failures."""


class PrepMissingError(PrepError):
    """The online run asked for a tag the dealer never produced."""


class PrepReplayError(PrepError):
    """A prep entry was consumed twice -- offline material is use-once."""


class PrepKindError(PrepError):
    """Entry exists but was dealt for a different protocol kind."""


# ---------------------------------------------------------------------------
# Record (de)flattening: records are nested dicts with int/str keys and
# tensor leaves (all that the protocols' preps produce).
# ---------------------------------------------------------------------------
def _enc_key(k) -> str:
    if isinstance(k, bool):
        raise PrepError(f"unsupported record key {k!r}")
    if isinstance(k, (int, np.integer)):
        return f"#{int(k)}"
    if not (isinstance(k, str) and _PATH_SEP not in k and _SEP not in k
            and not k.startswith("#")):
        raise PrepError(f"unsupported record key {k!r}")
    return k


def _dec_key(s: str):
    return int(s[1:]) if s.startswith("#") else s


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        if not tree:
            raise PrepError("empty dict in prep record (not round-trippable)")
        for k, v in tree.items():
            key = _enc_key(k)
            _flatten(v, f"{prefix}{_PATH_SEP}{key}" if prefix else key, out)
    else:
        out[prefix] = tree


def _unflatten(flat: dict):
    tree: dict = {}
    for path, arr in flat.items():
        keys = [_dec_key(s) for s in path.split(_PATH_SEP)]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree


def _copy_tree(rec):
    """The record's dict structure anew, the leaf tensors shared."""
    flat: dict = {}
    _flatten(rec, "", flat)
    return _unflatten(flat)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Ring words as the JAX package's unsigned words (same bits)."""
    a = t.detach().cpu().contiguous().numpy()
    return a.view(_TO_NP[t.dtype]) if t.dtype in _TO_NP else a


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")          # a copy; keeps 0-d arrays 0-d
    if a.dtype in _FROM_NP:
        a = a.view(_FROM_NP[a.dtype])
    return torch.from_numpy(a)


class PrepStore:
    """Tag-keyed, use-once offline material for one protocol program run.

    ``party`` attributes the store to one consumer for error messages (a
    party's slice) or is None for an all-party store.  Failure messages
    name the tag, the protocol kind and the consumer.
    """

    def __init__(self, meta: dict | None = None, party: int | None = None):
        self.meta = dict(meta or {})
        self.party = party
        self._entries: dict[str, tuple[str, list]] = {}
        self._consumed: dict[str, str] = {}
        self._order: list[str] = []
        # CUDA event recorded after the dealer's last write (None: no
        # device work to wait for)
        self.ready = None

    def _who(self) -> str:
        """Attribution suffix: consumer party + dealt session/step meta."""
        who = "all parties" if self.party is None else f"party P{self.party}"
        for key in ("session", "step"):
            if key in self.meta:
                who += f", {key} {self.meta[key]}"
        return who

    # -- dealer side -------------------------------------------------------
    def put(self, tag: str, kind: str, parts: list) -> None:
        if _SEP in tag:
            raise PrepError(f"tag {tag!r} may not contain {_SEP!r}")
        if tag in self._entries or tag in self._consumed:
            raise PrepError(f"duplicate prep entry {tag!r} ({kind!r})")
        if len(parts) != len(PARTIES):
            raise PrepError(f"{tag!r}: expected 4 per-party records, "
                            f"got {len(parts)}")
        # the records' tensors are the dealer's own, not copies (a copy
        # per entry would be a device copy, or a sync on the card): the
        # protocols must never write a prep tensor in place
        self._entries[tag] = (kind, [_copy_tree(rec) for rec in parts])
        self._order.append(tag)

    def mark_ready(self, device) -> None:
        """Record the event a consuming stream waits on: after every write
        the current stream of `device` has queued (no-op off the card)."""
        device = torch.device(device)
        if device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(device))

    # -- online side -------------------------------------------------------
    def pop(self, tag: str, kind: str) -> list:
        if tag in self._consumed:
            raise PrepReplayError(
                f"prep entry {tag!r} (kind {self._consumed[tag]!r}) "
                f"already consumed at {self._who()} -- offline material "
                "is use-once; a replayed/resumed step needs freshly "
                "dealt material")
        if tag not in self._entries:
            raise PrepMissingError(
                f"no prep entry {tag!r} (kind {kind!r}) in the store at "
                f"{self._who()}; the online program diverged from the "
                "dealt workload")
        got_kind, parts = self._entries.pop(tag)
        if got_kind != kind:
            raise PrepKindError(
                f"prep entry {tag!r} was dealt as {got_kind!r} but "
                f"consumed as {kind!r} at {self._who()}")
        self._consumed[tag] = got_kind
        return parts

    # -- per-party slicing -------------------------------------------------
    def for_party(self, party: int) -> "PrepStore":
        """The slice a deployment ships to host `party`: record i is kept
        only for i == party (the others become empty stubs, so tags, kinds
        and order stay)."""
        if party not in PARTIES:
            raise ValueError(f"no party {party}")
        out = PrepStore(meta=self.meta, party=party)
        out.ready = self.ready
        for tag in self.tags():
            kind, parts = self._entries[tag]
            out._entries[tag] = (kind, [parts[i] if i == party else {}
                                        for i in PARTIES])
            out._order.append(tag)
        return out

    # -- crossing a process boundary ---------------------------------------
    def to_arrays(self) -> dict:
        """The un-consumed entries as plain data for another process: after
        the dealer's last write (``ready``), every tensor reaches the host
        in one batched copy per dtype, ring words as the JAX package's
        unsigned words.  No tensor crosses: a CUDA tensor would travel by
        CUDA IPC, or carry its device in its pickle."""
        if self.ready is not None:
            self.ready.synchronize()
        entries, leaves = [], []
        for tag in self.tags():
            kind, parts = self._entries[tag]
            flats = []
            for rec in parts:
                flat: dict = {}
                if rec:                     # {}: another party's stub
                    _flatten(rec, "", flat)
                flats.append(flat)
                leaves.extend(flat.values())
            entries.append((tag, kind, flats))
        arrays = iter(words_to_numpy_batch(leaves))
        for _, _, flats in entries:
            for flat in flats:
                for path in flat:
                    flat[path] = next(arrays)
        return {"meta": self.meta, "party": self.party, "entries": entries}

    @classmethod
    def from_arrays(cls, data: dict) -> "PrepStore":
        """A store from ``to_arrays``'s data, as CPU tensors
        (``OnlinePrep`` moves them to the consuming device)."""
        store = cls(meta=data["meta"], party=data["party"])
        for tag, kind, flats in data["entries"]:
            store._entries[tag] = (kind, [
                _unflatten({p: _from_numpy(a) for p, a in flat.items()})
                for flat in flats])
            store._order.append(tag)
        return store

    # -- introspection -----------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def tags(self) -> list:
        return [t for t in self._order if t in self._entries]

    def remaining(self) -> int:
        return len(self._entries)

    def consumed(self) -> int:
        return len(self._consumed)

    def summary(self) -> dict:
        """{kind: entry count} over un-consumed entries."""
        out: dict = {}
        for kind, _ in self._entries.values():
            out[kind] = out.get(kind, 0) + 1
        return out

    def nbytes(self, party: int | None = None) -> int:
        total = 0
        for _, parts in self._entries.values():
            recs = parts if party is None else [parts[party]]
            for rec in recs:
                if not rec:
                    continue            # stubbed-out slice of another party
                flat: dict = {}
                _flatten(rec, "", flat)
                total += sum(t.numel() * t.element_size()
                             for t in flat.values())
        return total

    # -- disk --------------------------------------------------------------
    def save(self, path: str) -> None:
        """Write manifest.json + per-party material files party{i}.npz."""
        os.makedirs(path, exist_ok=True)
        per_party: list[dict] = [{} for _ in PARTIES]
        entries = []
        for tag in self.tags():
            kind, parts = self._entries[tag]
            entries.append({"tag": tag, "kind": kind})
            for i in PARTIES:
                if not parts[i]:
                    continue            # party-sliced store: other ranks
                flat: dict = {}
                _flatten(parts[i], "", flat)
                for p, t in flat.items():
                    per_party[i][f"{tag}{_SEP}{p}"] = _to_numpy(t)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"version": 1, "meta": self.meta, "party": self.party,
                       "entries": entries}, f, indent=2)
        for i in PARTIES:
            np.savez_compressed(os.path.join(path, f"party{i}.npz"),
                                **per_party[i])

    @classmethod
    def load(cls, path: str) -> "PrepStore":
        """A store from `path` (either package's), as CPU tensors."""
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("version") != 1:
            raise PrepError(f"unknown PrepStore version in {path}")
        store = cls(meta=manifest.get("meta"), party=manifest.get("party"))
        by_tag: dict = {ent["tag"]: [{} for _ in PARTIES]
                        for ent in manifest["entries"]}
        for i in PARTIES:
            with np.load(os.path.join(path, f"party{i}.npz")) as npz:
                for key in npz.files:
                    tag, rest = key.split(_SEP, 1)
                    if tag not in by_tag:
                        raise PrepError(f"{path}: party{i}.npz holds {key!r}"
                                        " of no manifest entry")
                    by_tag[tag][i][rest] = _from_numpy(npz[key])
        for ent in manifest["entries"]:
            tag = ent["tag"]
            store._entries[tag] = (ent["kind"],
                                   [_unflatten(f) for f in by_tag[tag]])
            store._order.append(tag)
        return store


class _ConsumedSession:
    """Tombstone left where a consumed (or seek-skipped) PrepStore lived:
    the material is freed, the session index and dealt metadata stay, so
    ``PrepReplayError`` attribution survives the reclamation."""

    __slots__ = ("session", "meta", "skipped")

    def __init__(self, session: int, meta: dict, skipped: bool = False):
        self.session = session
        self.meta = dict(meta)
        self.skipped = skipped

    def __repr__(self):
        how = "skipped" if self.skipped else "consumed"
        return f"<{how} prep session {self.session} {self.meta}>"


class PrepBank:
    """An ordered sequence of PrepStores (one per batch or step session).

    Consumed sessions are replaced by tombstones the moment they are
    handed out, so the bank's resident material is bounded by the dealer's
    look-ahead, not by the length of the run (``resident()``)."""

    def __init__(self, stores: list | None = None):
        self._stores = list(stores or [])
        self._next = 0

    def add(self, store: PrepStore) -> None:
        self._stores.append(store)

    def __len__(self) -> int:
        return len(self._stores)

    @property
    def sessions_left(self) -> int:
        return len(self._stores) - self._next

    def resident(self) -> int:
        """How many sessions still hold live material (not tombstoned)."""
        return sum(isinstance(s, PrepStore) for s in self._stores)

    def _tombstone(self, k: int, skipped: bool) -> PrepStore:
        store = self._stores[k]
        self._stores[k] = _ConsumedSession(k, store.meta, skipped=skipped)
        return store

    def next(self) -> PrepStore:
        if self._next >= len(self._stores):
            raise PrepMissingError(
                f"prep bank exhausted after {self._next} sessions")
        store = self._tombstone(self._next, skipped=False)
        self._next += 1
        return store

    def seek(self, session: int) -> None:
        """Position the cursor at `session` (a resumed run skips the
        sessions earlier steps used).  Seeking back into consumed sessions
        is a replay -- per-step material is use-once."""
        if session < self._next:
            extra = ""
            if 0 <= session < len(self._stores):
                tomb = self._stores[session]
                meta = getattr(tomb, "meta", {}) or {}
                bits = [f"{k} {meta[k]}" for k in ("step",) if k in meta]
                if getattr(tomb, "skipped", False):
                    bits.append("skipped by a forward seek")
                if bits:
                    extra = f" ({', '.join(bits)})"
            raise PrepReplayError(
                f"prep session {session}{extra} already consumed (bank "
                f"cursor at {self._next}) -- per-step offline material is "
                "use-once; a retried step needs a freshly dealt session")
        if session > len(self._stores):
            # == len is legal: the cursor at the next session to be dealt
            raise PrepMissingError(
                f"no prep session {session} in the bank "
                f"({len(self._stores)} dealt)")
        # the sessions a forward seek skips can never be reached again
        for k in range(self._next, session):
            if isinstance(self._stores[k], PrepStore):
                self._tombstone(k, skipped=True)
        self._next = session

    def save(self, path: str) -> None:
        dead = [s.session for s in self._stores
                if isinstance(s, _ConsumedSession)]
        if dead:
            raise PrepError(
                f"cannot serialize a partially consumed PrepBank: "
                f"session(s) {dead} already consumed (material freed)")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "bank.json"), "w") as f:
            json.dump({"version": 1, "sessions": len(self._stores)}, f)
        for k, store in enumerate(self._stores):
            store.save(os.path.join(path, f"session_{k:04d}"))

    @classmethod
    def load(cls, path: str) -> "PrepBank":
        with open(os.path.join(path, "bank.json")) as f:
            n = json.load(f)["sessions"]
        return cls([PrepStore.load(os.path.join(path, f"session_{k:04d}"))
                    for k in range(n)])


# ---------------------------------------------------------------------------
# The two non-inline prep engines (see runtime.runtime.InlinePrep).
# ---------------------------------------------------------------------------
class DealPrep:
    """Dealer pass: run every offline half for real (sampling and offline
    messages on the dealer's transport) and record the per-party material;
    protocols skip their online halves (``skip_online``)."""

    mode = "deal"
    skip_online = True
    consuming = False

    def __init__(self, store: PrepStore):
        self.store = store

    def acquire(self, tag: str, kind: str, build):
        parts = build()
        self.store.put(tag, kind, parts)
        return parts


class OnlinePrep:
    """Online-only pass: never build -- pop the dealer's material by tag,
    on `device` (None: where the store holds it).  On the card the
    consuming stream first waits on the store's ready event, and each
    popped tensor is recorded on that stream."""

    mode = "online"
    skip_online = False
    consuming = True

    def __init__(self, store: PrepStore, device=None):
        self.store = store
        self.device = None if device is None else torch.device(device)
        self._stream = None

    def _on_device(self, t: torch.Tensor) -> torch.Tensor:
        # "cuda" without an index is the current card: no copy for it
        if t.device.type != self.device.type or (
                self.device.index is not None
                and t.device.index != self.device.index):
            t = t.to(self.device)
        if t.device.type == "cuda":
            t.record_stream(self._stream)
        return t

    def acquire(self, tag: str, kind: str, build):
        parts = self.store.pop(tag, kind)
        if self.device is None:
            return parts
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.current_stream(self.device)
            if self.store.ready is not None:
                self._stream.wait_event(self.store.ready)
        return [_map_leaves(rec, self._on_device) for rec in parts]
