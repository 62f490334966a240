"""Party objects and party-local share views (``repro/runtime/party.py``).

A ``Party`` holds exactly the state P_i is entitled to: its subset PRF keys
(only the F_setup streams of subsets containing i) and a ``CheckLedger``
of its hash-exchange verdicts.  ``PartyAView`` / ``PartyBView`` are one
party's slice of an arithmetic / boolean share: P0 holds every lambda but
never the masked value m; the online party P_i (i in 1..3) holds m and
every lambda except lambda_i.  ``DistAShare`` / ``DistBShare`` bundle the
four views of one logical share.  Components are torch tensors of ring
words (int64 / int32).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.algebra import PARTIES, CheckLedger
from ..core.prf import ThreefryKey, subset_id
from ..core.ring import lshr, signed, width_of


class PartyKeys:
    """The F_setup subset keys P_i belongs to (and no others)."""

    def __init__(self, master: ThreefryKey, party: int):
        self.party = party
        self._keys = {}
        for mask in range(1 << len(PARTIES)):
            if mask & (1 << party) and bin(mask).count("1") >= 2:
                self._keys[mask] = master.fold_in(mask)

    def subset_key(self, subset) -> ThreefryKey:
        mask = subset_id(subset)
        if mask not in self._keys:
            raise PermissionError(
                f"P{self.party} is outside subset {tuple(subset)}")
        return self._keys[mask]


@dataclasses.dataclass
class Party:
    """One of the four protocol participants."""

    index: int
    keys: PartyKeys
    ledger: CheckLedger

    def check_equal(self, a, b, tag: str = "") -> None:
        self.ledger.check_equal(a, b, tag)


@dataclasses.dataclass
class PartyAView:
    """P_i's slice of an arithmetic share: m (None for P0, and for every
    party in a lambda-only view) and the lambda components it holds."""

    m: torch.Tensor | None
    lam: dict

    def add(self, other: "PartyAView") -> "PartyAView":
        m = None if self.m is None or other.m is None else self.m + other.m
        return PartyAView(m, {j: self.lam[j] + other.lam[j]
                              for j in self.lam})

    def add_public(self, c) -> "PartyAView":
        """Public addition touches only m (lambda unchanged); P0 no-op."""
        m = None if self.m is None else self.m + c
        return PartyAView(m, dict(self.lam))

    def neg(self) -> "PartyAView":
        m = None if self.m is None else -self.m
        return PartyAView(m, {j: -v for j, v in self.lam.items()})

    def mul_public(self, c) -> "PartyAView":
        """Public *integer* scaling acts on every component (linear)."""
        m = None if self.m is None else self.m * c
        return PartyAView(m, {j: v * c for j, v in self.lam.items()})


@dataclasses.dataclass
class PartyBView:
    """P_i's slice of a boolean share (XOR world, bit-packed words)."""

    m: torch.Tensor | None
    lam: dict
    nbits: int

    def _map(self, fn, nbits=None) -> "PartyBView":
        return PartyBView(None if self.m is None else fn(self.m),
                          {j: fn(v) for j, v in self.lam.items()},
                          self.nbits if nbits is None else nbits)

    def xor(self, other: "PartyBView") -> "PartyBView":
        m = None if self.m is None or other.m is None else self.m ^ other.m
        return PartyBView(m, {j: self.lam[j] ^ other.lam[j]
                              for j in self.lam},
                          max(self.nbits, other.nbits))

    def xor_public(self, c) -> "PartyBView":
        """Public XOR touches only m; P0 no-op."""
        m = None if self.m is None else self.m ^ c
        return PartyBView(m, dict(self.lam), self.nbits)


@dataclasses.dataclass
class DistAShare:
    """The four party views of one logical arithmetic share."""

    views: tuple          # (P0, P1, P2, P3) PartyAView
    shape: tuple
    dtype: torch.dtype

    @classmethod
    def from_views(cls, views) -> "DistAShare":
        ref = views[1].m
        return cls(tuple(views), tuple(ref.shape), ref.dtype)

    def add(self, other: "DistAShare") -> "DistAShare":
        return DistAShare(tuple(a.add(b) for a, b in
                                zip(self.views, other.views)),
                          self.shape, self.dtype)

    def add_public(self, c) -> "DistAShare":
        return DistAShare(tuple(v.add_public(c) for v in self.views),
                          self.shape, self.dtype)

    def sub(self, other: "DistAShare") -> "DistAShare":
        return self.add(other.neg())

    def neg(self) -> "DistAShare":
        return DistAShare(tuple(v.neg() for v in self.views),
                          self.shape, self.dtype)

    def mul_public(self, c) -> "DistAShare":
        return DistAShare(tuple(v.mul_public(c) for v in self.views),
                          self.shape, self.dtype)


def map_components(fn, *xs: DistAShare) -> DistAShare:
    """Apply a share-local tensor function to every aligned component of
    the given shares (m per online party, each held lambda) and rebundle.
    `fn` must be additively homomorphic over the ring (reshape, sum,
    broadcast, ...).  A lambda-only view keeps m=None."""
    views = []
    for i in PARTIES:
        vs = [x.views[i] for x in xs]
        m = None if any(v.m is None for v in vs) \
            else fn(*[v.m for v in vs])
        lam = {j: fn(*[v.lam[j] for v in vs]) for j in vs[0].lam}
        views.append(PartyAView(m, lam))
    ref = views[1].m if views[1].m is not None \
        else next(iter(views[1].lam.values()))
    return DistAShare(tuple(views), tuple(ref.shape), ref.dtype)


@dataclasses.dataclass
class DistBShare:
    """The four party views of one logical boolean share."""

    views: tuple
    shape: tuple
    dtype: torch.dtype
    nbits: int

    def _word(self, c: int) -> int:
        """A Python constant as the signed word this share's tensors hold."""
        return signed(c, width_of(self.dtype))

    def _map(self, fn, nbits=None) -> "DistBShare":
        nbits = self.nbits if nbits is None else nbits
        return DistBShare(tuple(v._map(fn, nbits) for v in self.views),
                          self.shape, self.dtype, nbits)

    def xor(self, other: "DistBShare") -> "DistBShare":
        return DistBShare(tuple(a.xor(b) for a, b in
                                zip(self.views, other.views)),
                          self.shape, self.dtype,
                          max(self.nbits, other.nbits))

    def xor_public(self, c) -> "DistBShare":
        if isinstance(c, int):
            c = self._word(c)
        return DistBShare(tuple(v.xor_public(c) for v in self.views),
                          self.shape, self.dtype, self.nbits)

    def invert(self) -> "DistBShare":
        """NOT = XOR with public all-ones over the valid bits."""
        return self.xor_public((1 << self.nbits) - 1)

    def and_public(self, mask: int) -> "DistBShare":
        mask = self._word(mask)
        return self._map(lambda v: v & mask)

    def shift_left(self, k: int) -> "DistBShare":
        return self._map(lambda v: v << k)

    def shift_right(self, k: int) -> "DistBShare":
        """Logical right shift of every component."""
        return self._map(lambda v: lshr(v, k))

    def bit(self, k: int) -> "DistBShare":
        """Extract bit plane k as a 1-bit share."""
        return self._map(lambda v: (v >> k) & 1, nbits=1)
