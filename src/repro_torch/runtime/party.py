"""Party objects and party-local share views (``repro/runtime/party.py``).

A ``Party`` holds exactly the state P_i is entitled to: its subset PRF keys
(only the F_setup streams of subsets containing i) and a ``CheckLedger``
of its hash-exchange verdicts.  ``PartyAView`` / ``PartyBView`` are one
party's slice of an arithmetic / boolean share: P0 holds every lambda but
never the masked value m; the online party P_i (i in 1..3) holds m and
every lambda except lambda_i.  ``DistAShare`` / ``DistBShare`` bundle the
four views of one logical share; ``from_joint`` / ``to_joint`` convert to
and from the joint simulation's ``AShare`` / ``BShare`` stacks (``to_joint``
checks that every component agrees across the parties holding it).
Components are torch tensors of ring words (int64 / int32).  In the
dealer pass (deal mode) shares are lambda-only: every view's m is None.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.algebra import PARTIES, CheckLedger, lam_holders
from ..core.prf import ThreefryKey, subset_id
from ..core.ring import lshr, signed, width_of
from ..core.shares import AShare, BShare


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


def _view_indices(party: int) -> tuple:
    """Lambda components party i holds: all but i (P0 holds all three)."""
    return tuple(j for j in (1, 2, 3) if j != party)


def _joint_stack(views, what: str) -> torch.Tensor:
    """The (4, *shape) stack (m, lambda_1..3) of four party views, after
    checking that every component agrees across the parties holding it."""
    m = views[1].m
    for i in (2, 3):
        if not torch.equal(views[i].m, m):
            raise AssertionError(f"{what}: m view mismatch")
    lams = []
    for j in (1, 2, 3):
        holders = lam_holders(j)
        ref = views[holders[0]].lam[j]
        for h in holders[1:]:
            if not torch.equal(views[h].lam[j], ref):
                raise AssertionError(f"{what}: lambda_{j} view mismatch")
        lams.append(ref)
    return torch.stack([m] + lams)


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

    @classmethod
    def from_joint(cls, x: AShare) -> "DistAShare":
        views = [PartyAView(None if i == 0 else x.m,
                            {j: x.data[j] for j in _view_indices(i)})
                 for i in PARTIES]
        return cls(tuple(views), x.shape, x.dtype)

    def to_joint(self) -> AShare:
        """Reassemble the joint stack, checking that every component agrees
        across all parties holding it (a corrupted runtime would diverge)."""
        return AShare(_joint_stack(self.views, "arithmetic share"))

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

    # operator sugar matching AShare, so engine-generic code can write
    # `x + y` against either container
    def __add__(self, other):
        if isinstance(other, DistAShare):
            return self.add(other)
        return self.add_public(other)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, DistAShare):
            return self.sub(other)
        return self.add_public(-other)

    def __neg__(self):
        return self.neg()


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


def map_components_multi(fn, x: DistAShare, n: int) -> list:
    """`fn` returns a list of `n` tensors per component (e.g.
    ``torch.split``); rebundles them into `n` shares."""
    pieces = [[None] * len(PARTIES) for _ in range(n)]
    for i in PARTIES:
        v = x.views[i]
        ms = fn(v.m) if v.m is not None else [None] * n
        lams = {j: fn(v.lam[j]) for j in v.lam}
        for k in range(n):
            pieces[k][i] = PartyAView(ms[k], {j: lams[j][k] for j in v.lam})
    out = []
    for k in range(n):
        ref = pieces[k][1].m if pieces[k][1].m is not None \
            else next(iter(pieces[k][1].lam.values()))
        out.append(DistAShare(tuple(pieces[k]), tuple(ref.shape),
                              ref.dtype))
    return out


@dataclasses.dataclass
class DistBShare:
    """The four party views of one logical boolean share."""

    views: tuple
    shape: tuple
    dtype: torch.dtype
    nbits: int

    @classmethod
    def from_joint(cls, x: BShare) -> "DistBShare":
        views = [PartyBView(None if i == 0 else x.m,
                            {j: x.data[j] for j in _view_indices(i)},
                            x.nbits) for i in PARTIES]
        return cls(tuple(views), x.shape, x.dtype, x.nbits)

    def to_joint(self) -> BShare:
        return BShare(_joint_stack(self.views, "boolean share"), self.nbits)

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
