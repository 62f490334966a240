"""Party-local Trident protocols over a measured Transport
(``repro/runtime/protocols.py``).

The same algebra (``core.algebra``), the same PRF streams in the same
counter order and the same message choreography as the JAX runtime, so a
program opens the same ring words and moves the same bits per link:

  * values known to two parties move as a *jmp send*: one holder sends the
    value, the co-holder a hash copy (0 bits), and the receiver
    recompute-and-compares -- a tampered wire flips its abort ledger;
  * Pi_Mult's gamma piece j is computed by P0 and one online party and
    jmp-sent by P0 to the co-holder of lambda_j (the whole offline cost);
    online, each m_z' part is jmp-sent to the single party missing it.

Every protocol acquires its data-independent material through
``rt.prep.acquire(tag, kind, build)``; ``build`` samples in the JAX
package's counter order and moves the offline messages, returning the four
per-party records of what each P_i holds afterwards.  Inline mode runs it
in place; deal mode records it into a PrepStore and stops before the
online half (shares carry only lambdas, m is None); online mode pops the
record and runs the online half alone, with the offline phase forbidden on
the wire (``Transport.forbid_phase``).  Tags are taken in every mode
exactly where the JAX package takes them, so a store dealt by either
package feeds the other's online run.
"""
from __future__ import annotations

import torch

from ..core import algebra as AL
from ..core.algebra import (ASH_SUBSETS, B2A_VALS, GAMMA_LOCAL, GAMMA_RECV,
                            PART_HOLDERS, PARTIES, REC_ROUTE, TRUNC_GUARD,
                            ZERO_SUBSETS, as_op, lam_holders, matmul_shape)
from ..core.ring import bit_planes, signed
from ..obs import traced_protocol
from .party import DistAShare, DistBShare, PartyAView, PartyBView
from .runtime import FourPartyRuntime


def _jmp(rt: FourPartyRuntime, value_from: int, hash_from: int, dst: int,
         payload, hash_copy, *, tag: str, nbits: int, phase: str):
    """Hash-verified send of a value held by two parties: `value_from`
    ships the payload, `hash_from` its own copy as the (free) hash; the
    receiver compares.  Returns the received payload."""
    tp = rt.transport
    tp.send(value_from, dst, payload, tag=tag, nbits=nbits, phase=phase)
    tp.send(hash_from, dst, hash_copy, tag=tag + ".h", nbits=0, phase=phase)
    got = tp.recv(dst, value_from, tag=tag)
    h = tp.recv(dst, hash_from, tag=tag + ".h")
    if rt.malicious_checks:
        rt.parties[dst].check_equal(got, h, tag)
    return got


def _held_lam(lam: dict, i: int) -> dict:
    """The lambda components party i holds: all but its own (P0: all)."""
    return {j: lam[j] for j in lam if j != i}


# ---------------------------------------------------------------------------
# Pi_Sh (Fig. 1): input sharing by P0.
# ---------------------------------------------------------------------------
def _broadcast_by_p0(rt: FourPartyRuntime, m, *, tag: str, nbits: int,
                     phase: str = "online") -> dict:
    """P0 sends m to every online party (3 elements); recipients
    cross-check H(m) pairwise (0 bits).  Returns {party: copy}."""
    tp = rt.transport
    got = {}
    with tp.round(phase):
        for dst in (1, 2, 3):
            tp.send(0, dst, m, tag=tag, nbits=nbits, phase=phase)
        for dst in (1, 2, 3):
            got[dst] = tp.recv(dst, 0, tag=tag)
        if rt.malicious_checks:
            for dst in (1, 2, 3):
                nxt = 1 + (dst % 3)
                tp.send(dst, nxt, got[dst], tag=tag + ".h", nbits=0,
                        phase=phase)
            for dst in (1, 2, 3):
                prv = 1 + ((dst - 2) % 3)
                h = tp.recv(dst, prv, tag=tag + ".h")
                rt.parties[dst].check_equal(got[dst], h, tag)
    return got


@traced_protocol("share")
def share(rt: FourPartyRuntime, v, owner: int = 0) -> DistAShare:
    """Share ring words `v` (already encoded) held by P0."""
    if owner != 0:
        raise NotImplementedError("runtime Pi_Sh: owner P0 only")
    ring = rt.ring
    v = rt.words(v)
    tag = rt.next_tag("sh")

    def build():
        lam = dict(zip((1, 2, 3), rt.sample_group(
            [(lam_holders(j), v.shape) for j in (1, 2, 3)])))
        return [{"lam": _held_lam(lam, i)} for i in PARTIES]

    parts = rt.prep.acquire(tag, "share", build)
    if rt.prep.skip_online:
        views = [PartyAView(None, dict(parts[i]["lam"])) for i in PARTIES]
        return DistAShare(tuple(views), tuple(v.shape), ring.dtype)
    lam0 = parts[0]["lam"]
    m = v + lam0[1] + lam0[2] + lam0[3]
    got = _broadcast_by_p0(rt, m, tag=tag, nbits=ring.ell)
    views = [PartyAView(None, dict(lam0))]
    for i in (1, 2, 3):
        views.append(PartyAView(got[i], dict(parts[i]["lam"])))
    return DistAShare.from_views(views)


@traced_protocol("share_bool")
def share_bool(rt: FourPartyRuntime, v, owner: int = 0,
               nbits: int | None = None) -> DistBShare:
    """Boolean-share words `v` held by P0 over their low `nbits` bits."""
    if owner != 0:
        raise NotImplementedError("runtime Pi_Sh^B: owner P0 only")
    ring = rt.ring
    nbits = ring.ell if nbits is None else nbits
    v = rt.words(v)
    mask = signed((1 << nbits) - 1, ring.ell)
    tag = rt.next_tag("shB")

    def build():
        lam = {j: d & mask for j, d in zip((1, 2, 3), rt.sample_group(
            [(lam_holders(j), v.shape) for j in (1, 2, 3)]))}
        return [{"lam": _held_lam(lam, i)} for i in PARTIES]

    parts = rt.prep.acquire(tag, "shareB", build)
    if rt.prep.skip_online:
        views = [PartyBView(None, dict(parts[i]["lam"]), nbits)
                 for i in PARTIES]
        return DistBShare(tuple(views), tuple(v.shape), ring.dtype, nbits)
    lam0 = parts[0]["lam"]
    m = (v ^ lam0[1] ^ lam0[2] ^ lam0[3]) & mask
    got = _broadcast_by_p0(rt, m, tag=tag, nbits=nbits)
    views = [PartyBView(None, dict(lam0), nbits)]
    for i in (1, 2, 3):
        views.append(PartyBView(got[i], dict(parts[i]["lam"]), nbits))
    return DistBShare(tuple(views), tuple(v.shape), ring.dtype, nbits)


# ---------------------------------------------------------------------------
# Pi_Rec (Fig. 3): each receiver is missing exactly one component.
# ---------------------------------------------------------------------------
@traced_protocol("reconstruct")
def reconstruct(rt: FourPartyRuntime, x: DistAShare,
                receivers=PARTIES) -> dict:
    """Open [[x]] towards `receivers`; returns {party: ring words}."""
    ring = rt.ring
    tp = rt.transport
    tag = rt.next_tag("rec")        # taken in every mode: tag parity
    if rt.prep.skip_online:
        # dealer pass: opening is pure online; zero placeholders keep
        # programs that post-process the opened words runnable
        zero = torch.zeros(x.shape, dtype=ring.dtype, device=rt.device)
        return {r: zero for r in receivers}
    got = {}
    with tp.round("online"):
        for r in receivers:
            sender, hasher = REC_ROUTE[r]
            if r == 0:
                val, hval = x.views[sender].m, x.views[hasher].m
            else:
                val, hval = x.views[sender].lam[r], x.views[hasher].lam[r]
            got[r] = _jmp(rt, sender, hasher, r, val, hval,
                          tag=f"{tag}.c{r}", nbits=ring.ell, phase="online")
    out = {}
    for r in receivers:
        view = x.views[r]
        m = got[r] if r == 0 else view.m
        lam = dict(view.lam)
        if r != 0:
            lam[r] = got[r]
        out[r] = m - lam[1] - lam[2] - lam[3]
    return out


# ---------------------------------------------------------------------------
# Pi_aSh (Fig. 2): <.>-sharing of a P0-known value, offline phase.
# ---------------------------------------------------------------------------
def _ash_specs(shape) -> list:
    """The two draws of a Pi_aSh of a value of `shape`."""
    return [(s, shape) for s in ASH_SUBSETS]


def _ash_pieces(rt: FourPartyRuntime, v0, *, tag: str,
                phase: str = "offline", drawn=None) -> list:
    """Deal <v0> by P0.  Returns per-party piece dicts {index: value};
    piece i is held by P0 and the pair ASH_HOLDERS[i].  `drawn`: the two
    draws of ``_ash_specs(v0.shape)`` where the caller took them in its
    own group (the same counters in the same order), else None."""
    ring = rt.ring
    tp = rt.transport
    v1, v2 = (rt.sample_group(_ash_specs(v0.shape)) if drawn is None
              else drawn)
    v3 = v0 - v1 - v2
    with tp.round(phase):
        tp.send(0, 1, v3, tag=tag + ".v3", nbits=ring.ell, phase=phase)
        tp.send(0, 2, v3, tag=tag + ".v3", nbits=ring.ell, phase=phase)
        v3_p1 = tp.recv(1, 0, tag=tag + ".v3")
        v3_p2 = tp.recv(2, 0, tag=tag + ".v3")
        if rt.malicious_checks:
            # P1 <-> P2 exchange H(v3): 0 bits.
            tp.send(1, 2, v3_p1, tag=tag + ".h", nbits=0, phase=phase)
            tp.send(2, 1, v3_p2, tag=tag + ".h", nbits=0, phase=phase)
            rt.parties[2].check_equal(tp.recv(2, 1, tag=tag + ".h"), v3_p2,
                                      tag)
            rt.parties[1].check_equal(tp.recv(1, 2, tag=tag + ".h"), v3_p1,
                                      tag)
    return [{1: v1, 2: v2, 3: v3},       # P0 (dealer)
            {2: v2, 3: v3_p1},           # P1
            {1: v1, 3: v3_p2},           # P2
            {1: v1, 2: v2}]              # P3


@traced_protocol("ash_by_p0")
def ash_by_p0(rt: FourPartyRuntime, v0) -> list:
    """Public entry point of Pi_aSh for a P0-known value."""
    return _ash_pieces(rt, rt.words(v0), tag=rt.next_tag("ash"))


# ---------------------------------------------------------------------------
# Pi_Mult / Pi_DotP / Pi_MatMul (+ fused truncation, Figs. 4/9/18).
# ---------------------------------------------------------------------------
def _zero_specs(shape) -> list:
    """The three Pi_Zero draws that mask the gamma pieces of `shape`."""
    return [(s, shape) for s in ZERO_SUBSETS]


def _gamma_exchange(rt: FourPartyRuntime, x: DistAShare, y: DistAShare,
                    op, fs, *, tag: str, kind: str = "mul") -> list:
    """Offline gamma distribution: P0 and GAMMA_LOCAL[j] compute piece j;
    P0 jmp-sends it to GAMMA_RECV[j].  Returns per-party {j: gamma_j}.
    The round's pieces -- P0's three, one at each GAMMA_LOCAL party -- are
    one kernel-backend round call.  `fs`: the ``_zero_specs`` draws, taken
    in the caller's group."""
    ring = rt.ring
    masks = {j: fs[a] - fs[b] for j, (a, b) in AL.GAMMA_MASK_F.items()}
    gamma = _round_pieces(
        lambda reqs: rt.kernels.gamma_pieces_round(kind, op, reqs),
        x, y, masks)
    for j in (1, 2, 3):
        local, recv = GAMMA_LOCAL[j], GAMMA_RECV[j]
        gamma[recv][j] = _jmp(rt, 0, local, recv, gamma[0][j],
                              gamma[local][j], tag=f"{tag}.g{j}",
                              nbits=ring.ell, phase="offline")
    return gamma


def _round_pieces(round_call, x, y, masks: dict) -> list:
    """Per-party {j: gamma_j} from ONE backend round call: a request of
    P0 (pieces 1-3) and one of each GAMMA_LOCAL[j] (piece j), each holding
    only that party's own lambda views."""
    owners = [(0, (1, 2, 3))] + [(GAMMA_LOCAL[j], (j,)) for j in (1, 2, 3)]
    got = round_call([(x.views[p].lam, y.views[p].lam, masks, js)
                      for p, js in owners])
    gamma = [{} for _ in PARTIES]
    for (p, _), pieces in zip(owners, got):
        gamma[p].update(pieces)
    return gamma


def _open_parts(rt: FourPartyRuntime, parts_of, *, tag: str,
                nbits: int) -> dict:
    """Online opening: part j (held by the pair PART_HOLDERS[j]) is
    jmp-sent to P_j.  Returns {i: {j: part_j}} for the online parties."""
    have = {i: {} for i in (1, 2, 3)}
    tp = rt.transport
    with tp.round("online"):
        for j in (1, 2, 3):
            vs, hs = PART_HOLDERS[j]
            have[vs][j] = parts_of(vs, j)
            have[hs][j] = parts_of(hs, j)
            have[j][j] = _jmp(rt, vs, hs, j, have[vs][j], have[hs][j],
                              tag=f"{tag}.p{j}", nbits=nbits, phase="online")
    return have


def _party_parts_js(party: int) -> tuple:
    """The online part indices party computes: j iff it is a holder."""
    return tuple(j for j in (1, 2, 3) if party in PART_HOLDERS[j])


def _mult_like(rt: FourPartyRuntime, x: DistAShare, y: DistAShare,
               contract=None, out_shape=None, truncate: bool = False,
               name: str = "mult", kind: str = "mul") -> DistAShare:
    ring = rt.ring
    tp = rt.transport
    op = as_op(contract)
    if out_shape is None:
        out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
    tag = rt.next_tag(name)

    # ---- offline half (PRF order matches the JAX package) ----------------
    # Each build draws its streams in ONE group, in the JAX package's
    # counter order: no other counter is taken between them.
    if not truncate:
        def build():
            # counter order: lam_z, then gamma's zero shares
            drawn = rt.sample_group(
                [(lam_holders(j), out_shape) for j in (1, 2, 3)]
                + _zero_specs(out_shape))
            lam_z = dict(zip((1, 2, 3), drawn[:3]))
            with tp.round("offline"):
                gamma = _gamma_exchange(rt, x, y, op, drawn[3:], tag=tag,
                                        kind=kind)
            return [{"gamma": dict(gamma[i]), "lam_z": _held_lam(lam_z, i)}
                    for i in PARTIES]
    else:
        def build():
            # counter order: gamma's zero shares, r_j, aSh(r^t); guarded r
            # keeps the opened z - r from wrapping for |z| < 2^{ell-2}
            drawn = rt.sample_group(
                _zero_specs(out_shape)
                + [(lam_holders(j), out_shape, ring.ell - TRUNC_GUARD)
                   for j in (1, 2, 3)] + _ash_specs(out_shape))
            with tp.round("offline"):
                gamma = _gamma_exchange(rt, x, y, op, drawn[:3], tag=tag,
                                        kind=kind)
                r = dict(zip((1, 2, 3), drawn[3:6]))
                r_total = r[1] + r[2] + r[3]              # P0-only knowledge
                pieces = _ash_pieces(rt, ring.truncate(r_total),
                                     tag=tag + ".rt", drawn=drawn[6:])
            _trunc_pair_check(rt, r, pieces, tag=tag)
            return [{"gamma": dict(gamma[i]), "r": _held_lam(r, i),
                     "rt": dict(pieces[i])} for i in PARTIES]

    parts = rt.prep.acquire(tag, name, build)

    def out_lam(i: int) -> dict:
        if truncate:
            return {j: -parts[i]["rt"][j] for j in parts[i]["rt"]}
        return dict(parts[i]["lam_z"])

    if rt.prep.skip_online:
        views = [PartyAView(None, out_lam(i)) for i in PARTIES]
        return DistAShare(tuple(views), tuple(out_shape), ring.dtype)

    # ---- online: every online party's m_x op m_y plus its two m_z' parts
    # is ONE kernel-backend round call ----------------------------------------
    def request(party: int) -> tuple:
        vx, vy = x.views[party], y.views[party]
        js = _party_parts_js(party)
        lam_zs = {j: (-parts[party]["r"][j] if truncate
                      else parts[party]["lam_z"][j]) for j in js}
        return (vx.m, vy.m, vx.lam, vy.lam, parts[party]["gamma"], lam_zs,
                js)

    # i -> (mm, {j: part})
    local = dict(zip((1, 2, 3), rt.kernels.online_parts_round(
        kind, op, [request(i) for i in (1, 2, 3)])))

    have = _open_parts(rt, lambda party, j: local[party][1][j], tag=tag,
                       nbits=ring.ell)
    views = [PartyAView(None, out_lam(0))]
    for i in (1, 2, 3):
        m_z = local[i][0] + have[i][1] + have[i][2] + have[i][3]
        if truncate:
            m_z = ring.truncate(m_z)                      # (z - r)^t, public
        views.append(PartyAView(m_z, out_lam(i)))
    return DistAShare(tuple(views), tuple(out_shape), ring.dtype)


def _trunc_pair_check(rt: FourPartyRuntime, r: dict, pieces: list, *,
                      tag: str) -> None:
    """Lemma D.1 relation r = 2^f r^t + r_d: P1 sends its aggregate to P2
    (1 element, 1 offline round); P2 range-checks with its components."""
    ring = rt.ring
    tp = rt.transport
    a1 = AL.trunc_check_send(r[2], r[3], pieces[1][2], pieces[1][3],
                             ring.frac)
    with tp.round("offline"):
        tp.send(1, 2, a1, tag=tag + ".tc", nbits=ring.ell, phase="offline")
        got = tp.recv(2, 1, tag=tag + ".tc")
    if rt.malicious_checks:
        ok = AL.trunc_check_verify(got, r[1], pieces[2][1], ring.frac)
        rt.parties[2].ledger.record(ok, tag + ".tc")


def _matmul(a, b):
    return torch.matmul(a, b)


def _dot_last(a, b):
    # dtype keeps int32 words int32: torch.sum would promote them to int64
    return torch.sum(a * b, dim=-1, dtype=a.dtype)


@traced_protocol("mult")
def mult(rt: FourPartyRuntime, x: DistAShare, y: DistAShare) -> DistAShare:
    """Pi_Mult (Fig. 4): elementwise product, no truncation."""
    return _mult_like(rt, x, y, name="mult")


@traced_protocol("dotp")
def dotp(rt: FourPartyRuntime, x: DistAShare, y: DistAShare) -> DistAShare:
    """Pi_DotP (Fig. 9): wire cost independent of the vector length."""
    out_shape = tuple(torch.broadcast_shapes(x.shape, y.shape))[:-1]
    return _mult_like(rt, x, y, contract=_dot_last, out_shape=out_shape,
                      name="dotp", kind="dotp")


@traced_protocol("matmul")
def matmul(rt: FourPartyRuntime, x: DistAShare, y: DistAShare) -> DistAShare:
    return _mult_like(rt, x, y, contract=_matmul,
                      out_shape=matmul_shape(x.shape, y.shape), name="matmul",
                      kind="matmul")


@traced_protocol("mult_tr")
def mult_tr(rt: FourPartyRuntime, x: DistAShare, y: DistAShare) -> DistAShare:
    """Pi_MultTr (Fig. 18): multiplication with free truncation."""
    return _mult_like(rt, x, y, truncate=True, name="multtr")


@traced_protocol("matmul_tr")
def matmul_tr(rt: FourPartyRuntime, x: DistAShare,
              y: DistAShare) -> DistAShare:
    """[[X]] @ [[Y]] with fused truncation (the PPML workhorse)."""
    return _mult_like(rt, x, y, contract=_matmul,
                      out_shape=matmul_shape(x.shape, y.shape), truncate=True,
                      name="matmultr", kind="matmul")


@traced_protocol("truncate")
def truncate_share(rt: FourPartyRuntime, x: DistAShare) -> DistAShare:
    """Standalone truncation by a (r, r^t) pair."""
    ring = rt.ring
    tag = rt.next_tag("trunc")
    out_shape = x.shape

    def build():
        # r_j and aSh(r^t)'s draws in one group (counter order kept)
        drawn = rt.sample_group(
            [(lam_holders(j), out_shape, ring.ell - TRUNC_GUARD)
             for j in (1, 2, 3)] + _ash_specs(out_shape))
        r = dict(zip((1, 2, 3), drawn[:3]))
        pieces = _ash_pieces(rt, ring.truncate(r[1] + r[2] + r[3]),
                             tag=tag + ".rt", drawn=drawn[3:])
        _trunc_pair_check(rt, r, pieces, tag=tag)
        return [{"r": _held_lam(r, i), "rt": dict(pieces[i])}
                for i in PARTIES]

    parts = rt.prep.acquire(tag, "trunc", build)

    def out_lam(i: int) -> dict:
        return {j: -v for j, v in parts[i]["rt"].items()}

    if rt.prep.skip_online:
        views = [PartyAView(None, out_lam(i)) for i in PARTIES]
        return DistAShare(tuple(views), tuple(out_shape), ring.dtype)

    # online: open z - r via the part routing (part j = -(lam_j + r_j))
    def parts_of(party: int, j: int):
        return -(x.views[party].lam[j] + parts[party]["r"][j])

    have = _open_parts(rt, parts_of, tag=tag, nbits=ring.ell)
    views = [PartyAView(None, out_lam(0))]
    for i in (1, 2, 3):
        z_minus_r = x.views[i].m + have[i][1] + have[i][2] + have[i][3]
        views.append(PartyAView(ring.truncate(z_minus_r), out_lam(i)))
    return DistAShare(tuple(views), tuple(out_shape), ring.dtype)


def scale_public(rt: FourPartyRuntime, x: DistAShare, c: float) -> DistAShare:
    """[[x]] * c for a public real constant: local mul + one truncation."""
    return truncate_share(rt, x.mul_public(rt.encode(c)))


# ---------------------------------------------------------------------------
# Pi_vSh (Fig. 7): sharing of a value two parties both know.  The masked
# value is jmp-sent to every non-owner online party.  A phase="offline"
# vSh runs its exchange inside the prep build, so its record carries the
# masked value too; a phase="online" one is data-dependent and exchanges
# online over prep lambdas (in deal mode it stops at the lambdas and
# val_of is never called).  The caller provides the round scope so
# parallel vSh instances share one round.
# ---------------------------------------------------------------------------
def _vsh_lam_parts(rt: FourPartyRuntime, owners: tuple, shape,
                   mask=None) -> tuple:
    """Sample the three vSh lambda streams and slice per party: P_i keeps
    lambda_j iff it is in the sampling subset."""
    drawn = rt.sample_group([(PARTIES if j in owners else lam_holders(j),
                              shape) for j in (1, 2, 3)])
    lam = {j: d if mask is None else d & mask
           for j, d in zip((1, 2, 3), drawn)}
    parts = [{"lam": {j: lam[j] for j in (1, 2, 3)
                      if j != i or j in owners}} for i in PARTIES]
    return lam, parts


def _vsh_exchange(rt: FourPartyRuntime, val_of, owners: tuple, lam_of,
                  *, tag: str, nbits: int, phase: str, xor: bool) -> dict:
    """Mask the owners' value and jmp-send it to each non-owner online
    party; returns {online party: masked value}."""
    non_owners = tuple(i for i in (1, 2, 3) if i not in owners)
    m_owner = {}
    for p in owners:
        lam = lam_of(p)
        v = val_of(p)
        m_owner[p] = (v ^ lam[1] ^ lam[2] ^ lam[3]) if xor \
            else v + lam[1] + lam[2] + lam[3]
    m = dict(m_owner)
    vf, hf = owners
    for dst in non_owners:
        t = tag if len(non_owners) == 1 else f"{tag}.m{dst}"
        m[dst] = _jmp(rt, vf, hf, dst, m_owner[vf], m_owner[hf],
                      tag=t, nbits=nbits, phase=phase)
    return m


def _vsh(rt: FourPartyRuntime, val_of, owners: tuple, shape, *, tag: str,
         phase: str = "online") -> DistAShare:
    ring = rt.ring

    def build():
        lam, parts = _vsh_lam_parts(rt, owners, shape)
        if phase == "offline":
            m = _vsh_exchange(rt, val_of, owners, lambda p: lam,
                              tag=tag, nbits=ring.ell, phase=phase,
                              xor=False)
            for i in (1, 2, 3):
                parts[i]["m"] = m[i]
        return parts

    parts = rt.prep.acquire(tag, f"vsh.{phase}", build)
    if phase == "offline":
        m = {i: parts[i]["m"] for i in (1, 2, 3)}
    elif rt.prep.skip_online:
        m = {i: None for i in (1, 2, 3)}
    else:
        m = _vsh_exchange(rt, val_of, owners, lambda p: parts[p]["lam"],
                          tag=tag, nbits=ring.ell, phase=phase, xor=False)
    views = [PartyAView(None if i == 0 else m[i],
                        {j: parts[i]["lam"][j] for j in (1, 2, 3) if j != i})
             for i in PARTIES]
    return DistAShare(tuple(views), tuple(shape), ring.dtype)


# ---------------------------------------------------------------------------
# B2A (Fig. 16): boolean -> arithmetic, constant online rounds.
# ---------------------------------------------------------------------------
@traced_protocol("b2a")
def b2a(rt: FourPartyRuntime, v: DistBShare) -> DistAShare:
    ring = rt.ring
    tp = rt.transport
    ell = v.nbits
    shape = v.shape
    tag = rt.next_tag("b2a")

    def build():
        # offline: aSh of the lambda bit-planes (P0 knows every lambda)
        lam_word0 = (v.views[0].lam[1] ^ v.views[0].lam[2]
                     ^ v.views[0].lam[3])
        pieces = _ash_pieces(rt, bit_planes(lam_word0, 0, ell),
                             tag=tag + ".p")
        # offline round 2: the Fig. 15/16 verification of <p>.  P3 sends
        # v1+v2 (ell elements); P2 sends the lambda_1 bit-planes (1 bit
        # each); P1 completes lambda_b and checks the sum.
        with tp.round("offline"):
            agg = pieces[3][1] + pieces[3][2]
            tp.send(3, 1, agg, tag=tag + ".ck", nbits=ring.ell,
                    phase="offline")
            l1_bits = bit_planes(v.views[2].lam[1], 0, ell)
            tp.send(2, 1, l1_bits, tag=tag + ".l1", nbits=1,
                    phase="offline")
            got_agg = tp.recv(1, 3, tag=tag + ".ck")
            got_l1 = tp.recv(1, 2, tag=tag + ".l1")
        if rt.malicious_checks:
            s = got_agg + pieces[1][3]
            lam_b = got_l1 ^ bit_planes(v.views[1].lam[2]
                                        ^ v.views[1].lam[3], 0, ell)
            rt.parties[1].check_equal(s, lam_b, tag + ".ck")
        return [{"p": dict(pieces[i])} for i in PARTIES]

    parts = rt.prep.acquire(tag, "b2a", build)

    # ---- online: compose x/y/z and vSh them (one parallel round) ---------
    pow2 = torch.tensor([signed(1 << i, ring.ell) for i in range(ell)],
                        dtype=ring.dtype, device=rt.device)
    pow2 = pow2.reshape((ell,) + (1,) * len(shape))

    out = None
    with tp.round("online"):
        for k, (piece, include_q, owners) in enumerate(B2A_VALS):
            def val_of(party, piece=piece, include_q=include_q):
                return AL.b2a_val(bit_planes(v.views[party].m, 0, ell),
                                  parts[party]["p"][piece], pow2, include_q,
                                  ring.dtype)
            sh = _vsh(rt, val_of, owners, shape, tag=f"{tag}.v{k}")
            out = sh if out is None else out.add(sh)
    return out
