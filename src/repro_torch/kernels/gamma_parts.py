"""Grouped elementwise gamma-piece / online-part kernel and its plain
PyTorch versions (``repro/kernels/gamma_parts.py``).

One launch of the kernel (``csrc/gamma_parts.cu``) evaluates up to
``MAX_GROUPS`` groups, each

    ring (mult_terms):  out = sum_k c_k + sum_t signs[t] a_t b_t  mod 2^ell
    XOR  (and_terms):   out = XOR_k c_k ^ XOR_t (a_t & b_t)

over 1 to ``MAX_TERMS`` term pairs and 0 to ``MAX_CONSTS`` constants.  A
group is given as ``(pairs, consts, signs)`` -- ``signs`` a +-1 per pair in
ring mode, None in XOR mode -- with every operand a tensor that broadcasts
to the group's shape.  The kernel reads each operand where it lies: a
contiguous tensor of the group's shape, or one word broadcast; any other
layout (an expanded view) is made contiguous first.

The JAX package's stacked form, ``(J, T, n)`` operand stacks ``a, b`` and
``(J, n)`` constants ``c``, is ``mult_terms_plain``/``and_terms_plain``:
one group per row.  Ring arithmetic wraps in the storage type and XOR/AND
are bitwise, so the kernel equals the plain versions word for word.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from .build import check_operands, launch

MAX_GROUPS = 16          # kMaxGroups of the kernel
MAX_TERMS = 3
MAX_CONSTS = 2
ALIGN = 16               # bytes of one vector access

_SUFFIX = {torch.int64: "u64", torch.int32: "u32"}
_P = ctypes.c_void_p


class _TermGroup(ctypes.Structure):
    _fields_ = [("a", _P * MAX_TERMS), ("b", _P * MAX_TERMS),
                ("c", _P * MAX_CONSTS), ("out", _P),
                ("n", ctypes.c_int64), ("first_tile", ctypes.c_int32),
                ("terms", ctypes.c_int32), ("consts", ctypes.c_int32),
                ("neg", ctypes.c_uint32), ("bcast", ctypes.c_uint32),
                ("vec", ctypes.c_uint32)]


class _TermLaunch(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int32), ("tiles", ctypes.c_int32),
                ("g", _TermGroup * MAX_GROUPS)]


# _TermGroup's layout for struct.pack_into: filling the table through
# ctypes field by field costs several times the host time
_PACK = struct.Struct(f"<{2 * MAX_TERMS + MAX_CONSTS + 1}Qq3i3I")
assert _PACK.size == ctypes.sizeof(_TermGroup)



# -- plain versions ---------------------------------------------------------
def mult_terms_plain(a, b, c, signs) -> torch.Tensor:
    acc = c
    for t, s in enumerate(signs):
        term = a[:, t] * b[:, t]
        acc = acc - term if s < 0 else acc + term
    return acc


def and_terms_plain(a, b, c) -> torch.Tensor:
    acc = c
    for t in range(a.shape[1]):
        acc = acc ^ (a[:, t] & b[:, t])
    return acc


def group_shape(group) -> tuple:
    """The shape every operand of `group` broadcasts to (NumPy's rule;
    plain Python: ``torch.broadcast_shapes`` costs more host time than
    the launch)."""
    pairs, consts, *_ = group
    shapes = [t.shape for pair in pairs for t in pair]
    shapes += [c.shape for c in consts]
    first = shapes[0]
    if all(s == first for s in shapes):
        return tuple(first)
    out = [1] * max(len(s) for s in shapes)
    for s in shapes:
        for i, d in enumerate(s, len(out) - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def mult_terms_group_plain(groups) -> list:
    """One tensor per ``(pairs, consts, signs)`` group (ring mode)."""
    out = []
    for pairs, consts, signs in groups:
        acc = None
        for c in consts:
            acc = c if acc is None else acc + c
        for (a, b), s in zip(pairs, signs):
            term = a * b
            if acc is None:
                acc = -term if s < 0 else term
            else:
                acc = acc - term if s < 0 else acc + term
        out.append(acc)
    return out


def and_terms_group_plain(groups) -> list:
    """One tensor per ``(pairs, consts)`` group (XOR mode; a third item,
    the ring's signs, is ignored)."""
    out = []
    for pairs, consts, *_ in groups:
        acc = None
        for t in [*consts, *(a & b for a, b in pairs)]:
            acc = t if acc is None else acc ^ t
        out.append(acc)
    return out


# -- the kernel ---------------------------------------------------------------
def group_outputs(shapes, dtype: torch.dtype, device) -> list:
    """One output tensor per shape: views of ONE buffer, each starting on
    an ALIGN-byte boundary so the kernel may store 16 bytes at a time."""
    step = ALIGN // dtype.itemsize
    views, off = [], 0
    for s in shapes:
        strides, n = [], 1
        for d in reversed(s):
            strides.insert(0, n)
            n *= d
        views.append((s, tuple(strides), off))
        off += -(-n // step) * step
    buf = torch.empty(off, dtype=dtype, device=device)
    return [buf.as_strided(s, st, o) for s, st, o in views]


def _operand(t: torch.Tensor, shape, made: dict) -> tuple:
    """(address the kernel reads, one-word broadcast?) for operand `t` of
    a group of `shape`; an expanded view becomes one contiguous copy, made
    once per call and kept in `made` until the launch is queued."""
    if t.shape == shape and t.is_contiguous():
        return t.data_ptr(), False
    if t.numel() == 1:
        return t.data_ptr(), True
    v = t.broadcast_to(shape)
    if not v.is_contiguous():
        key = (t.data_ptr(), tuple(t.shape), t.stride(), shape)
        if key not in made:
            made[key] = v.contiguous()
        v = made[key]
    return v.data_ptr(), False


def describe_groups(groups, outs, made: dict | None = None) -> _TermLaunch:
    """The descriptor table of ONE launch: `groups` as ``(pairs, consts,
    signs)`` (signs None in XOR mode) and `outs` their outputs (contiguous,
    of each group's shape, to which every operand must broadcast).  Groups
    of no words are left out.  Raises on what the kernel does not take."""
    if len(groups) != len(outs):
        raise ValueError(f"{len(groups)} groups, {len(outs)} outputs")
    made = {} if made is None else made
    desc = _TermLaunch()
    k = 0
    for (pairs, consts, signs), out in zip(groups, outs):
        if not 1 <= len(pairs) <= MAX_TERMS:
            raise ValueError(f"a group takes 1 to {MAX_TERMS} term pairs, "
                             f"got {len(pairs)}")
        if len(consts) > MAX_CONSTS:
            raise ValueError(f"a group takes at most {MAX_CONSTS} "
                             f"constants, got {len(consts)}")
        if signs is not None and (len(signs) != len(pairs) or any(
                s not in (1, -1) for s in signs)):
            raise ValueError(f"signs {signs} for {len(pairs)} term pairs")
        if not out.is_contiguous():
            raise ValueError("the outputs must be contiguous")
        n = out.numel()
        if n == 0:
            continue
        if k == MAX_GROUPS:
            raise ValueError(f"one launch takes at most {MAX_GROUPS} groups")
        shape = out.shape
        streamed = [out.data_ptr()]          # 16-byte aligned for vec
        a, b, c = [0] * MAX_TERMS, [0] * MAX_TERMS, [0] * MAX_CONSTS
        bcast = 0
        for t, (x, y) in enumerate(pairs):
            (a[t], one_x), (b[t], one_y) = (_operand(x, shape, made),
                                            _operand(y, shape, made))
            bcast |= one_x << t | one_y << (3 + t)
            streamed += [p for p, one in ((a[t], one_x), (b[t], one_y))
                         if not one]
        for i, z in enumerate(consts):
            c[i], one_z = _operand(z, shape, made)
            bcast |= one_z << (6 + i)
            if not one_z:
                streamed.append(c[i])
        neg = sum(1 << t for t, s in enumerate(signs or ()) if s < 0)
        _PACK.pack_into(desc, _TermLaunch.g.offset + k * _PACK.size, *a, *b,
                        *c, streamed[0], n, 0, len(pairs), len(consts), neg,
                        bcast, int(all(p % ALIGN == 0 for p in streamed)))
        k += 1
    desc.count = k
    return desc


def terms_group_cuda(xor: bool, groups, outs) -> bool:
    """ONE launch of the kernel over `groups` (at most MAX_GROUPS), writing
    `outs` (see ``describe_groups``).  Returns False, launching nothing,
    when every group is empty; raises if the launch is refused."""
    tensors = [t for pairs, consts, _ in groups
               for t in (*(x for pair in pairs for x in pair), *consts)]
    check_operands(*tensors, *outs, contiguous=False)
    dtype = outs[0].dtype
    if dtype not in _SUFFIX:
        raise ValueError(f"the grouped kernel takes int64/int32 words, got "
                         f"{dtype}")
    made: dict = {}                # contiguous copies, alive to the launch
    desc = describe_groups(groups, outs, made)
    if desc.count == 0:
        return False
    symbol = f"{'and' if xor else 'mult'}_terms_group_{_SUFFIX[dtype]}"
    launch("gamma_parts", symbol, outs[0].device, ctypes.addressof(desc))
    return True
