"""Branchless boolean FHP collision algebra, generated from the rule table.

The paper implements scattering as a 256-entry LUT (one gather per node).
Per-element gathers are catastrophic on the TPU VPU, so the TPU-native
formulation evaluates the *same* rule table as pure AND/OR/NOT/XOR over bit
planes: every bit lane of every word is an independent lattice node, so a
``(H, W/32)`` uint32 array processes 32 nodes per lane x (8, 128) lanes per
vector op -- the faithful analogue of the paper's 32-nodes-per-AVX-register.

``collide_planes`` is generated *from* ``rules.fhp2_rules()`` (the same
source as the LUT), so LUT path == boolean path is checked by construction
in the tests, not by hand-derived algebra.

The functions are representation-agnostic: inputs may be packed uint32 words
(32 nodes/lane) or {0,1}-valued arrays of any integer dtype (1 node/lane);
every AND-chain contains at least one positive literal, so values stay in
the lanes they started in.
"""
from __future__ import annotations

from typing import Any, List, Sequence

from repro_torch.core import rules

# Operands are anything with ``& | ^ ~``: torch int32 bit-view tensors,
# numpy arrays, or the symbolic words of ``kernels/fhp_step/codegen.py``.
Words = Any


def _cond(a: Sequence[Words], r: rules.Rule) -> Words:
    """Exact-match condition of one rule over the moving planes (+ rest)."""
    # Start from a positive literal to keep high bit-lanes clean.
    pos = sorted(r.moving_in)
    c = a[pos[0]]
    for i in pos[1:]:
        c = c & a[i]
    for i in range(rules.N_DIR):
        if i not in r.moving_in:
            c = c & ~a[i]
    if r.rest_in is True:
        c = c & a[rules.REST_BIT]
    elif r.rest_in is False:
        c = c & ~a[rules.REST_BIT]
    return c


def collide_planes(planes: Sequence[Words], chi: Words,
                   variant: str = "fhp2") -> List[Words]:
    """Apply FHP collisions to 8 bit planes; ``chi`` = chirality bits.

    planes: [a0..a5 moving, rest, solid]; returns the same layout.
    Solid lanes get full bounce-back (i -> i+3), rest/solid unchanged there.
    The algebra is generated from ``rules.fhp_rules(variant)`` -- the same
    table that builds the LUT, so the two paths agree by construction.
    """
    a = list(planes)
    solid = a[rules.SOLID_BIT]
    rs = rules.fhp_rules(variant)
    conds = [_cond(a, r) for r in rs]

    fired = conds[0]
    for c in conds[1:]:
        fired = fired | c

    new_mov: List[Words] = []
    for j in range(rules.N_DIR):
        acc = a[j] & ~fired
        for r, c in zip(rs, conds):
            in0 = j in r.out_c0
            in1 = j in r.out_c1
            if in0 and in1:
                acc = acc | c
            elif in0:
                acc = acc | (c & ~chi)
            elif in1:
                acc = acc | (c & chi)
        new_mov.append(acc)

    clear = None
    set_ = None
    for r, c in zip(rs, conds):
        r0, r1 = r.rest_outs()
        for rout, cc in ((r0, None), (r1, None)) if r0 == r1 else \
                ((r0, ~chi), (r1, chi)):
            branch = c if cc is None else (c & cc)
            if rout is False:
                clear = branch if clear is None else (clear | branch)
            elif rout is True:
                set_ = branch if set_ is None else (set_ | branch)
            if cc is None:
                break  # achiral rest: one branch covers both
    new_rest = a[rules.REST_BIT]
    if clear is not None:
        new_rest = new_rest & ~clear
    if set_ is not None:
        new_rest = new_rest | set_

    out: List[Words] = []
    for j in range(rules.N_DIR):
        bounced = solid & a[rules.opposite(j)]
        out.append(bounced | (~solid & new_mov[j]))
    out.append((solid & a[rules.REST_BIT]) | (~solid & new_rest))
    out.append(solid)
    return out


def force_planes(planes: Sequence[Words], accel: Words) -> List[Words]:
    """Body force on planes: reverse W-movers into E-movers where ``accel``."""
    a = list(planes)
    cond = a[3] & ~a[0] & ~a[rules.SOLID_BIT] & accel
    a[3] = a[3] ^ cond
    a[0] = a[0] | cond
    return a
