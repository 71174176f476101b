"""FHP-II rule system: directions, lattice offsets, collision rules, LUT builder.

State encoding (paper Fig. 1): bits 0-5 = moving particles along the six
triangular-lattice directions, bit 6 = rest particle, bit 7 = solid/boundary
flag.  A node state is one byte.

Direction layout (angle = 60 deg * i, y points "north"):

    i : 0=E, 1=NE, 2=NW, 3=W, 4=SW, 5=SE

Doubled integer coordinates keep momentum arithmetic exact:
    c_i = (cx2[i]/2, cy[i]*sqrt(3)/2);  we track (cx2, cy) integers.

The triangular lattice is mapped onto a rectangular array (paper Fig. 3) with
odd rows shifted right by half a lattice constant.  Neighbour x-offsets then
depend on the row parity of the *source* node; see OFFSETS.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import FrozenSet, Optional, Tuple

import numpy as np

N_DIR = 6
REST_BIT = 6
SOLID_BIT = 7
MOVING_MASK = 0x3F
REST_MASK = 1 << REST_BIT
SOLID_MASK = 1 << SOLID_BIT

# Doubled x-momentum and (unit sqrt(3)/2) y-momentum per direction.
CX2 = np.array([2, 1, -1, -2, -1, 1], dtype=np.int64)
CY = np.array([0, 1, 1, 0, -1, -1], dtype=np.int64)

# OFFSETS[k][parity] = (dx, dy) of the neighbour a particle moving along k
# reaches, where parity = source row index & 1 (odd rows shifted right).
OFFSETS: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...] = (
    ((1, 0), (1, 0)),      # 0 E
    ((0, 1), (1, 1)),      # 1 NE
    ((-1, 1), (0, 1)),     # 2 NW
    ((-1, 0), (-1, 0)),    # 3 W
    ((-1, -1), (0, -1)),   # 4 SW
    ((0, -1), (1, -1)),    # 5 SE
)


def opposite(i: int) -> int:
    return (i + 3) % N_DIR


def rotate_set(dirs: FrozenSet[int], by: int) -> FrozenSet[int]:
    return frozenset((d + by) % N_DIR for d in dirs)


@dataclasses.dataclass(frozen=True)
class Rule:
    """One exact-match collision rule.

    A rule fires on a fluid node whose *moving* bit set equals
    ``moving_in`` and (if ``rest_in`` is not None) whose rest bit equals
    ``rest_in``.  ``out_c0``/``out_c1`` are the two chirality-resolved
    output moving sets (equal when the rule is achiral); ``rest_out`` is
    the new rest bit, None for "unchanged", or a per-chirality
    ``(r0, r1)`` tuple (FHP-III's rotate-vs-split outcomes differ in
    rest-particle count).
    """

    moving_in: FrozenSet[int]
    rest_in: Optional[bool]
    out_c0: FrozenSet[int]
    out_c1: FrozenSet[int]
    rest_out: object
    name: str

    def rest_outs(self) -> Tuple[Optional[bool], Optional[bool]]:
        if isinstance(self.rest_out, tuple):
            return self.rest_out
        return (self.rest_out, self.rest_out)


def fhp2_rules() -> Tuple[Rule, ...]:
    """The FHP-II rule table (2-body, 3-body, 4-body, rest exchange)."""
    rules = []
    # Two-body head-on: {i, i+3} -> rotate the pair by +/-60deg.  The rest
    # particle, if present, is a spectator (rest_in=None).
    for i in range(3):
        pair = frozenset({i, opposite(i)})
        rules.append(Rule(pair, None, rotate_set(pair, 1), rotate_set(pair, -1),
                          None, f"head-on-{i}"))
    # Three-body symmetric: {i, i+2, i+4} -> the complementary triple.
    for i in range(2):
        tri = frozenset({i, (i + 2) % 6, (i + 4) % 6})
        rules.append(Rule(tri, None, rotate_set(tri, 1), rotate_set(tri, 1),
                          None, f"triple-{i}"))
    # Four-body (two head-on pairs): particle-hole dual of 2-body.
    for i in range(3):
        quad = frozenset({i, (i + 1) % 6, opposite(i), (opposite(i) + 1) % 6})
        rules.append(Rule(quad, None, rotate_set(quad, 1), rotate_set(quad, -1),
                          None, f"four-body-{i}"))
    # Rest exchange: {i} + rest <-> {i-1, i+1}.  c_{i-1}+c_{i+1} = c_i.
    for i in range(N_DIR):
        single = frozenset({i})
        split = frozenset({(i - 1) % 6, (i + 1) % 6})
        rules.append(Rule(single, True, split, split, False, f"rest-split-{i}"))
        rules.append(Rule(split, False, single, single, True, f"rest-merge-{i}"))
    return tuple(rules)


def fhp3_rules() -> Tuple[Rule, ...]:
    """FHP-III-style extension: additional mass-3 conversion channels
    (head-on pair + rest <-> symmetric triple), raising the collision
    saturation (lower viscosity).  One chirality bit selects among two
    members of each outcome class -- the full FHP-III table randomises
    over all class members, so this is the 1-bit restriction of it
    (documented approximation; conservation is still audited per entry).
    """
    t0 = frozenset({0, 2, 4})
    t1 = frozenset({1, 3, 5})
    rules = []
    for i in range(3):
        pair = frozenset({i, opposite(i)})
        # head-on without rest: rotate (as FHP-II, but rest now excluded)
        rules.append(Rule(pair, False, rotate_set(pair, 1),
                          rotate_set(pair, -1), None, f"head-on-{i}"))
        # head-on + rest -> one of the symmetric triples (fusion)
        rules.append(Rule(pair, True, t0, t1, False, f"pair-rest-fuse-{i}"))
    # triple without rest: chirality picks rotate (rest stays 0) vs
    # fission into a head-on pair + rest particle
    rules.append(Rule(t0, False, t1, frozenset({0, 3}), (None, True),
                      "triple0"))
    rules.append(Rule(t1, False, t0, frozenset({1, 4}), (None, True),
                      "triple1"))
    # triple + rest: rotate with spectator (as FHP-II)
    rules.append(Rule(t0, True, t1, t1, None, "triple0-rot"))
    rules.append(Rule(t1, True, t0, t0, None, "triple1-rot"))
    for i in range(3):
        quad = frozenset({i, (i + 1) % 6, opposite(i), (opposite(i) + 1) % 6})
        rules.append(Rule(quad, None, rotate_set(quad, 1), rotate_set(quad, -1),
                          None, f"four-body-{i}"))
    for i in range(N_DIR):
        single = frozenset({i})
        split = frozenset({(i - 1) % 6, (i + 1) % 6})
        rules.append(Rule(single, True, split, split, False, f"rest-split-{i}"))
        rules.append(Rule(split, False, single, single, True, f"rest-merge-{i}"))
    return tuple(rules)


def fhp_rules(variant: str = "fhp2") -> Tuple[Rule, ...]:
    if variant == "fhp2":
        return fhp2_rules()
    if variant == "fhp3":
        return fhp3_rules()
    raise ValueError(variant)


def _set_to_bits(s: FrozenSet[int]) -> int:
    out = 0
    for d in s:
        out |= 1 << d
    return out


def mass_of(state: int) -> int:
    return bin(state & (MOVING_MASK | REST_MASK)).count("1")


def momentum_of(state: int) -> Tuple[int, int]:
    px2 = 0
    py = 0
    for i in range(N_DIR):
        if state & (1 << i):
            px2 += int(CX2[i])
            py += int(CY[i])
    return px2, py


def bounce_back(state: int) -> int:
    """Full bounce-back of the moving bits (i -> i+3); rest/solid unchanged."""
    m = state & MOVING_MASK
    rev = ((m >> 3) | (m << 3)) & MOVING_MASK
    return (state & ~MOVING_MASK & 0xFF) | rev


@lru_cache(maxsize=None)
def build_lut(variant: str = "fhp2") -> np.ndarray:
    """Build the 2x256 collision LUT (axis 0 = chirality bit).

    Verifies mass and momentum conservation for every fluid entry and
    mass conservation + momentum reversal for solid entries.
    """
    rules = fhp_rules(variant)
    # Exact-match patterns must be mutually exclusive.
    seen = {}
    for r in rules:
        for rest in ([r.rest_in] if r.rest_in is not None else [False, True]):
            key = (_set_to_bits(r.moving_in), rest)
            if key in seen:
                raise ValueError(f"rule overlap: {r.name} vs {seen[key]}")
            seen[key] = r.name

    lut = np.zeros((2, 256), dtype=np.uint8)
    for s in range(256):
        if s & SOLID_MASK:
            out0 = out1 = bounce_back(s)
        else:
            moving = frozenset(i for i in range(N_DIR) if s & (1 << i))
            rest = bool(s & REST_MASK)
            out0 = out1 = s
            for r in rules:
                if r.moving_in == moving and (r.rest_in is None or r.rest_in == rest):
                    r0, r1 = r.rest_outs()
                    rest0 = rest if r0 is None else r0
                    rest1 = rest if r1 is None else r1
                    out0 = _set_to_bits(r.out_c0) | (REST_MASK if rest0 else 0)
                    out1 = _set_to_bits(r.out_c1) | (REST_MASK if rest1 else 0)
                    break
        lut[0, s] = out0
        lut[1, s] = out1

    # --- conservation audit (runs once, cached) ---
    for chi in range(2):
        for s in range(256):
            o = int(lut[chi, s])
            if s & SOLID_MASK:
                assert o & SOLID_MASK, (chi, s, o)
                assert mass_of(o & 0x7F) == mass_of(s & 0x7F), (chi, s, o)
                pin, pout = momentum_of(s), momentum_of(o)
                assert pout == (-pin[0], -pin[1]), (chi, s, o)
            else:
                assert not (o & SOLID_MASK)
                assert mass_of(o) == mass_of(s), (chi, s, o)
                assert momentum_of(o) == momentum_of(s), (chi, s, o)
    return lut


def lut_flat(variant: str = "fhp2") -> np.ndarray:
    """LUT flattened to (512,) with index = chirality<<8 | state."""
    return build_lut(variant).reshape(512).copy()
