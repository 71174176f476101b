"""Plain reference of the two lattice gases the benchmark runs, one byte
per node (the paper's Fig. 1 encoding), in plain PyTorch.

FHP-II (Frisch et al., Complex Systems 1:649, 1987) on the triangular
lattice mapped onto a rectangular array, odd rows shifted east by half a
lattice constant: bits 0-5 are the particles moving E, NE, NW, W, SW, SE,
bit 6 the rest particle, bit 7 the solid flag.  One step is

    stream  ->  collide (a 2 x 256 table, chirality-resolved;
                solid nodes bounce back)  ->  force (W-mover -> E-mover)

BML traffic (Biham, Middleton and Levine, Phys. Rev. A 46, R6124, 1992):
bit 0 an east-bound car, bit 1 a north-bound car; on even t every east car
whose cell at x+1 is empty moves, on odd t every north car whose cell at
y+1 is empty moves.

Randomness is counter-based: one murmur3-finalised 32-bit word per
(t, row, word of 32 nodes, salt), bit b of word w belonging to node
32 w + b.  The chirality of a node is its bit of the salt-0x11 word.  The
force fires where a 16-bit uniform, bit i taken from the word of salt
0x2200 + i, lies below round(p * 65536).

This module is frozen with the benchmark: it imports nothing of the
program, and it works on whole integers in int64 (no 32-bit wrap-around)
and on a lookup table (no boolean circuit), so it shares neither the
program's word arithmetic nor its generated circuits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

WORD = 32
N_DIR, REST, SOLID = 6, 6, 7
# Doubled x and (sqrt(3)/2-unit) y momentum of each direction.
CX2 = (2, 1, -1, -2, -1, 1)
CY = (0, 1, 1, 0, -1, -1)
# OFFSETS[k][p]: the (dx, dy) a particle moving along k reaches from a
# source row of parity p.
OFFSETS = (((1, 0), (1, 0)), ((0, 1), (1, 1)), ((-1, 1), (0, 1)),
           ((-1, 0), (-1, 0)), ((-1, -1), (0, -1)), ((0, -1), (1, -1)))

MASK32 = 0xFFFFFFFF
_M1, _M2, _GOLD, _FNV = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x01000193
CHIRALITY_SALT = 0x11
FORCE_SALT = 0x22
FORCE_BITS = 16

# The moment rows the program's fused moments carry, in its order.
MOMENT_ROWS = {"fhp2": ("mass", "solid", "px2", "py"),
               "bml": ("mass", "plane0", "plane1", "excl0_1")}
N_BITS = {"fhp2": 8, "bml": 2}


# ---------------------------------------------------------------------------
# Collision table.
# ---------------------------------------------------------------------------

def _bits(dirs) -> int:
    return sum(1 << (d % N_DIR) for d in dirs)


def _rot(dirs, by: int):
    return [(d + by) % N_DIR for d in dirs]


def fhp2_table() -> np.ndarray:
    """The (2, 256) FHP-II collision table, axis 0 the chirality bit.

    Fluid nodes: head-on pairs and the four-body states turn by +60 deg
    (chirality 0) or -60 deg (chirality 1); the symmetric triples turn by
    60 deg; a mover beside a rest particle splits into the two movers at
    +-60 deg, and that pair with no rest particle merges back.  A rest
    particle is a spectator of the first three.  Solid nodes reverse every
    mover.  Every entry is checked for mass and momentum."""
    out = {}
    for i in range(3):
        pair = [i, i + 3]
        out[(_bits(pair), None)] = (_bits(_rot(pair, 1)),
                                    _bits(_rot(pair, -1)), None)
        quad = [i, i + 1, i + 3, i + 4]
        out[(_bits(quad), None)] = (_bits(_rot(quad, 1)),
                                    _bits(_rot(quad, -1)), None)
    for i in range(2):
        tri = [i, i + 2, i + 4]
        out[(_bits(tri), None)] = (_bits(_rot(tri, 1)),) * 2 + (None,)
    for i in range(N_DIR):
        single, split = _bits([i]), _bits([i - 1, i + 1])
        out[(single, True)] = (split, split, False)
        out[(split, False)] = (single, single, True)

    table = np.zeros((2, 256), np.uint8)
    for s in range(256):
        moving, rest = s & 0x3F, bool(s & (1 << REST))
        for chi in range(2):
            if s & (1 << SOLID):
                rev = ((moving >> 3) | (moving << 3)) & 0x3F
                table[chi, s] = (s & 0xC0) | rev
                continue
            rule = out.get((moving, None)) or out.get((moving, rest))
            if rule is None:
                table[chi, s] = s
                continue
            new_rest = rest if rule[2] is None else rule[2]
            table[chi, s] = rule[chi] | ((1 << REST) if new_rest else 0)
    for chi in range(2):
        for s in range(256):
            o = int(table[chi, s])
            if bin(o & 0x7F).count("1") != bin(s & 0x7F).count("1"):
                raise AssertionError(f"mass not kept: {chi} {s} -> {o}")
            sign = -1 if s & (1 << SOLID) else 1
            for c in (CX2, CY):
                p_in = sum(c[k] for k in range(N_DIR) if s >> k & 1)
                p_out = sum(c[k] for k in range(N_DIR) if o >> k & 1)
                if p_out != sign * p_in:
                    raise AssertionError(f"momentum: {chi} {s} -> {o}")
    return table


# ---------------------------------------------------------------------------
# Counter-based random words, in int64 holding unsigned 32-bit values.
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for x in [0, 2**32), without leaving int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser of unsigned 32-bit values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def random_words(h: int, wd: int, t: int, salt: int,
                 device=None) -> torch.Tensor:
    """(h, wd) int64 words in [0, 2**32): the hash of the counter
    ``row * 0x01000193 + word`` xor'd with ``t * 0x9E3779B9 + salt *
    0xC2B2AE35``, all mod 2**32."""
    rows = torch.arange(h, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(wd, dtype=torch.int64, device=device)[None, :]
    ctr = (rows * _FNV + cols) & MASK32
    return mix32(ctr ^ ((int(t) * _GOLD + salt * _M2) & MASK32))


def word_bits(words: torch.Tensor) -> torch.Tensor:
    """``(..., wd)`` words (their low 32 bits) -> ``(..., 32 wd)`` int32
    bits, bit b of word w at 32 w + b."""
    w32 = words.to(torch.int32)
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (w32[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)


def chirality(h: int, w: int, t: int, device=None) -> torch.Tensor:
    """(h, w) uint8 chirality bit of every node at step ``t``."""
    return word_bits(random_words(h, w // WORD, t, CHIRALITY_SALT,
                                  device)).to(torch.uint8)


def force_threshold(p: float, bits: int = FORCE_BITS) -> int:
    return int(round(min(max(p, 0.0), 1.0) * (1 << bits)))


def force_mask(h: int, w: int, t: int, p: float, device=None,
               bits: int = FORCE_BITS) -> Optional[torch.Tensor]:
    """(h, w) bool: where the body force fires at step ``t``: a uniform of
    ``bits`` bits per node (bit i from the word of salt 0x2200 + 16 - bits
    + i) below ``round(p * 2**bits)``.  ``bits`` 16 is the stated rule;
    fewer bits is a coarser draw of the same stream (the control).  None
    where the force never fires."""
    pq = force_threshold(p, bits)
    if pq <= 0:
        return None
    u = torch.zeros((h, w), dtype=torch.int32, device=device)
    for i in range(bits):
        rnd = FORCE_SALT * 0x100 + FORCE_BITS - bits + i
        u |= word_bits(random_words(h, w // WORD, t, rnd, device)) << i
    return u < pq


# ---------------------------------------------------------------------------
# Bytes and words.
# ---------------------------------------------------------------------------

def to_bytes(planes: torch.Tensor) -> torch.Tensor:
    """``(..., P, H, Wd)`` int32 or uint32-valued words -> ``(..., H, 32 Wd)``
    uint8 nodes, plane p at bit p."""
    *lead, n, h, wd = planes.shape
    out = torch.zeros((*lead, h, wd * WORD), dtype=torch.uint8,
                      device=planes.device)
    for p in range(n):
        out |= word_bits(planes[..., p, :, :]).to(torch.uint8) << p
    return out


def to_planes(state: torch.Tensor, n_planes: int) -> torch.Tensor:
    """``to_bytes``' inverse: ``(..., H, W)`` uint8 -> ``(..., n_planes, H,
    W / 32)`` int32 words (the 32 bits of each uint32 word)."""
    *lead, h, w = state.shape
    weights = torch.tensor([1 << b for b in range(WORD)], dtype=torch.int64,
                           device=state.device)
    out = []
    for p in range(n_planes):
        bits = ((state >> p) & 1).to(torch.int64).reshape(*lead, h,
                                                          w // WORD, WORD)
        words = (bits * weights).sum(-1)
        out.append(torch.where(words >= 1 << 31, words - (1 << 32),
                               words).to(torch.int32))
    return torch.stack(out, dim=-3)


# ---------------------------------------------------------------------------
# Steps.
# ---------------------------------------------------------------------------

def stream(state: torch.Tensor) -> torch.Tensor:
    """Every mover hops to its neighbour (both axes periodic); rest and
    solid bits stay.  ``state`` is ``(..., H, W)`` uint8, global row 0
    first."""
    h = state.shape[-2]
    odd = (torch.arange(h, device=state.device) % 2 == 1)[:, None]
    out = state & ((1 << REST) | (1 << SOLID))
    for k, ((dx0, dy0), (dx1, dy1)) in enumerate(OFFSETS):
        mover = state & (1 << k)
        if (dx0, dy0) == (dx1, dy1):
            out |= torch.roll(mover, (dy0, dx0), dims=(-2, -1))
            continue
        zero = torch.zeros_like(mover)
        out |= torch.roll(torch.where(odd, zero, mover), (dy0, dx0),
                          dims=(-2, -1))
        out |= torch.roll(torch.where(odd, mover, zero), (dy1, dx1),
                          dims=(-2, -1))
    return out


class Fhp2:
    """FHP-II steps on ``(..., H, W)`` uint8 lattices on one device."""

    def __init__(self, device=None, p_force: float = 0.0,
                 force_bits: int = FORCE_BITS):
        self.device = device
        self.p_force = p_force
        self.force_bits = force_bits
        self.table = torch.from_numpy(fhp2_table().reshape(-1)).to(device)

    def step(self, state: torch.Tensor, t: int) -> torch.Tensor:
        h, w = state.shape[-2:]
        s = stream(state)
        chi = chirality(h, w, t, self.device)
        idx = (chi.to(torch.int32) << 8) | s.to(torch.int32)
        s = self.table.index_select(0, idx.reshape(-1)).reshape(s.shape)
        fire = force_mask(h, w, t, self.p_force, self.device,
                          self.force_bits)
        if fire is not None:
            can = ((s & 0x08) != 0) & ((s & 0x01) == 0) & ((s & 0x80) == 0)
            s = torch.where(can & fire, s ^ 0x09, s)
        return s


class Bml:
    """BML steps on ``(..., H, W)`` uint8 lattices (bit 0 east, bit 1
    north); ``p_force`` and ``force_bits`` do not apply."""

    def __init__(self, device=None, p_force: float = 0.0,
                 force_bits: int = FORCE_BITS):
        if p_force:
            raise ValueError("BML has no force")
        self.device = device

    def step(self, state: torch.Tensor, t: int) -> torch.Tensor:
        east, north = state & 1, (state >> 1) & 1
        occ = east | north
        if int(t) % 2 == 0:
            go = east & (1 - torch.roll(occ, -1, dims=-1))
            east = (east - go) | torch.roll(go, 1, dims=-1)
        else:
            go = north & (1 - torch.roll(occ, -1, dims=-2))
            north = (north - go) | torch.roll(go, 1, dims=-2)
        return east | (north << 1)


RULES = {"fhp2": Fhp2, "bml": Bml}


def stepper(rule: str, device=None, p_force: float = 0.0,
            force_bits: int = FORCE_BITS):
    return RULES[rule](device=device, p_force=p_force,
                       force_bits=force_bits)


# ---------------------------------------------------------------------------
# What the program reports: moments and observable frames.
# ---------------------------------------------------------------------------

def bit_counts(state: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``(..., n_bits)`` int64: how many nodes hold each bit."""
    return torch.stack([((state >> b) & 1).sum(dim=(-2, -1),
                                                 dtype=torch.int64)
                        for b in range(n_bits)], dim=-1)


def moments(state: torch.Tensor, rule: str) -> torch.Tensor:
    """``(..., len(MOMENT_ROWS[rule]))`` int64 moments of ``state``."""
    c = bit_counts(state, N_BITS[rule])
    if rule == "fhp2":
        px2 = sum(c[..., k] * CX2[k] for k in range(N_DIR))
        py = sum(c[..., k] * CY[k] for k in range(N_DIR))
        return torch.stack([c[..., :7].sum(-1), c[..., 7], px2, py], -1)
    both = ((state & 3) == 3).sum(dim=(-2, -1), dtype=torch.int64)
    return torch.stack([c[..., 0] + c[..., 1], c[..., 0], c[..., 1], both],
                       -1)


def jam_fraction(state: torch.Tensor, t: int) -> float:
    """Share of the BML species about to move at ``t`` whose next cell is
    taken, divided in float32 as the program reports it."""
    east, north = state & 1, (state >> 1) & 1
    occ = east | north
    if int(t) % 2 == 0:
        movers, ahead = east, torch.roll(occ, -1, dims=-1)
    else:
        movers, ahead = north, torch.roll(occ, -1, dims=-2)
    blocked = int((movers & ahead).sum(dtype=torch.int64))
    total = int(movers.sum(dtype=torch.int64))
    return float(np.float32(blocked) / np.float32(max(total, 1)))


def frame(state: torch.Tensor, rule: str, t: int, step: int) -> Dict:
    """The observable frame of one lattice at global step ``t``, ``step``
    steps into its job."""
    m = [int(v) for v in moments(state, rule).tolist()]
    out = {"t": int(t), "mass": m[0]}
    if rule == "fhp2":
        out["px2"], out["py"] = m[2], m[3]
    else:
        out["car_counts"] = [m[1], m[2]]
        out["jam_fraction"] = jam_fraction(state, t)
    out["step"] = int(step)
    return out


def sites_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    """Nodes whose bytes differ between two equal-shaped lattices."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {tuple(a.shape)} {tuple(b.shape)}")
    return int((a != b).sum(dtype=torch.int64))


def run(state: torch.Tensor, rule: str, t0: int, steps: int, *,
        p_force: float = 0.0, force_bits: int = FORCE_BITS,
        record_every: int = 0) -> Tuple[torch.Tensor, list]:
    """``steps`` steps from global step ``t0``; returns the final lattice
    and, every ``record_every`` steps, ``(step, moments)``."""
    st = stepper(rule, state.device, p_force, force_bits)
    rec = []
    for k in range(int(steps)):
        state = st.step(state, t0 + k)
        if record_every and (k + 1) % record_every == 0:
            rec.append((k + 1, moments(state, rule)))
    return state, rec
