"""Multi-spin-coded (bit-plane) FHP state and its plain stepper: 32 nodes
per 32-bit word.

Layout: ``planes`` is ``(..., n_planes, H, W // 32)`` ``torch.int32`` (the
bit-view of the reference's uint32 words); bit ``b`` of word ``w`` in row
``y`` is node ``(y, 32 * w + b)`` (little-endian bit order along x).  Plane
order matches the byte bits: 0..5 moving, 6 rest, 7 solid.  Leading axes
are ensemble lanes.
"""
from __future__ import annotations

import torch

from repro_torch.core import boolean, prng, rules

WORD = 32


def popcount(v: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 bit-view words (SWAR reduction; every
    arithmetic right shift is masked to its logical bits)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def pack(state: torch.Tensor, n_planes: int = 8) -> torch.Tensor:
    """(..., H, W) uint8 bytes -> (..., n_planes, H, W//32) int32 planes."""
    *lead, h, w = state.shape
    if w % WORD:
        raise ValueError(f"W={w} must be a multiple of {WORD}")
    planes = []
    for i in range(n_planes):
        bits = ((state >> i) & 1).to(torch.int32).reshape(
            *lead, h, w // WORD, WORD)
        word = torch.zeros(bits.shape[:-1], dtype=torch.int32,
                           device=state.device)
        for b in range(WORD):
            word = word | (bits[..., b] << b)
        planes.append(word)
    return torch.stack(planes, dim=-3)


def unpack(planes: torch.Tensor) -> torch.Tensor:
    """(..., n_planes, H, W//32) int32 planes -> (..., H, W) uint8 bytes."""
    *lead, np_, h, wd = planes.shape
    shifts = torch.arange(WORD, dtype=torch.int32, device=planes.device)
    state = torch.zeros((*lead, h, wd * WORD), dtype=torch.uint8,
                        device=planes.device)
    for i in range(np_):
        bits = ((planes[..., i, :, :, None] >> shifts) & 1).to(torch.uint8)
        state = state | (bits.reshape(*lead, h, wd * WORD) << i)
    return state


def shift_x(p: torch.Tensor, dx: int) -> torch.Tensor:
    """Shift a packed plane by dx nodes along x (periodic), dx in {-1, 0, 1}:
    a bit shift plus the carry of the bit that crosses into the next word."""
    if dx == 0:
        return p
    if dx == 1:
        return (p << 1) | prng.srl(torch.roll(p, 1, dims=-1), WORD - 1)
    if dx == -1:
        return prng.srl(p, 1) | (torch.roll(p, -1, dims=-1) << (WORD - 1))
    raise ValueError(dx)


def stream_planes(planes: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Motion step on packed planes (periodic both axes; walls via collide).

    ``row0`` is the global row index of local row 0: the triangular
    lattice's x-offsets follow the *global* row parity, so a shard of a
    larger lattice passes its offset."""
    h = planes.shape[-2]
    even = (((torch.arange(h, device=planes.device) + int(row0)) & 1)
            == 0)[:, None]                       # (H, 1) source parity
    out = [None] * 8
    for k in range(rules.N_DIR):
        p = planes[..., k, :, :]
        (dx0, dy), (dx1, _) = rules.OFFSETS[k]
        if dx0 == dx1:
            moved = shift_x(p, dx0)
        else:
            moved = torch.where(even, shift_x(p, dx0), shift_x(p, dx1))
        out[k] = torch.roll(moved, dy, dims=-2) if dy else moved
    out[rules.REST_BIT] = planes[..., rules.REST_BIT, :, :]
    out[rules.SOLID_BIT] = planes[..., rules.SOLID_BIT, :, :]
    return torch.stack(out, dim=-3)


def _as_plane_list(planes: torch.Tensor):
    """Split the plane axis (-3) into a list, keeping batch axes."""
    return [planes[..., k, :, :] for k in range(8)]


def collide(planes: torch.Tensor, chi: torch.Tensor,
            variant: str = "fhp2") -> torch.Tensor:
    return torch.stack(boolean.collide_planes(_as_plane_list(planes), chi,
                                              variant), dim=-3)


def step_planes(planes: torch.Tensor, t: int, p_force: float = 0.0,
                y0: int = 0, xw0: int = 0, *, chi=None, accel=None,
                variant: str = "fhp2") -> torch.Tensor:
    """One fused FHP step (stream -> collide -> force) on packed planes.

    ``y0``/``xw0`` are the global coordinates of local word (0, 0); they
    offset both the RNG counters and the row parity, so a shard reproduces
    the global lattice bit for bit.  ``chi``/``accel`` override the
    counter RNG."""
    shape_words = planes.shape[-2:]
    s = stream_planes(planes, row0=y0)
    if chi is None:
        chi = prng.chirality_words(shape_words, t, y0=y0, xw0=xw0,
                                   device=planes.device)
    s = collide(s, chi, variant)
    if p_force or accel is not None:
        if accel is None:
            accel = prng.bernoulli_words(shape_words, t, p_force, y0=y0,
                                         xw0=xw0, device=planes.device)
        s = torch.stack(boolean.force_planes(_as_plane_list(s), accel),
                        dim=-3)
    return s


def run_planes(planes: torch.Tensor, steps: int, p_force: float = 0.0,
               t0: int = 0) -> torch.Tensor:
    """Advance ``steps`` fhp2 steps from step counter ``t0``."""
    for i in range(int(steps)):
        planes = step_planes(planes, t0 + i, p_force)
    return planes


def _pop_sum(p: torch.Tensor) -> torch.Tensor:
    """Per-lane popcount sum over the last two axes, int64."""
    return popcount(p).sum(dim=(-2, -1), dtype=torch.int64)


def density_total(planes: torch.Tensor) -> torch.Tensor:
    """Total particle count (moving + rest); per-lane for batched planes."""
    return sum(_pop_sum(planes[..., i, :, :]) for i in range(7))


def momentum_total(planes: torch.Tensor):
    """(sum px2, sum py) over the lattice; per-lane for batched planes."""
    px2 = torch.zeros(planes.shape[:-3], dtype=torch.int64,
                      device=planes.device)
    py = torch.zeros_like(px2)
    for i in range(rules.N_DIR):
        c = _pop_sum(planes[..., i, :, :])
        px2 = px2 + c * int(rules.CX2[i])
        py = py + c * int(rules.CY[i])
    return px2, py


def row_velocity(planes: torch.Tensor) -> torch.Tensor:
    """Mean x-velocity per row (for Poiseuille profiles), float32."""
    px2 = torch.zeros(planes.shape[:-3] + planes.shape[-2:],
                      dtype=torch.int32, device=planes.device)
    n = torch.zeros_like(px2)
    for i in range(rules.N_DIR):
        c = popcount(planes[..., i, :, :])
        px2 = px2 + c * int(rules.CX2[i])
        n = n + c
    n = n + popcount(planes[..., rules.REST_BIT, :, :])
    mp = px2.sum(dim=-1, dtype=torch.int32).to(torch.float32) / 2.0
    mn = torch.clamp(n.sum(dim=-1, dtype=torch.int32).to(torch.float32),
                     min=1e-9)
    return mp / mn


def pack_bits_from_bytes(x: torch.Tensor) -> torch.Tensor:
    """Pack a (H, W) {0,1} uint8 mask into (H, W//32) int32 words."""
    return pack(x.to(torch.uint8), n_planes=1)[0]
