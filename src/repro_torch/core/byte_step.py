"""Paper-faithful byte-per-node FHP stepper (the byte oracle).

One lattice node = one uint8 (paper Fig. 1).  The update is

    stream (motion)  ->  collide (LUT scattering, incl. bounce-back)  ->  force

Arrays are ``(H, W)`` uint8 with row index ``y`` increasing northward; odd
rows are shifted east by half a lattice constant (paper Fig. 3), so
neighbour x-offsets depend on the *source* row parity (``rules.OFFSETS``).
Both axes wrap (``torch.roll``); no-slip walls are solid nodes (bit 7) whose
LUT entry is full bounce-back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng, rules

_FORCE_XOR = (1 << 0) | (1 << 3)  # swap W-mover into E-mover


def lut_array(variant: str = "fhp2", device=None) -> torch.Tensor:
    """The (512,) uint8 collision LUT, index = chirality << 8 | state."""
    return torch.from_numpy(rules.lut_flat(variant)).to(device)


def stream_bytes(state: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Motion step: every moving particle hops to its neighbour node; rest
    (bit 6) and solid (bit 7) bits stay in place."""
    h = state.shape[-2]
    parity = ((torch.arange(h, device=state.device) + int(row0)) & 1)[:, None]
    out = state & (rules.REST_MASK | rules.SOLID_MASK)
    for k in range(rules.N_DIR):
        plane = state & (1 << k)
        for p in (0, 1):
            dx, dy = rules.OFFSETS[k][p]
            src = torch.where(parity == p, plane, torch.zeros_like(plane))
            out = out | torch.roll(src, shifts=(dy, dx), dims=(-2, -1))
    return out


def collide_bytes(state: torch.Tensor, chi: torch.Tensor,
                  variant: str = "fhp2") -> torch.Tensor:
    """Scattering step via the 2x256 LUT; ``chi`` is the per-node chirality bit."""
    idx = chi.to(torch.int64) * 256 + state.to(torch.int64)
    return lut_array(variant, state.device)[idx]


def force_bytes(state: torch.Tensor, accel: torch.Tensor) -> torch.Tensor:
    """Body force: where ``accel`` and the node holds a W-mover but no E-mover
    (and is fluid), reverse it."""
    can = (((state & (1 << 3)) != 0) & ((state & 1) == 0)
           & ((state & (1 << 7)) == 0))
    return torch.where(can & accel, state ^ _FORCE_XOR, state)


def step_bytes(state: torch.Tensor, t: int, p_force: float = 0.0,
               y0: int = 0, x0: int = 0, *, chi=None, accel=None,
               variant: str = "fhp2") -> torch.Tensor:
    """One full FHP time step on the byte representation; ``y0``/``x0``
    offset the counter RNG, ``chi``/``accel`` override it."""
    shape = state.shape
    s = stream_bytes(state, row0=y0)
    if chi is None:
        chi = prng.chirality_bits(shape, t, y0=y0, x0=x0, device=state.device)
    s = collide_bytes(s, chi, variant)
    if p_force or accel is not None:
        if accel is None:
            accel = prng.bernoulli(shape, t, p_force, y0=y0, x0=x0,
                                   device=state.device)
        s = force_bytes(s, accel)
    return s


def run_bytes(state: torch.Tensor, steps: int, p_force: float = 0.0,
              t0: int = 0) -> torch.Tensor:
    """Advance ``steps`` time steps from step counter ``t0``."""
    for i in range(int(steps)):
        state = step_bytes(state, t0 + i, p_force)
    return state


# ---------------------------------------------------------------------------
# Initialisation and observables
# ---------------------------------------------------------------------------

def make_channel(h: int, w: int, density: float = 0.2, seed: int = 0,
                 obstacle=None) -> np.ndarray:
    """A channel: solid rows top/bottom, random fluid at given per-bit density.

    ``obstacle`` is an optional (H, W) bool mask of extra solid nodes.
    Returns a host numpy array (uint8).
    """
    rng = np.random.default_rng(seed)
    occ = (rng.random((7, h, w)) < density).astype(np.uint8)
    state = np.zeros((h, w), dtype=np.uint8)
    for i in range(7):
        state |= occ[i] << i
    solid = np.zeros((h, w), dtype=bool)
    solid[0, :] = True
    solid[-1, :] = True
    if obstacle is not None:
        solid |= obstacle
    return np.where(solid, np.uint8(rules.SOLID_MASK), state)


def density(state: torch.Tensor) -> torch.Tensor:
    """Particles per node (0..7)."""
    n = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    for i in range(7):
        n = n + ((state >> i) & 1).to(torch.int32)
    return n


def momentum(state: torch.Tensor):
    """(px2, py) integer momentum fields; px2 is doubled x-momentum."""
    px2 = torch.zeros(state.shape, dtype=torch.int32, device=state.device)
    py = torch.zeros_like(px2)
    for i in range(rules.N_DIR):
        b = ((state >> i) & 1).to(torch.int32)
        px2 = px2 + b * int(rules.CX2[i])
        py = py + b * int(rules.CY[i])
    return px2, py


def velocity_profile(state: torch.Tensor) -> torch.Tensor:
    """Mean x-velocity per row: <px>/<mass> with px = px2/2 (fluid rows)."""
    px2, _ = momentum(state)
    n = density(state)
    mean_p = px2.to(torch.float32).mean(dim=-1) / 2.0
    mean_n = torch.clamp(n.to(torch.float32).mean(dim=-1), min=1e-9)
    return mean_p / mean_n
