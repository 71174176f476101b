"""Plain reference of the serve jobs' initial lattices: the ``cylinder``
and ``bml_city`` set-ups with their geometry, as byte lattices.

``cylinder``: a driven channel, one solid row at the top and bottom, and a
solid disk of radius ``max(2, H // 9)`` centred on node (H/2, W/4) in the
triangular metric (odd rows sit half a lattice constant east, so with the
doubled x coordinate X2 = 2x + (y & 1) a node is inside when
3 dy^2 + dX2^2 <= (2r)^2).  Fluid nodes hold each of the 7 particles with
probability ``density``: seven (H, W) draws of ``numpy.random.default_rng
(seed).random``, plane after plane; solid nodes hold only the solid bit.

``bml_city``: one (H, W) draw u per node; an east car where u < rho/2, a
north car where rho/2 <= u < rho.

Frozen with the benchmark; imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

def cylinder_solid(h: int, w: int) -> np.ndarray:
    """(h, w) bool: the channel walls and the disk."""
    r = max(2, h // 9)
    cy, cx = h // 2, w // 4
    y = np.arange(h, dtype=np.int64)[:, None]
    x = np.arange(w, dtype=np.int64)[None, :]
    dx2 = (2 * x + (y & 1)) - (2 * cx + (cy & 1))
    disk = 3 * (y - cy) ** 2 + dx2 ** 2 <= (2 * r) ** 2
    walls = (y == 0) | (y == h - 1)
    return disk | walls


def initial_bytes(name: str, h: int, w: int, seed: int,
                  density: float) -> np.ndarray:
    """(h, w) uint8 initial lattice of scenario ``name``."""
    rho = density
    rng = np.random.default_rng(seed)
    if name == "bml_city":
        u = rng.random((h, w))
        return np.where(u < rho / 2, np.uint8(1),
                        np.where(u < rho, np.uint8(2), np.uint8(0)))
    if name != "cylinder":
        raise KeyError(f"no reference for scenario {name!r}")
    state = np.zeros((h, w), np.uint8)
    for k in range(7):
        state |= (rng.random((h, w)) < rho).astype(np.uint8) << k
    return np.where(cylinder_solid(h, w), np.uint8(1 << 7), state)


def initial_state(name: str, h: int, w: int, seed: int, density: float,
                  device=None) -> torch.Tensor:
    return torch.from_numpy(initial_bytes(name, h, w, seed,
                                          density)).to(device)
