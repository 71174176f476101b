"""Observables on packed bit-plane states: coarse-grained velocity,
per-obstacle momentum transfer (drag), and the mass audit.

Everything works by popcount reductions directly on the packed words --
no unpacking -- and accepts leading ensemble-lane axes like the steppers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import bitplane, carry, rules

WORD = 32


def _pop_sum(p: torch.Tensor) -> torch.Tensor:
    return bitplane.popcount(p).sum(dim=(-2, -1), dtype=torch.int64)


def mass(planes: torch.Tensor) -> torch.Tensor:
    """Total particle count (moving + rest); the conserved quantity."""
    return bitplane.density_total(planes)


def mass_audit(planes: torch.Tensor, expected) -> bool:
    """True iff the particle count matches ``expected`` in every lane."""
    got = mass(planes).cpu()
    return bool((got == torch.as_tensor(np.asarray(expected),
                                        dtype=got.dtype)).all())


def solid_momentum(planes: torch.Tensor, solid_words
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum px2, sum py) of moving particles sitting on ``solid_words``
    nodes -- the particles mid-bounce against an obstacle.  The per-step
    momentum transfer to the obstacle is twice this.  ``solid_words`` is a
    packed mask: uint32 numpy words or an int32 tensor."""
    m = solid_words
    if not isinstance(m, torch.Tensor):
        m = carry.planes_from_reference(m, planes.device)
    px2 = torch.zeros(planes.shape[:-3], dtype=torch.int64,
                      device=planes.device)
    py = torch.zeros_like(px2)
    for i in range(rules.N_DIR):
        c = _pop_sum(planes[..., i, :, :] & m)
        px2 = px2 + c * int(rules.CX2[i])
        py = py + c * int(rules.CY[i])
    return px2, py


def coarse_velocity(planes: torch.Tensor, tile_rows: int = 8,
                    tile_words: int = 2) -> torch.Tensor:
    """Block-averaged velocity field: (..., H/tr, Wd/tw, 2) float32.

    Component 0 is mean x-velocity (lattice units per step), component 1
    mean y-velocity in units of sqrt(3)/2 lattice constants per step.
    Empty tiles (all-solid) report zero velocity."""
    h, wd = planes.shape[-2:]
    if h % tile_rows or wd % tile_words:
        raise ValueError(f"tiles ({tile_rows}, {tile_words}) must divide "
                         f"the lattice ({h}, {wd})")
    shape = planes.shape[:-3] + (h, wd)
    px2 = torch.zeros(shape, dtype=torch.int32, device=planes.device)
    py = torch.zeros_like(px2)
    n = torch.zeros_like(px2)
    for i in range(rules.N_DIR):
        c = bitplane.popcount(planes[..., i, :, :])
        px2 = px2 + c * int(rules.CX2[i])
        py = py + c * int(rules.CY[i])
        n = n + c
    n = n + bitplane.popcount(planes[..., rules.REST_BIT, :, :])

    def tiles(a):
        a = a.reshape(a.shape[:-2] + (h // tile_rows, tile_rows,
                                      wd // tile_words, tile_words))
        return a.sum(dim=(-3, -1), dtype=torch.int32).to(torch.float32)

    tn = torch.clamp(tiles(n), min=1.0)
    ux = tiles(px2) / 2.0 / tn
    uy = tiles(py) / tn
    return torch.stack([ux, uy], dim=-1)


def car_counts(planes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(east, north) car counts of a packed 2-plane BML state."""
    return _pop_sum(planes[..., 0, :, :]), _pop_sum(planes[..., 1, :, :])


def jam_fraction(planes: torch.Tensor, t: int) -> torch.Tensor:
    """Fraction of the about-to-move BML species blocked at step ``t``
    (destination occupied pre-move): 0 = free flow, -> 1 in a global jam."""
    e = planes[..., 0, :, :]
    n = planes[..., 1, :, :]
    occ = e | n
    if int(t) % 2 == 0:
        movers, ahead = e, bitplane.shift_x(occ, -1)
    else:
        movers, ahead = n, torch.roll(occ, -1, dims=-2)
    blocked = _pop_sum(movers & ahead).to(torch.float32)
    total = _pop_sum(movers).to(torch.float32)
    return blocked / torch.clamp(total, min=1.0)


def frame_summary(planes: torch.Tensor, spec, t: int, inv=None) -> dict:
    """One observable frame for a single-lane packed state of rule
    ``spec``: plain Python numbers, JSON-ready.  Always carries ``mass``;
    FHP rules add ``px2``/``py``; BML adds ``car_counts`` and
    ``jam_fraction``.  ``inv`` supplies invariants already in hand (e.g.
    fused moments) so a frame costs no extra popcount pass."""
    from repro_torch.core import rulespec
    if inv is None:
        inv = rulespec.invariants(spec, planes,
                                  with_momentum=spec.conserves_momentum)
    out = {"t": int(t), "mass": int(inv["mass"])}
    if "px2" in inv:
        out["px2"], out["py"] = int(inv["px2"]), int(inv["py"])
    if spec.per_plane_conserved:
        out["car_counts"] = [int(inv[f"plane{i}"])
                             for i in spec.mass_planes]
    if spec.exclusive_planes == (0, 1) and spec.n_planes == 2:
        out["jam_fraction"] = float(jam_fraction(planes, t))
    return out


def obstacle_report(planes: torch.Tensor, scenario) -> dict:
    """Per-obstacle momentum transfer for a Scenario's named obstacles:
    {name: (px2, py)} as plain ints (single-lane states)."""
    out = {}
    for name, words in scenario.obstacle_words():
        px2, py = solid_momentum(planes, words)
        out[name] = (int(px2), int(py))
    return out
