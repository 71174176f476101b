"""Composable solid-geometry primitives on the doubled-coordinate
triangular lattice, evaluated in *global* node coordinates.

The paper's whole point of FHP (sec. 2) is fluid flow in arbitrary 2-D
geometries; these primitives are the vocabulary the scenario registry
composes them from.  Every primitive is a pure predicate over the global
node index ``(y, x)`` using **integer arithmetic only** (add / multiply /
mod / compare), so

* a shard rasterizes its own window -- any origin, any extent -- and gets
  bit-identically the corresponding slice of the global rasterization:
  no host-side gather, no floating-point seam at shard boundaries
  (property-tested in ``tests/test_geometry.py``);
* the same predicate runs on numpy int64 windows of any origin (host
  initialisation, one row window at a time for large lattices).

Triangular metric: the lattice is the paper's Fig. 3 mapping -- odd rows
shifted east by half a lattice constant -- so node ``(y, x)`` sits at
physical ``((2x + (y & 1)) / 2, y * sqrt(3) / 2)``.  Working in the
doubled x-coordinate ``X2 = 2x + (y & 1)`` keeps distances exact:

    |r|^2 <= R^2   <=>   3*dy^2 + dX2^2 <= (2R)^2      (integers).

Predicates may return masks of any numpy-broadcastable shape against the
``(h, 1) x (1, w)`` window; ``raster.rasterize`` broadcasts to the full
window.  Compose with ``|`` (union) and ``&`` (intersection).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

_FNV = 0x01000193      # row-counter multiplier, as in prng.word_u32_at
_GEOM_SALT = 0x6E0D17  # distinct from the chirality/forcing RNG salts
_M1 = 0x85EBCA6B       # murmur3 finalizer constants, as in core.prng
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer on numpy uint32 (bit-identical to
    ``core.prng.hash_u32``; kept here so the host raster path stays in
    numpy and off the device)."""
    u32 = np.uint32
    x = x.astype(u32)
    x = x ^ (x >> u32(16))
    x = x * u32(_M1)
    x = x ^ (x >> u32(13))
    x = x * u32(_M2)
    x = x ^ (x >> u32(16))
    return x


def doubled_x(yy, xx):
    """Doubled physical x-coordinate of node (y, x): 2x + (y & 1)."""
    return 2 * xx + (yy & 1)


def _centered_mod(d, p: int):
    """Reduce d into [-p//2, p - p//2): signed distance to the nearest
    multiple of p, with pure integer ops (numpy)."""
    return (d + p // 2) % p - p // 2


class Geometry:
    """Base: a solid-region predicate over global node coordinates."""

    def mask(self, yy, xx):
        """Boolean solid mask for (broadcastable) int coordinate arrays."""
        raise NotImplementedError

    def __or__(self, other: "Geometry") -> "Geometry":
        a = self.parts if isinstance(self, Union) else (self,)
        b = other.parts if isinstance(other, Union) else (other,)
        return Union(a + b)

    def __and__(self, other: "Geometry") -> "Geometry":
        return Intersection((self, other))


@dataclasses.dataclass(frozen=True)
class Union(Geometry):
    parts: Tuple[Geometry, ...]

    def mask(self, yy, xx):
        m = self.parts[0].mask(yy, xx)
        for p in self.parts[1:]:
            m = m | p.mask(yy, xx)
        return m


@dataclasses.dataclass(frozen=True)
class Intersection(Geometry):
    parts: Tuple[Geometry, ...]

    def mask(self, yy, xx):
        m = self.parts[0].mask(yy, xx)
        for p in self.parts[1:]:
            m = m & p.mask(yy, xx)
        return m


@dataclasses.dataclass(frozen=True)
class Empty(Geometry):
    """No solid nodes (fully periodic free fluid)."""

    def mask(self, yy, xx):
        return (yy + xx) != (yy + xx)


@dataclasses.dataclass(frozen=True)
class Disk(Geometry):
    """Solid disk of radius ``r`` lattice constants centred on node
    ``(cy, cx)``, measured in the true triangular metric."""
    cy: int
    cx: int
    r: int

    def mask(self, yy, xx):
        dy = yy - self.cy
        dx2 = doubled_x(yy, xx) - (2 * self.cx + (self.cy & 1))
        return 3 * dy * dy + dx2 * dx2 <= (2 * self.r) ** 2


@dataclasses.dataclass(frozen=True)
class HalfPlane(Geometry):
    """Everything at or beyond ``threshold`` along one array axis.

    ``axis`` is "y" (rows) or "x" (columns); ``above=True`` makes
    ``coord >= threshold`` solid, ``above=False`` makes ``coord <
    threshold`` solid.  Channel walls are two thin HalfPlanes."""
    axis: str
    threshold: int
    above: bool = True

    def mask(self, yy, xx):
        c = yy if self.axis == "y" else xx
        return c >= self.threshold if self.above else c < self.threshold


def channel_walls(height: int, thickness: int = 1) -> Geometry:
    """No-slip walls: ``thickness`` solid rows at y=0 and y=height-1."""
    return (HalfPlane("y", thickness, above=False)
            | HalfPlane("y", height - thickness, above=True))


@dataclasses.dataclass(frozen=True)
class Rectangle(Geometry):
    """Axis-aligned solid block over rows [y0, y1) x columns [x0, x1)."""
    y0: int
    y1: int
    x0: int
    x1: int

    def mask(self, yy, xx):
        return ((yy >= self.y0) & (yy < self.y1)
                & (xx >= self.x0) & (xx < self.x1))


@dataclasses.dataclass(frozen=True)
class ObstacleArray(Geometry):
    """Infinite periodic array of disks: radius ``r``, one disk per
    ``(pitch_y, pitch_x)`` cell, anchored at node ``(cy, cx)``.

    Exact for any pitch: the row distance folds to the nearest array row
    first, which fixes that centre row's parity, then the doubled-x
    distance folds mod the doubled pitch.  Bound it in y with channel
    walls (or intersect with a Rectangle) as the scenario requires."""
    cy: int
    cx: int
    r: int
    pitch_y: int
    pitch_x: int

    def mask(self, yy, xx):
        dy = _centered_mod(yy - self.cy, self.pitch_y)
        cy_near = yy - dy                 # centre row owning this node
        dx2 = doubled_x(yy, xx) - (2 * self.cx + (cy_near & 1))
        dx2 = _centered_mod(dx2, 2 * self.pitch_x)
        return 3 * dy * dy + dx2 * dx2 <= (2 * self.r) ** 2


@dataclasses.dataclass(frozen=True)
class PorousMedium(Geometry):
    """Seeded random solid cells at ``fraction`` density inside rows
    [y0, y1) x columns [x0, x1).

    The per-node coin is the counter-based hash of the *global* node
    coordinates (``_hash_u32`` -- the same murmur3 finalizer as every
    other stream, with a geometry-only salt, in numpy so the host raster
    path stays off-device), so the medium is
    a pure function of (seed, position): every shard reproduces its
    window of the plug without any shared random state."""
    y0: int
    y1: int
    x0: int
    x1: int
    fraction: float
    seed: int = 0

    def mask(self, yy, xx):
        inside = ((yy >= self.y0) & (yy < self.y1)
                  & (xx >= self.x0) & (xx < self.x1))
        u32 = np.uint32
        ctr = yy.astype(u32) * u32(_FNV) + xx.astype(u32)
        salted = (self.seed * _GOLD + _GEOM_SALT * _M2) & 0xFFFFFFFF
        v = _hash_u32(ctr ^ u32(salted))
        thresh = u32(min(max(self.fraction, 0.0), 1.0) * 4294967295.0)
        return inside & (v < thresh)
