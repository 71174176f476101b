"""Scenario: a named, reproducible FHP workload -- geometry + fill
density + forcing + seed -- with its initial state builders.

The geometry rasterizes in global coordinates, the fluid fill is seeded,
and observables live in ``scenarios.observables``.  Register builders with
``scenarios.register``; fetch with ``scenarios.get(name, height=...,
width=...)`` -- every scenario scales to any (even H, W % 32 == 0) lattice.

``initial_planes`` builds large lattices in row chunks, plane by plane,
straight into packed words: the one-shot byte fill of ``initial_bytes``
would need ``7 * H * W`` float64 draws at once (about 7.5 GB for one
4096 x 32768 lane).  Chunked draws from the same generator give the same
stream, and the geometry is exact in global coordinates, so both builders
give the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import carry
from repro_torch.geometry import Geometry, raster

WORD = 32
_CHUNK_VALUES = 1 << 23      # float64 draws per row chunk (64 MiB)


def _chunk_rows(width: int) -> int:
    return max(1, _CHUNK_VALUES // width)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named workload on an ``height x width`` lattice.

    ``obstacles`` names sub-geometries whose momentum transfer (drag) is
    tracked separately by ``observables.solid_momentum``; they are
    usually also part of ``geometry``."""
    name: str
    height: int
    width: int
    geometry: Geometry
    density: float = 0.2
    p_force: float = 0.0
    seed: int = 0
    variant: str = "fhp2"
    description: str = ""
    obstacles: Tuple[Tuple[str, Geometry], ...] = ()

    def __post_init__(self):
        if self.height % 2:
            raise ValueError(f"H={self.height} must be even "
                             f"(global row-parity contract)")
        if self.width % WORD:
            raise ValueError(f"W={self.width} must pack into 32-node words")

    def solid_mask(self) -> np.ndarray:
        """Global (H, W) boolean solid mask."""
        return raster.rasterize(self.geometry, (self.height, self.width))

    def solid_plane(self, chunk_rows: int = 0) -> np.ndarray:
        """Global packed (H, W//32) uint32 solid plane, rasterized one row
        window at a time."""
        rows = chunk_rows or _chunk_rows(self.width)
        wd = self.width // WORD
        out = np.empty((self.height, wd), np.uint32)
        for y0 in range(0, self.height, rows):
            y1 = min(self.height, y0 + rows)
            out[y0:y1] = raster.solid_words(self.geometry, (y1 - y0, wd),
                                            origin_words=(y0, 0))
        return out

    def obstacle_words(self) -> Tuple[Tuple[str, np.ndarray], ...]:
        """``((name, packed (H, W//32) uint32 words), ...)`` for the named
        obstacles, rasterized once per scenario and cached."""
        cached = getattr(self, "_obstacle_words", None)
        if cached is None:
            shape = (self.height, self.width // WORD)
            cached = tuple((name, raster.solid_words(geom, shape))
                           for name, geom in self.obstacles)
            # frozen dataclass: memoize via object.__setattr__
            object.__setattr__(self, "_obstacle_words", cached)
        return cached

    def rule(self):
        """The registered ``core.rulespec.RuleSpec`` of ``variant``."""
        from repro_torch.core import rulespec
        return rulespec.get_rule(self.variant)

    def initial_bytes(self) -> np.ndarray:
        """(H, W) uint8 byte-per-node state: the rule's seeded random fill
        at ``density``; for rules with a solid plane, geometry nodes are
        solid (and empty).  Rules without a solid plane require an empty
        geometry.  One-shot: use ``initial_planes`` for large lattices."""
        spec = self.rule()
        state = spec.init_bytes(self.height, self.width, self.density,
                                self.seed)
        mask = self.solid_mask()
        if spec.solid_plane is None:
            if mask.any():
                raise ValueError(f"rule {self.variant!r} has no solid plane "
                                 f"but scenario {self.name!r} has geometry")
            return state
        return np.where(mask, np.uint8(1 << spec.solid_plane), state)

    def initial_planes(self, device="cuda", chunk_rows: int = 0
                       ) -> torch.Tensor:
        """Packed (n_planes, H, W//32) int32 bit-plane stack on ``device``,
        built on the host in row chunks of ``chunk_rows`` rows (0 = about
        64 MiB of draws per chunk)."""
        return carry.planes_from_reference(self.initial_words(chunk_rows),
                                           device)

    def initial_words(self, chunk_rows: int = 0, telemetry=None
                      ) -> np.ndarray:
        """``initial_planes``' packed (n_planes, H, W//32) uint32 words on
        the host.  ``telemetry`` (a ``repro_torch.telemetry.Telemetry``,
        the serve engine's) times the seeded draws as ``serve.admit.draw``
        and the solid plane as ``serve.admit.solid``."""
        span = (telemetry.span if telemetry is not None
                else contextlib.nullcontext)
        spec = self.rule()
        rows = chunk_rows or _chunk_rows(self.width)
        with span("serve.admit.draw"):
            words = spec.init_planes(self.height, self.width, self.density,
                                     self.seed, rows)
        with span("serve.admit.solid"):
            solid = self.solid_plane(rows)
            sp = spec.solid_plane
            if sp is None:
                if solid.any():
                    raise ValueError(
                        f"rule {self.variant!r} has no solid plane but "
                        f"scenario {self.name!r} has geometry")
                return words
            for i in range(spec.n_planes):
                if i != sp:
                    words[i] &= ~solid
            words[sp] = solid
        return words
