"""Rasterize geometry predicates onto lattice windows -- global or
shard-local -- and pack them into the bit-plane word layout.

Because every primitive is an integer-exact function of global node
coordinates (see ``primitives``), a shard holding rows ``[y0, y0+h)`` and
words ``[xw0, xw0+wd)`` of the global lattice builds its own solid tile
with ``solid_words(geom, (h, wd), origin_words=(y0, xw0))`` -- no host
gather, and bit-identical to slicing the global rasterization
(``tests/test_geometry.py`` property-tests this over mesh shapes).

The packed layout matches ``core.bitplane``: bit ``b`` of word ``w`` in
row ``y`` is node ``(y, 32*w + b)``, little-endian along x.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.geometry.primitives import Geometry

WORD = 32


def node_window(shape: Tuple[int, int], origin: Tuple[int, int] = (0, 0)):
    """(h, 1) row and (1, w) column int64 global-coordinate arrays."""
    h, w = shape
    y0, x0 = origin
    yy = np.arange(h, dtype=np.int64)[:, None] + int(y0)
    xx = np.arange(w, dtype=np.int64)[None, :] + int(x0)
    return yy, xx


def rasterize(geom: Geometry, shape: Tuple[int, int],
              origin: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Boolean (h, w) solid mask of the window at ``origin`` (global node
    coordinates of window element (0, 0))."""
    yy, xx = node_window(shape, origin)
    return np.ascontiguousarray(
        np.broadcast_to(geom.mask(yy, xx), shape))


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """Pack a boolean (h, w) mask into (h, w//32) uint32 words."""
    h, w = mask.shape
    assert w % WORD == 0, f"W={w} must be a multiple of {WORD}"
    bits = mask.reshape(h, w // WORD, WORD).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(WORD, dtype=np.uint32))
    return (bits * weights).sum(axis=-1, dtype=np.uint32)


def solid_words(geom: Geometry, shape_words: Tuple[int, int],
                origin_words: Tuple[int, int] = (0, 0)) -> np.ndarray:
    """Packed (h, wd) uint32 solid plane of a shard's window.

    ``origin_words`` is (global row, global *word* index) of local word
    (0, 0) -- the same (y0, xw0) convention as the kernels."""
    h, wd = shape_words
    y0, xw0 = origin_words
    return pack_mask(rasterize(geom, (h, wd * WORD), (y0, xw0 * WORD)))
