"""Counter-based pseudo-random bits for collision chirality and forcing.

The FHP update needs one cheap random bit per node per step (chirality of
two-/four-body rotations) and one uniform per node per step (forcing with
probability p).  A stateful PRNG array would double the memory traffic of a
memory-bound algorithm, so we hash the (position, time, salt) counter
instead, with bitwise ops only.  The mix is the murmur3 finalizer.

Words are held as ``torch.int32`` bit-views of uint32 (torch has no ``>>``
or ``+`` for uint32 on the CPU): int32 ``*`` and ``+`` wrap exactly like
uint32, and every logical right shift is an arithmetic shift masked to the
bits a logical one keeps (``srl``).  Step counters ``t`` and offsets are
Python ints.
"""
from __future__ import annotations

import numpy as np
import torch

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_FNV = 0x01000193

BERNOULLI_BITS = 16  # Bernoulli(p) resolution: p is quantised to 1/65536.


def i32(c: int) -> int:
    """The int32 value with the same 32 bits as ``c mod 2**32``."""
    c &= 0xFFFFFFFF
    return c - (1 << 32) if c >= (1 << 31) else c


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit-view words by ``n`` (0 < n < 32)."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 holding the low 32 bits (two's complement)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """Final-avalanche mix of int32 bit-view words (murmur3 finalizer)."""
    x = x.to(torch.int32)
    x = x ^ srl(x, 16)
    x = x * i32(_M1)
    x = x ^ srl(x, 13)
    x = x * i32(_M2)
    x = x ^ srl(x, 16)
    return x


def _tt(t: int, salt: int) -> int:
    """The per-step counter term ``t * GOLD + salt * M2`` as an int32."""
    return i32(int(t) * _GOLD + ((salt * _M2) & 0xFFFFFFFF))


def _coords(n: int, off: int, device) -> torch.Tensor:
    return wrap_i32(torch.arange(n, dtype=torch.int64, device=device)
                    + int(off))


def counter_u32(shape, t: int, salt: int, y0: int = 0, x0: int = 0,
                device=None) -> torch.Tensor:
    """Uniform words for a (H, W) grid of per-node counters."""
    h, w = shape
    ys = _coords(h, y0, device)[:, None]
    xs = _coords(w, x0, device)[None, :]
    return hash_u32((ys * _FNV + xs) ^ _tt(t, salt))


def chirality_bits(shape, t: int, y0: int = 0, x0: int = 0,
                   device=None) -> torch.Tensor:
    """One random bit per node, as uint8 in {0, 1}."""
    c = counter_u32(shape, t, salt=0x11, y0=y0, x0=x0, device=device)
    return srl(c, 31).to(torch.uint8)


def bernoulli(shape, t: int, p: float, salt: int = 0x22, y0: int = 0,
              x0: int = 0, device=None) -> torch.Tensor:
    """Per-node Bernoulli(p) mask as bool (unsigned compare of the hash)."""
    thresh = int(np.uint32(min(max(p, 0.0), 1.0) * 4294967295.0))
    c = counter_u32(shape, t, salt=salt, y0=y0, x0=x0, device=device)
    return (c.to(torch.int64) & 0xFFFFFFFF) < thresh


# ---------------------------------------------------------------------------
# Word-level (bit-plane) random sources: one hash gives a whole word of 32
# independent random bits, the 32-nodes-per-register idea applied to the
# RNG itself.
# ---------------------------------------------------------------------------

def word_u32(shape_words, t: int, salt: int, y0: int = 0, xw0: int = 0,
             device=None) -> torch.Tensor:
    """One word of 32 independent random bits per (row, word) counter;
    ``y0``/``xw0`` offset the counters (global coordinates of word (0, 0))."""
    h, wd = shape_words
    return word_u32_at(_coords(h, y0, device)[:, None],
                       _coords(wd, xw0, device)[None, :], t, salt)


def word_u32_at(rows: torch.Tensor, cols: torch.Tensor, t: int,
                salt: int) -> torch.Tensor:
    """Random words for explicit (broadcastable) int32 coordinate arrays."""
    ctr = rows.to(torch.int32) * _FNV + cols.to(torch.int32)
    return hash_u32(ctr ^ _tt(t, salt))


def quantize_p(p: float) -> int:
    """Round p to the BERNOULLI_BITS grid (Python's round: half to even);
    returns the integer threshold."""
    return int(round(min(max(p, 0.0), 1.0) * (1 << BERNOULLI_BITS)))


def bernoulli_words(shape_words, t: int, p: float, salt: int = 0x22,
                    y0: int = 0, xw0: int = 0, device=None) -> torch.Tensor:
    """Per-bit Bernoulli(p) over packed words (bit-serial comparator)."""
    h, wd = shape_words
    return bernoulli_words_at(_coords(h, y0, device)[:, None],
                              _coords(wd, xw0, device)[None, :], t, p,
                              salt=salt)


def bernoulli_words_at(rows: torch.Tensor, cols: torch.Tensor, t: int,
                       p: float, salt: int = 0x22) -> torch.Tensor:
    """``bernoulli_words`` for explicit (broadcastable) coordinates.

    An MSB-first comparison R < P between one random plane per round and
    the binary expansion of the quantised P, using only AND/OR/NOT; the
    rounds below the lowest set bit of P cannot change the result and are
    skipped."""
    shape = torch.broadcast_shapes(rows.shape, cols.shape)
    pq = quantize_p(p)
    if pq <= 0:
        return torch.zeros(shape, dtype=torch.int32, device=rows.device)
    if pq >= (1 << BERNOULLI_BITS):
        return torch.full(shape, -1, dtype=torch.int32, device=rows.device)
    res = torch.zeros(shape, dtype=torch.int32, device=rows.device)
    eq = torch.full(shape, -1, dtype=torch.int32, device=rows.device)
    last = (pq & -pq).bit_length() - 1
    for i in range(BERNOULLI_BITS - 1, last - 1, -1):
        r = word_u32_at(rows, cols, t, salt=salt * 0x100 + i)
        if (pq >> i) & 1:
            res = res | (eq & ~r)
            eq = eq & r
        else:
            eq = eq & ~r
    return res


def chirality_words(shape_words, t: int, y0: int = 0, xw0: int = 0,
                    device=None) -> torch.Tensor:
    """One random chirality bit per node, packed 32 nodes per word."""
    return word_u32(shape_words, t, salt=0x11, y0=y0, xw0=xw0, device=device)
