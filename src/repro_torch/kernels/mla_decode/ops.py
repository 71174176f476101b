"""The absorbed MLA decode's attention core as one hand-written kernel.

``attend(q_lat, q_rope, c, kr, pv, scale)`` computes, for every row ``b``
and head ``h``, the context over the row's live keys ``0..pv[b]``::

    s_t   = scale * (q_lat[b, h] . c[b, t] + q_rope[b, h] . kr[b, t])
    ctx   = sum_t softmax(s)_t * c[b, t]

which is ``models.attention.mla_attend`` (the plain version, the same
module as the decode that calls it) in one pass over each row's live
latent.  Shapes: ``q_lat`` (B, H, C) and ``q_rope`` (B, H, R) in bf16 or
fp16; the cache leaves ``c`` (B, T, C) and ``kr`` (B, T, R), read by their
strides (the last stride 1) and rounded to the queries' type as they load,
as the plain version's ``c.to(x.dtype)``; ``pv`` (B,) integer positions on
the card, read there (the host reads no position and does not
synchronise).  Returns ``ctx`` (B, H, C) in the queries' type.

It replaces no Pallas kernel: the JAX package leaves this attention to
XLA (``repro.models.attention.mla_decode``).  It was added because the
plain version on the card casts the whole cache to fp32, scores every row
against all ``T`` positions on the CUDA cores and sends each (B, H, T)
intermediate through device memory.

What bounds it on an H100: the live latent, ``(C + R)`` elements a key
read once, against the absorbed FLOPs, ``H (2 (C + R) + 2 C)`` a key.  At
128 heads that is ~240 FLOPs a latent byte, under the card's ~295: memory
bound, barely, so the latent must be read from device memory once and the
tensor cores must do the products.

What the design does about it (``csrc/mla_decode.cu``, CUDA C++ built by
``build.py`` into a library bound with ctypes):

* one block a (64-head tile, key split, row); it walks its split of the
  row's live keys in tiles of 64, copying the next tile in (``cp.async``)
  while it uses this one; a split past the row's position does no work;
* each key tile of ``c`` is loaded once and used twice, as the key of the
  scores (with ``kr``) and as the value of the context: MLA's point;
* heads are the products' M dimension (``mma.sync`` m16n8k16 on the
  tensor cores), so the query tile (64 heads x (C + R)) stays in shared
  memory across the keys; scores accumulate in fp32 (``q_lat c + q_rope
  kr`` in one accumulator), times the scale;
* online softmax in fp32; probabilities rounded to the queries' type for
  the product with ``c`` (as the plain version rounds its probabilities),
  the context accumulated in fp32 and rounded once;
* split-KV: ``plan`` cuts each row's keys into splits so that rows x head
  tiles x splits fill the card; a second small kernel merges the splits'
  (log-sum, normalised context) pairs in fp32.  With one split the first
  kernel writes the context itself.

Widths are compiled padded to (512, 64) (DeepSeek-V3) or (32, 16) (its
smoke twins: 4-8 heads, 16-32 + 8-16), the extra lanes zero; heads pad to
the 64 of a tile.

``LAUNCHES`` counts the kernels launched by kind (``"split"``, the first
pass; ``"merge"``, the second), a plain count for runs and tests to show
the path was taken.  The library is built, and loaded, at the first
launch.
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch

# Kernel launches since the count was last cleared, by kind.
LAUNCHES: collections.Counter = collections.Counter()

# Heads and keys a tile of the kernel (``BH`` and ``BN`` in the source).
BLOCK_H = 64
BLOCK_N = 64
# Blocks a streaming multiprocessor should have to walk before ``plan``
# stops splitting rows' keys, and the fewest keys a split holds.  One
# block holds an SM (225 KB of shared memory at DeepSeek-V3's widths).
PROGRAMS_PER_SM = 2
MIN_SPLIT_KEYS = 256
# The padded (C, R) widths the kernel is compiled for, narrowest first.
WIDTHS = ((32, 16), (512, 64))

TYPES = (torch.bfloat16, torch.float16)
# The cache's type code in the kernel: 0 is the queries' own type (copied
# by cp.async); the others are read and rounded as they load.
_CACHE_KIND = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3}
LOG2E = 1.4426950408889634
# The H100 SXM's dense bf16 peak and HBM rate (NVIDIA's data sheet).
PEAK_FLOPS, HBM_BYTES_PER_S = 989.4e12, 3.35e12


def launches_total() -> int:
    return sum(LAUNCHES.values())


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(rows: int, heads: int, t: int, n_sm: int) -> Tuple[int, int]:
    """``(splits, keys a split)`` for ``rows`` rows of ``heads`` heads over
    a cache of ``t`` positions on a card of ``n_sm`` multiprocessors:
    enough splits that rows x head tiles x splits give each multiprocessor
    ``PROGRAMS_PER_SM`` blocks, none shorter than ``MIN_SPLIT_KEYS`` keys
    (a whole number of key tiles)."""
    tiles_a_row = rows * cdiv(heads, BLOCK_H)
    want = cdiv(PROGRAMS_PER_SM * n_sm, tiles_a_row)
    return split_keys(t, max(1, min(want, cdiv(t, MIN_SPLIT_KEYS))))


def split_keys(t: int, splits: int) -> Tuple[int, int]:
    """``(splits, keys a split)`` of ``t`` positions cut into about
    ``splits`` splits of whole key tiles, none empty."""
    chunk = cdiv(cdiv(t, splits), BLOCK_N) * BLOCK_N
    return cdiv(t, chunk), chunk


def padded_widths(c_width: int, r_width: int) -> Tuple[int, int]:
    """The compiled ``(C, R)`` widths that hold ``c_width`` latent and
    ``r_width`` rotary lanes; raises for widths no kernel takes (not a
    multiple of 8, whose 16-byte rows the kernel copies, or too wide)."""
    if c_width % 8 or r_width % 8:
        raise ValueError(f"latent and rotary widths must be multiples of 8, "
                         f"got {c_width} and {r_width}")
    for cp, rp in WIDTHS:
        if c_width <= cp and r_width <= rp:
            return cp, rp
    raise ValueError(f"no kernel for widths {c_width} + {r_width} (at most "
                     f"{WIDTHS[-1][0]} + {WIDTHS[-1][1]})")


def _check(q_lat, q_rope, c, kr, pv):
    if not (q_lat.is_cuda and q_rope.is_cuda and c.is_cuda and kr.is_cuda
            and pv.is_cuda):
        raise ValueError("mla_decode.attend takes CUDA tensors only")
    if q_lat.dtype not in TYPES or q_rope.dtype != q_lat.dtype:
        raise ValueError(f"queries must share one of {TYPES}, got "
                         f"{q_lat.dtype} and {q_rope.dtype}")
    if c.dtype not in _CACHE_KIND or kr.dtype != c.dtype:
        raise ValueError(f"cache leaves must share one of "
                         f"{tuple(_CACHE_KIND)}, got {c.dtype} and "
                         f"{kr.dtype}")
    if q_lat.dim() != 3 or q_rope.dim() != 3 or c.dim() != 3 \
            or kr.dim() != 3 or pv.dim() != 1:
        raise ValueError("shapes: q_lat (B,H,C), q_rope (B,H,R), c (B,T,C), "
                         "kr (B,T,R), pv (B,)")
    b, h, cw = q_lat.shape
    r = q_rope.shape[2]
    t = c.shape[1]
    if (tuple(q_rope.shape) != (b, h, r) or tuple(c.shape) != (b, t, cw)
            or tuple(kr.shape) != (b, t, r) or pv.shape[0] != b):
        raise ValueError(f"shapes disagree: q_lat {tuple(q_lat.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, c {tuple(c.shape)}, "
                         f"kr {tuple(kr.shape)}, pv {tuple(pv.shape)}")
    if pv.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"positions must be int32 or int64, got {pv.dtype}")
    for name, x in (("q_lat", q_lat), ("q_rope", q_rope), ("c", c),
                    ("kr", kr)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    padded_widths(cw, r)


def _copies_whole_rows(q_lat, c, kr) -> bool:
    """The cache is in the queries' type and every key's ``c`` and ``kr``
    row starts on 16 bytes, so the kernel copies it by cp.async."""
    return (c.dtype == q_lat.dtype and kr.dtype == q_lat.dtype
            and all(x.data_ptr() % 16 == 0 and x.stride(0) % 8 == 0
                    and x.stride(1) % 8 == 0 for x in (c, kr)))


def attend(q_lat, q_rope, c, kr, pv, scale: float):
    """The context (B, H, C) of each row's live keys (see the module
    note), in ``plan``'s splits."""
    _check(q_lat, q_rope, c, kr, pv)
    b, h, _ = q_lat.shape
    n_sm = torch.cuda.get_device_properties(
        q_lat.device).multi_processor_count
    return _launch(q_lat, q_rope, c, kr, pv, scale,
                   plan(b, h, c.shape[1], n_sm))


def _launch(q_lat, q_rope, c, kr, pv, scale: float,
            split: Tuple[int, int]):
    """``attend`` on checked inputs in ``split`` = (splits, keys a split),
    ``plan``'s or ``split_keys``'s (a sweep chooses its own)."""
    from repro_torch.kernels.mla_decode import build
    b, h, cw = q_lat.shape
    r, t = q_rope.shape[2], c.shape[1]
    splits, chunk = split
    out = torch.empty((b, h, cw), dtype=q_lat.dtype, device=q_lat.device)
    if splits > 1:
        part_o = torch.empty((b, splits, h, cw), dtype=torch.float32,
                             device=q_lat.device)
        part_lse = torch.empty((b, splits, h), dtype=torch.float32,
                               device=q_lat.device)
    else:
        part_o = part_lse = out
    kind = 0 if _copies_whole_rows(q_lat, c, kr) else _CACHE_KIND[c.dtype]
    err = build.library().mla_decode_launch(
        q_lat.data_ptr(), q_rope.data_ptr(), c.data_ptr(), kr.data_ptr(),
        pv.data_ptr(), out.data_ptr(), part_o.data_ptr(),
        part_lse.data_ptr(), q_lat.stride(0), q_lat.stride(1),
        q_rope.stride(0), q_rope.stride(1), c.stride(0), c.stride(1),
        kr.stride(0), kr.stride(1), pv.stride(0), out.stride(0),
        out.stride(1), b, h, cw, r, t, chunk, splits, scale * LOG2E,
        TYPES.index(q_lat.dtype), kind, int(pv.dtype == torch.int64),
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"mla_decode launch failed (error {err})")
    LAUNCHES["split"] += 1
    if splits > 1:
        LAUNCHES["merge"] += 1
    return out


def work(pv, heads: int, c_width: int, r_width: int, t: int,
         elem_bytes: int = 2) -> Tuple[float, float]:
    """``(FLOPs, bytes)`` the core needs for positions ``pv`` (a host
    sequence): each live key's latent read once and its absorbed products,
    the queries read and the context written once."""
    keys = sum(min(int(p) + 1, t) for p in pv)
    rows = len(pv)
    flops = keys * heads * (2 * (c_width + r_width) + 2 * c_width)
    nbytes = elem_bytes * (keys * (c_width + r_width)
                           + rows * heads * (2 * c_width + r_width))
    return float(flops), float(nbytes)


def bound_seconds(pv, heads, c_width, r_width, t) -> float:
    """The least time an H100 could take for the core: the larger of its
    FLOPs at the dense bf16 peak and its bytes at the HBM rate."""
    flops, nbytes = work(pv, heads, c_width, r_width, t)
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
