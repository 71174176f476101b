"""Host wrappers of the fused, temporally blocked FHP step kernel.

``fhp_step_cuda`` has the keyword signature of the reference's
``repro.kernels.fhp_step.ops.fhp_step_pallas``: ``steps_per_launch`` = T
fused stream -> collide (-> force) steps in one launch on ``(NPS, H, Wd)``
or batched ``(B, NPS, H, Wd)`` int32 planes (lanes share the RNG stream),
``block_rows``/``block_words`` as the CUDA tile (on a streamed launch:
the rows a block owns and the widest strip's words), ``solid=`` for the
static-geometry layout, ``record_steps`` for fused moments,
``extended=True`` (with ``hg``/``wdg``) for a halo-extended shard and
``rng_in_kernel=False`` for one step with precomputed random words.
``run_cuda`` advances many steps like ``run_pallas``: ``steps // T`` full
launches plus one remainder launch, with the moments schedule unrolled.
``run_extended`` and ``run_extended_split`` advance a halo-extended shard
like their namesakes in the reference: the sharded stepper's hot path
(``core.distributed``); the split's two halves, ``run_extended_interior``
and ``run_extended_boundary`` (with ``boundary_slices`` and
``compose_split``), are the overlapped round's pieces.  ``launch_cost``,
``sharded_launch_cost`` and ``autotune_launch`` are the reference's cost
model and tile search, re-based on this kernel's shared memory and the
H100's rates.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel
(``csrc/fhp_step.cu``, built at first use) or raises; a CPU tensor takes
the plain version (``ref.fhp_step_ref``); any other device raises.  On
the card a periodic launch without a solid operand runs on the
row-streaming kernel wherever its rings fit (``stream_max_owned``), in
strips ``pick_stream`` sizes; every other launch runs on tiles
(``pick_tile``).  ``launch_cost``, ``COMPUTE_ROW_WEIGHT`` and the
autotuner price the tile design.

The CUDA tile need not divide the lattice (edge tiles mask their stores
and moments), so the reference's ``block_words | Wd`` rule and its row and
word padding in ``run_extended`` are dropped; its other argument checks
are kept.  The kernel always writes a fresh output, so ``donate`` (the
reference's in-place carry, a memory saving) is refused.

Telemetry spans (``repro_torch.telemetry``): ``fhp_step.launch``, one a
library call (the output and moments allocation and the call), and
``fhp_step.moments``, ``run_cuda``'s concatenation of a call's moment
records.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from repro_torch import telemetry
from repro_torch.core import prng, rulespec
from repro_torch.kernels.fhp_step import build, codegen
from repro_torch.kernels.fhp_step.ref import fhp_step_ref
from repro_torch.roofline import analysis as _roofline
from repro_torch.roofline import trace as rtrace

# Kernel launches since the count was last cleared, by mode ("periodic",
# "static_solid", "extended", "extended_static_solid", "precomputed_rng");
# "moments" counts the launches that also record moments, "streamed" the
# periodic launches that the row-streaming kernel ran.  Read by chip_smoke
# and the benchmark; ``launches_total`` sums the modes.
LAUNCHES: collections.Counter = collections.Counter()

SMEM_BYTES_PER_BLOCK = 232_448    # H100: 227 KB of shared memory per block
# pick_tile's shared memory a block: two blocks share an SM's 228 KB (the
# kernel's __launch_bounds__), each less the 1 KB the card reserves a
# block and 256 B for the kernel's static shared memory.
TILE_SMEM_BYTES = 233_472 // 2 - 1024 - 256
MAX_TILE = 64                     # pick_tile's row with its apron, words
# bw + 2T of a block: 16 warps of 64 words a row.  A wider tile runs as
# tiles of this width (``tile_words`` in csrc/fhp_step.cuh), same result.
MAX_TILE_WORDS = 1024
MAX_STEPS_PER_LAUNCH = 8          # run_extended's default T
_GRID_YZ_LIMIT = 65_535
_RULE_ID = {name: i for i, name in enumerate(codegen.RULES)}
# The kernel's Mode: "streamed" is a periodic launch by the row-streaming
# kernel.
_MODE_ID = {"periodic": 0, "extended": 1, "precomputed_rng": 2,
            "streamed": 3}
# The row-streaming kernel (csrc/fhp_step.cuh, "Row-streaming wavefront"):
# warps a block at most, input rows loaded ahead, ring slots of levels
# 1 .. T-1 (level 0 has STREAM_RING + STREAM_AHEAD), the dynamic shared
# memory a block may take (227 KB less 1 KB of static moment counters), and
# the SMs whose persistent blocks ``pick_stream`` prices (H100 SXM).
STREAM_WARPS = 24
STREAM_AHEAD = 4
STREAM_RING = 4
STREAM_SMEM_BYTES = SMEM_BYTES_PER_BLOCK - 1024
STREAM_SMS = 132
# Registers a thread under the kernel's launch bounds (65,536 over 768
# threads, in steps of 8): what ``stream_blocks_per_sm`` assumes.
STREAM_REGS = 80
_COUNTED_APART = ("moments", "streamed")   # not modes: kept out of the total


def launches_total() -> int:
    """Kernel launches of every mode since ``LAUNCHES`` was cleared."""
    return sum(n for mode, n in LAUNCHES.items()
               if mode not in _COUNTED_APART)


def rng_words(shape, t: int, *, p_force: float = 0.0, y0: int = 0,
              xw0: int = 0, variant: str = "fhp2", device=None):
    """``(chi, acc)``: the chirality and force words of step ``t`` on an
    ``(H, Wd)`` lattice at global word ``(y0, xw0)``, drawn on ``device``
    -- the planes kernel mode K2 reads.  Each is None where the step draws
    none (a rule without chirality; ``p_force`` 0)."""
    chi = acc = None
    if rulespec.get_rule(variant).needs_rng:
        chi = prng.chirality_words(shape, t, y0=y0, xw0=xw0, device=device)
    if prng.quantize_p(p_force) > 0:
        acc = prng.bernoulli_words(shape, t, p_force, y0=y0, xw0=xw0,
                                   device=device)
    return chi, acc


def smem_bytes(bh: int, bw: int, steps: int = 1, static_solid: bool = False,
               n_planes: int = 8) -> int:
    """Dynamic shared memory of one block (``smem_words`` in
    ``csrc/fhp_step.cuh``): one buffer of the ``bh + 2T`` tile rows for
    every stack plane, the solid plane's tile in static-solid mode (the
    two make ``n_planes`` either way), and one word per tile row (the
    kernel's table of RNG rows).  A row holds ``bw + 2T`` words (``bw``
    at most ``MAX_TILE_WORDS - 2T``), plus 3 where the tile origin can
    sit off a 16-byte boundary, rounded up to a multiple of 4."""
    bw = min(bw, MAX_TILE_WORDS - 2 * steps)
    w = bw + 2 * steps
    pitch = (w + (3 if (bw | steps) & 3 else 0) + 3) & ~3
    return 4 * (bh + 2 * steps) * (n_planes * pitch + 1)


def _tile_ok(bh: int, bw: int, h: int, wd: int, steps: int,
             static_solid: bool, n_planes: int) -> bool:
    return (steps <= bh and (bw >= wd or steps <= bw)
            and smem_bytes(bh, bw, steps, static_solid, n_planes)
            <= SMEM_BYTES_PER_BLOCK)


def pick_tile(h: int, wd: int, steps: int = 1, static_solid: bool = False,
              n_planes: int = 8) -> Tuple[int, int]:
    """``(block_rows, block_words)``: the most words whose row with its
    apron fills whole warp rows of ``MAX_TILE`` words (``bw + 2T`` a
    multiple of it, with ``bw >= T``), and the most rows whose tile fits
    ``TILE_SMEM_BYTES`` (two blocks an SM), both clipped to the lattice;
    rows are halved until the tile admits the ``steps``-row apron."""
    words = -(-3 * steps // MAX_TILE) * MAX_TILE - 2 * steps
    per_row = smem_bytes(1, words, steps, static_solid,
                         n_planes) // (1 + 2 * steps)
    rows = max(TILE_SMEM_BYTES // per_row - 2 * steps, steps)
    while rows >= 1:
        bh, bw = min(rows, h), min(words, wd)
        if _tile_ok(bh, bw, h, wd, steps, static_solid, n_planes):
            return bh, bw
        rows //= 2
    raise ValueError(f"no valid tile for H={h}, Wd={wd}, "
                     f"steps_per_launch={steps}")


# --------------------------------------------------------------------------
# The row-streaming kernel's geometry (``stream_geom`` in csrc/fhp_step.cuh).

def _ring_rows(steps: int) -> int:
    return STREAM_RING + STREAM_AHEAD + STREAM_RING * (steps - 1)


def stream_max_j(n_planes: int) -> int:
    """The most 32-word chunks a warp takes: 16 // ``n_planes`` as a power
    of two, 1 to 8 (8 for 2 planes, 2 for 8): as many as the shared memory
    lets a strip of so many planes need."""
    j = 1
    while j < 8 and 2 * j * n_planes <= 16:
        j *= 2
    return j


def stream_max_owned(steps: int, n_planes: int = 8) -> int:
    """The most words a strip can own at T = ``steps``: its row with the
    2T-word apron, 3 words of alignment and the rest of its last 32-word
    chunk within STREAM_WARPS warps (at most ``stream_max_j`` chunks a
    warp, T levels) and its T level rings within ``STREAM_SMEM_BYTES``.
    Below 1 the launch cannot stream."""
    by_smem = STREAM_SMEM_BYTES // (128 * _ring_rows(steps) * n_planes)
    by_warps = stream_max_j(n_planes) * (STREAM_WARPS // steps)
    return 32 * min(by_smem, by_warps) - 3 - 2 * steps


def stream_geometry(wd: int, steps: int, n_planes: int = 8,
                    block_words: int = 0) -> dict:
    """The streamed geometry of a launch of ``steps`` steps on rows of
    ``wd`` words with strips of at most ``block_words`` owned words
    (capped to ``stream_max_owned``; 0 takes the cap): ``strips`` spread
    evenly over the row, ``owned`` (the widest strip's words), ``words``
    (its row with the apron, W), ``chunks`` (32-word chunks of a ring
    row: W + 3 words), ``per_warp`` (chunks a warp takes: the least power
    of two, at most ``stream_max_j``, under which the T levels fit
    STREAM_WARPS warps), ``warps`` (a block: T x the warps a level) and
    ``smem_bytes`` (T rings of ``n_planes`` planes: level 0's STREAM_RING
    + STREAM_AHEAD rows, the others' STREAM_RING).  Raises where the
    launch cannot stream."""
    T = int(steps)
    most = stream_max_owned(T, n_planes)
    if most < 1:
        raise ValueError(f"steps_per_launch={T} with {n_planes} planes "
                         "cannot stream")
    bw = max(min(int(block_words) or most, most), 1)
    ns = -(-wd // bw)
    owned = -(-wd // ns)
    w = owned + 2 * T
    nc = -(-(w + 3) // 32)
    j = next(j for j in (1, 2, 4, 8) if T * -(-nc // j) <= STREAM_WARPS)
    return {"strips": ns, "owned": owned, "words": w, "chunks": nc,
            "per_warp": j, "warps": T * -(-nc // j),
            "smem_bytes": 128 * _ring_rows(T) * nc * n_planes}


def stream_blocks_per_sm(geometry: dict) -> int:
    """Streamed blocks of ``geometry`` an SM holds at once, as the card
    counts them with ``STREAM_REGS`` registers a thread: 2,048 threads,
    65,536 registers and 228 KB of shared memory an SM (1 KB of it
    reserved a block, 1 KB the static moment counters)."""
    threads = 32 * geometry["warps"]
    return max(1, min(2048 // threads, 65536 // (threads * STREAM_REGS),
                      233_472 // (geometry["smem_bytes"] + 2048)))


def _stream_waves(h: int, wd: int, steps: int, n_planes: int, lanes: int,
                  block_words: int, blocks: int):
    """The geometry of a streamed launch and the waves its blocks run in
    all: n + 3T for each segment of n rows, the ``blocks`` shares (0:
    ``STREAM_SMS`` x ``stream_blocks_per_sm``) cutting the lanes' strip
    rows into segments at the share ends and at every (lane, strip)."""
    g = stream_geometry(wd, steps, n_planes, block_words)
    rows = lanes * g["strips"] * h
    nb = min(blocks or STREAM_SMS * stream_blocks_per_sm(g), rows)
    cuts = {rows * k // nb for k in range(nb + 1)} | {
        h * k for k in range(lanes * g["strips"] + 1)}
    return g, rows + 3 * int(steps) * (len(cuts) - 1)


def stream_thread_steps(h: int, wd: int, steps: int, n_planes: int = 8,
                        lanes: int = 1, block_words: int = 0,
                        blocks: int = 0) -> float:
    """Thread word-steps a streamed launch issues per word-step it owns
    (the counterpart of a tile's whole-warp rows): every wave takes 32 x
    warps x chunks-a-warp thread slots (``_stream_waves``), for lanes x H
    x Wd x T owned word-steps."""
    g, waves = _stream_waves(h, wd, steps, n_planes, lanes, block_words,
                             blocks)
    slots = waves * 32 * g["warps"] * g["per_warp"]
    return slots / (lanes * h * wd * int(steps))


# ``stream_cost``'s constants, fitted to the streamed launch times of fhp2
# and BML at T = 1, 2, 4 and 8 over 2-10 strips on 4 x 4096 x 1024 words
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): a warp's work in a wave
# besides its words, in units of a level's word-step on one 32-word chunk,
# and the warps an SM needs to keep its pipes busy.
STREAM_WAVE_COST = 0.42
STREAM_FULL_WARPS = 18


def stream_cost(h: int, wd: int, steps: int, n_planes: int = 8,
                lanes: int = 1, block_words: int = 0) -> float:
    """Modeled cost of a streamed launch, in word-steps of one 32-word
    chunk: every wave (``_stream_waves``) computes its T levels' chunks
    and costs each warp STREAM_WAVE_COST more, over the share of
    STREAM_FULL_WARPS warps an SM holds (at most 1)."""
    g, waves = _stream_waves(h, wd, steps, n_planes, lanes, block_words, 0)
    held = g["warps"] * stream_blocks_per_sm(g) / STREAM_FULL_WARPS
    return (waves * (g["warps"] * STREAM_WAVE_COST + int(steps) * g["chunks"])
            / min(1.0, held))


@functools.lru_cache(maxsize=256)
def pick_stream(h: int, wd: int, steps: int = 1, n_planes: int = 8,
                lanes: int = 1):
    """``block_words`` of a streamed launch on ``lanes`` lanes of ``(h,
    wd)`` words at T = ``steps``: over the strip counts, the widest owned
    words of the strips of least ``stream_cost`` (the fewer strips on a
    tie); None where the launch cannot stream."""
    T = int(steps)
    most = stream_max_owned(T, n_planes)
    if most < 1:
        return None
    best = None
    for ns in range(-(-wd // most), wd + 1):
        bw = -(-wd // ns)
        if -(-wd // bw) != ns:
            continue
        cost = stream_cost(h, wd, T, n_planes, lanes, bw)
        if best is None or cost < best[0]:
            best = (cost, bw)
        # Past twice the least cost, narrower strips only add apron.
        if bw <= 2 * T or cost > 2 * best[0]:
            break
    return best[1]


# --------------------------------------------------------------------------
# The launch cost model and the autotuner (reference ops.py:43-50,
# :157-362), re-based on the H100: tiles are bounded by the kernel's shared
# memory (``smem_bytes`` against ``TILE_SMEM_BYTES``, two blocks an SM) and
# a word-step of compute is priced at the card's own rate.

# The cost of one thread word-step of the kernel against moving one 8-plane
# word cell (32 B) through device memory: the weight of redundant apron
# compute in ``launch_cost`` and ``sharded_launch_cost``.  The reference's
# 0.2 prices a memory-bound TPU kernel; this kernel is bound by its integer
# work.  chip_smoke.py phase 4's ``[split]`` fit on an NVIDIA H100 80GB HBM3
# (700 W) gives 21.1448 ms per 1e9 thread word-steps, 2.1145e-11 s each,
# against 32 B / 3.35e12 B/s = 9.5522e-12 s a word cell: 2.21.
COMPUTE_ROW_WEIGHT = 2.21


def launch_cost(bh: int, steps: int, block_words: int = 0,
                width_words: int = 0, moments_words: int = 0) -> float:
    """Modeled cost per useful site update, in word-cell units of memory
    traffic: per tile per launch a ``(bh + 2*steps) x (bw + 2*hx)`` read
    (``hx`` = ``steps`` when the tile is narrower than the lattice, else 0)
    and a ``bh x bw`` write, plus the shrinking apron extents of redundant
    compute weighted by ``COMPUTE_ROW_WEIGHT``, for ``bh * bw * steps``
    useful word-updates; ``moments_words`` (records x n_moments) adds the
    moments each tile writes.  The reference's formula."""
    bw = (min(block_words, width_words) if block_words and width_words
          else block_words) or width_words or 1
    x_blocked = bool(block_words and width_words and
                     block_words < width_words)
    hx = steps if x_blocked else 0
    mem = (bh + 2 * steps) * (bw + 2 * hx) + bh * bw + moments_words
    comp = sum((bh + 2 * (steps - s - 1))
               * (bw + 2 * (steps - s - 1) if x_blocked else bw)
               for s in range(steps))
    return (mem + COMPUTE_ROW_WEIGHT * comp) / (bh * bw * steps)


def hbm_bytes_per_site(bh: int, steps: int, block_words: int = 0,
                       width_words: int = 0, n_planes: int = 8,
                       moments_words: int = 0) -> float:
    """Modeled device-memory bytes per site update of one T-step launch
    (``n_planes`` 4-byte words a word cell, ``moments_words`` the moments
    each tile writes)."""
    bw = (min(block_words, width_words) if block_words and width_words
          else block_words) or width_words or 1
    x_blocked = bool(block_words and width_words and
                     block_words < width_words)
    hx = steps if x_blocked else 0
    return ((n_planes * 4 * ((bh + 2 * steps) * (bw + 2 * hx) + bh * bw)
             + 4 * moments_words)
            / (32.0 * bh * bw * steps))


def sharded_hbm_bytes_per_site(bh: int, steps: int, depth: int,
                               hl: int, wdl: int,
                               static_solid: bool = False,
                               block_words: int = 0,
                               n_planes: int = 8) -> float:
    """Modeled device-memory bytes per useful site update of the sharded
    extended-shard path (``roofline.analysis.sharded_fhp_traffic``)."""
    return _roofline.sharded_fhp_traffic(
        hl, wdl, depth=depth, T=steps, block_rows=bh,
        block_words=block_words, n_planes=n_planes,
        static_solid=static_solid)["hbm_bytes_per_site_step"]


def sharded_launch_cost(bh: int, steps: int, depth: int,
                        hl: int, wdl: int, *,
                        static_solid: bool = False,
                        block_words: int = 0,
                        n_planes: int = 8,
                        overlap: bool = False,
                        exchange_latency_s: float | None = None) -> float:
    """Modeled seconds per useful site update of the sharded path on the
    H100's datasheet rates: memory, weighted apron compute, exchange bytes
    and exchange latency (``roofline.analysis.sharded_fhp_traffic``).
    ``overlap`` prices the split round: ``max(t_exchange, t_interior) +
    t_boundary`` where that is cheaper than the serial sum, else the
    serial cost.  ``exchange_latency_s=None`` takes
    ``measured_exchange_latency()``."""
    if exchange_latency_s is None:
        exchange_latency_s = _roofline.measured_exchange_latency()
    return _roofline.sharded_fhp_traffic(
        hl, wdl, depth=depth, T=steps, block_rows=bh,
        block_words=block_words, n_planes=n_planes,
        compute_row_weight=COMPUTE_ROW_WEIGHT,
        exchange_latency_s=exchange_latency_s,
        static_solid=static_solid, overlap=overlap)["total_s_per_site"]


def _bw_candidates(width: int, divisors_only: bool):
    """Word-block candidates: the full width plus descending powers of two
    (only divisors of ``width`` with ``divisors_only``).  The reference's
    list."""
    cands = [width]
    bw = 1
    while bw * 2 < width:
        bw *= 2
    while bw >= 1:
        if not divisors_only or width % bw == 0:
            cands.append(bw)
        bw //= 2
    return cands


def _tile_candidates(h: int, wd: int, steps: int, static_solid: bool = False,
                     n_planes: int = 8, smem_budget: int = TILE_SMEM_BYTES):
    """The ``(block_rows, block_words)`` the autotuner tries at T =
    ``steps``: words from ``_bw_candidates`` (no divisibility: edge tiles
    mask) and the widths whose row with its apron fills whole 64-word warp
    rows (``64k - 2T``, ``pick_tile``'s); rows 1, 2, 4, every multiple of
    8 and the most whose tile fits ``smem_budget``, clipped to ``h``.
    Every tile passes ``_tile_ok`` and fits the budget."""
    words = _bw_candidates(wd, divisors_only=False)
    words += [w for w in range(MAX_TILE - 2 * steps, wd, MAX_TILE)
              if w not in words]
    for bw in words:
        per_row = smem_bytes(1, bw, steps, static_solid,
                             n_planes) // (1 + 2 * steps)
        most = min(smem_budget // per_row - 2 * steps, h)
        rows = sorted({r for r in (1, 2, 4, most) if r <= most}
                      | set(range(8, most + 1, 8)), reverse=True)
        for bh in rows:
            if (smem_bytes(bh, bw, steps, static_solid, n_planes)
                    <= smem_budget and _tile_ok(bh, bw, h, wd, steps,
                                                static_solid, n_planes)):
                yield bh, bw


def autotune_launch(h: int, wd: int, *, max_steps: int = MAX_STEPS_PER_LAUNCH,
                    smem_budget: int = TILE_SMEM_BYTES,
                    max_depth: int | None = None,
                    static_solid: bool = False,
                    n_planes: int = 8,
                    exchange_latency_s: float | None = None,
                    moments_words: int = 0):
    """The launch configuration of least modeled cost over
    ``_tile_candidates`` (tiles within ``smem_budget``) and T in ``[1,
    max_steps]``.

    Single device (``max_depth=None``): ``(block_rows, block_words,
    steps_per_launch)`` minimising ``launch_cost`` on an ``(h, wd)``
    lattice; ``moments_words`` (records x n_moments) prices the moments.

    Sharded (``max_depth`` set): ``h``/``wd`` are the shard's ``hl`` /
    ``wdl``, and the result is ``(block_rows, block_words,
    steps_per_launch, depth, overlap)`` minimising
    ``sharded_launch_cost`` over depths ``T <= depth <= min(max_depth,
    31, hl)`` (the x halo is one word; the exchange reaches the nearest
    shard only) and both values of ``overlap``; ties keep
    ``overlap=False``.  ``block_words`` is a tile of the extended width
    ``wdl + 2``.  ``exchange_latency_s=None`` takes
    ``measured_exchange_latency()``.  Nothing on the main path calls
    this."""
    best, best_cost = None, None
    if max_depth is None:
        for T in range(1, max_steps + 1):
            for bh, bw in _tile_candidates(h, wd, T, static_solid, n_planes,
                                           smem_budget):
                cost = launch_cost(bh, T, bw, wd, moments_words=moments_words)
                if best_cost is None or cost < best_cost:
                    best, best_cost = (bh, bw, T), cost
        if best is None:
            raise ValueError(f"no valid launch config for H={h}, Wd={wd}")
        return best

    if exchange_latency_s is None:
        exchange_latency_s = _roofline.measured_exchange_latency()
    hl, wdl = h, wd
    deepest = min(max_depth, 31, hl)
    for T in range(1, min(max_steps, deepest) + 1):
        for bh, bw in _tile_candidates(hl, wdl + 2, T, static_solid,
                                       n_planes, smem_budget):
            for depth in range(T, deepest + 1):
                # One call prices both plans: its serial cost, and the
                # split round's where that is cheaper (else the same).
                m = _roofline.sharded_fhp_traffic(
                    hl, wdl, depth=depth, T=T, block_rows=bh,
                    block_words=bw, n_planes=n_planes,
                    compute_row_weight=COMPUTE_ROW_WEIGHT,
                    exchange_latency_s=exchange_latency_s,
                    static_solid=static_solid, overlap=True)
                for overlap, cost in ((False, m["serial_s_per_site"]),
                                      (True, m["total_s_per_site"])):
                    if best_cost is None or cost < best_cost:
                        best, best_cost = (bh, bw, T, depth,
                                           overlap), cost
    if best is None:
        raise ValueError(f"no valid sharded launch config for "
                         f"hl={hl}, wdl={wdl}")
    return best


def fhp_step_cuda(planes: torch.Tensor, t: int, *, p_force: float = 0.0,
                  y0: int = 0, xw0: int = 0, block_rows: int = 0,
                  block_words: int = 0, rng_in_kernel: bool = True,
                  variant: str = "fhp2", steps_per_launch: int = 1,
                  extended: bool = False, hg: int | None = None,
                  wdg: int | None = None, donate: bool = False,
                  solid: torch.Tensor | None = None,
                  record_steps: tuple = (),
                  moment_bounds: tuple | None = None,
                  rng_planes: tuple | None = None):
    """``steps_per_launch`` fused steps of rule ``variant`` in one launch.

    ``y0``/``xw0`` are the global coordinates of word (0, 0) (RNG counters
    and row parity).  ``solid`` switches on static-geometry mode:
    ``planes`` then carries the dynamic planes only and the ``(H, Wd)``
    solid plane is a read-only operand shared by all lanes.
    ``record_steps`` (in-launch step indices) returns ``(planes, moments)``
    with ``moments`` ``(B?, len(record_steps), n_moments)`` int32, the
    rule's ``MomentSpec`` after each recorded step, over array rows
    ``[r0, r1)`` x words ``[c0, c1)`` when ``moment_bounds = (r0, r1, c0,
    c1)``.

    ``extended`` runs the non-wrapping shard mode on a halo-extended array
    (kernel mode K5, and K6's extended half with ``solid``): ``hg``/``wdg``
    are the global lattice extents in rows and words that the RNG reduces
    ``y0 + row`` and ``xw0 + word`` mod, so apron cells draw the owning
    shard's stream.  Each launch shrinks the valid region by T rows per
    side and one lattice column per step.

    ``rng_in_kernel=False`` (kernel mode K2, T = 1) reads the chirality and
    force words from ``(H, Wd)`` planes instead of hashing them in the
    kernel: ``rng_planes = (chi, acc)`` when given, else this wrapper draws
    them with ``rng_words`` on the tensor's device."""
    spec = rulespec.get_rule(variant)
    squeeze = planes.dim() == 3
    if squeeze:
        planes = planes[None]
    if planes.dim() != 4 or planes.dtype != torch.int32:
        raise ValueError(f"planes must be (B?, P, H, Wd) int32 bit-views, "
                         f"got {tuple(planes.shape)} {planes.dtype}")
    b, np_, h, wd = planes.shape
    static_solid = solid is not None
    want = spec.n_planes - 1 if static_solid else spec.n_planes
    if np_ != want:
        raise ValueError(
            f"plane stack has {np_} planes; rule {variant!r} expects "
            f"{want}{' dynamic (solid passed separately)' if static_solid else ''}")
    if static_solid and spec.solid_plane is None:
        raise ValueError(f"rule {variant!r} has no solid plane")
    if static_solid and tuple(solid.shape) != (h, wd):
        raise ValueError(f"solid plane {tuple(solid.shape)} != lattice "
                         f"{(h, wd)}")
    if p_force > 0 and spec.force is None:
        raise ValueError(f"rule {variant!r} has no force pass: p_force=0")
    T = int(steps_per_launch)
    if not 1 <= T <= 31:      # the kernel's record_mask is a 32-bit int
        raise ValueError(f"steps_per_launch={T} outside [1, 31]")
    if T != 1 and not rng_in_kernel:
        raise ValueError("steps_per_launch > 1 requires rng_in_kernel=True "
                         "(precomputed RNG planes cover a single step)")
    if static_solid and not rng_in_kernel:
        raise ValueError("static-solid mode is a fused-path feature "
                         "(rng_in_kernel=True)")
    if donate:
        raise ValueError(
            "donate=True (in-place update) is not supported: the kernel "
            "always writes a fresh output and run_extended ping-pongs "
            "between launches, which costs memory, not results")
    if extended:
        if not rng_in_kernel:
            raise ValueError("extended mode draws global-coordinate RNG "
                             "in-kernel (rng_in_kernel=True)")
        if hg is None or wdg is None:
            raise ValueError("extended mode needs the global extents hg/wdg")
        if hg < 1 or hg % 2 or wdg < 1:
            raise ValueError(f"extended mode needs an even hg >= 2 and "
                             f"wdg >= 1 (row parity must wrap), got "
                             f"hg={hg}, wdg={wdg}")
    if rng_planes is not None and rng_in_kernel:
        raise ValueError("rng_planes are read with rng_in_kernel=False only")
    if rng_planes is not None and any(
            a is not None and tuple(a.shape) != (h, wd) for a in rng_planes):
        raise ValueError(f"rng_planes must be (H, Wd) = {(h, wd)} planes")
    chi = acc = None
    if not rng_in_kernel:
        chi, acc = rng_planes or rng_words(
            (h, wd), t, p_force=p_force, y0=y0, xw0=xw0, variant=variant,
            device=planes.device)
    # The row-streaming kernel takes the periodic launches without a solid
    # operand (csrc/fhp_step.cuh, "Row-streaming wavefront"), where its
    # rings fit; every other launch runs on tiles.
    streamed = (not extended and solid is None and chi is None
                and acc is None and stream_max_owned(T, spec.n_planes) >= 1)
    if block_rows and block_words:
        bh, bw = int(block_rows), int(block_words)
    else:
        auto = pick_tile(h, wd, T, static_solid, spec.n_planes)
        bh, bw = int(block_rows) or auto[0], int(block_words) or auto[1]
    if T > bh:
        raise ValueError(f"steps_per_launch={T} > block_rows={bh}")
    if bw < wd and T > bw:
        raise ValueError(f"steps_per_launch={T} > block_words={bw}")
    if streamed:
        # A block owns its share of rows (block_rows, else the card's
        # resident blocks share them out) of strips of at most block_words.
        bh = int(block_rows)
        bw = int(block_words) or pick_stream(h, wd, T, spec.n_planes, b)
    else:
        need = smem_bytes(bh, bw, T, static_solid, spec.n_planes)
        if need > SMEM_BYTES_PER_BLOCK:
            raise ValueError(f"tile ({bh}, {bw}) at T={T} needs {need} B of "
                             f"shared memory > {SMEM_BYTES_PER_BLOCK}")
    rs = tuple(sorted(set(int(s) for s in record_steps)))
    if any(not 0 <= s < T for s in rs):
        raise ValueError(f"record_steps {rs} outside [0, {T})")
    if rs:
        ms = rulespec.moment_spec(spec, stack_planes=np_)
        rulespec.require_moment_headroom(
            ms, (hg * wdg if extended else h * wd) * 32)
    r0, r1, c0, c1 = moment_bounds or (0, h, 0, wd)
    bounds = (max(r0, 0), min(r1, h), max(c0, 0), min(c1, wd))

    if planes.device.type == "cpu":
        out = fhp_step_ref(planes, t, p_force=p_force, y0=y0, xw0=xw0,
                           variant=variant, steps_per_launch=T, solid=solid,
                           record_steps=rs, extended=extended, hg=hg,
                           wdg=wdg, moment_bounds=bounds, chi=chi,
                           accel=acc)
    elif planes.device.type == "cuda" or (planes.device.type == "meta"
                                          and rtrace.active() is not None):
        # Under a roofline recorder (a dry-run) a meta tensor stands for a
        # launch that is recorded, not run.
        mode = ("extended" if extended else
                "precomputed_rng" if chi is not None or acc is not None
                else "periodic")
        if planes.device.type == "cuda":
            out = _launch(planes, solid, chi, acc, _RULE_ID[variant],
                          _MODE_ID["streamed" if streamed else mode], t, y0,
                          xw0, hg or 0, wdg or 0, bh, bw, T,
                          prng.quantize_p(p_force), rs,
                          ms.n_moments if rs else 0, bounds)
        else:
            # A dry-run's shapes: what the launch would return, no launch.
            out = torch.empty_like(planes)
            if rs:
                out = (out, torch.empty((b, len(rs), ms.n_moments),
                                        dtype=torch.int32, device="meta"))
        if static_solid:
            mode = "static_solid" if mode == "periodic" else \
                "extended_static_solid"
        # The launch is one op no dispatch mode sees: report its bytes.
        reads = [planes, solid, chi, acc]
        rtrace.note_kernel(
            f"fhp_step[{mode}]",
            sum(x.numel() * x.element_size() for x in reads if x is not None),
            sum(x.numel() * x.element_size()
                for x in (out if rs else (out,))))
        if planes.device.type == "cuda":
            LAUNCHES[mode] += 1
            if rs:
                LAUNCHES["moments"] += 1
            if streamed:
                LAUNCHES["streamed"] += 1
    else:
        raise ValueError(f"fhp_step_cuda runs on CUDA tensors (and its plain "
                         f"version on CPU tensors; on meta tensors under a "
                         f"roofline recorder), not {planes.device}")
    if rs:
        p, m = out
        return (p[0], m[0]) if squeeze else (p, m)
    return out[0] if squeeze else out


def _launch(planes, solid, chi, acc, rule_id, mode_id, t, y0, xw0, hg, wdg,
            bh, bw, T, pq, rs, n_moments, bounds):
    """One kernel launch on CUDA tensors; raises if it is refused."""
    b, _, h, wd = planes.shape
    if mode_id != _MODE_ID["streamed"] and (-(-h // bh) > _GRID_YZ_LIMIT
                                            or b > _GRID_YZ_LIMIT):
        raise ValueError(f"grid ({-(-h // bh)} row tiles, {b} lanes) "
                         f"exceeds {_GRID_YZ_LIMIT}")
    with telemetry.span("fhp_step.launch"):
        x = planes.contiguous()
        out = torch.empty_like(x)
        operands = []
        for name, a in (("solid", solid), ("chi", chi), ("acc", acc)):
            if a is not None and (a.device != x.device
                                  or a.dtype != torch.int32):
                raise ValueError(f"{name} must be int32 on {x.device}")
            operands.append(None if a is None else a.contiguous())
        mom = (torch.zeros((b, len(rs), n_moments), dtype=torch.int32,
                           device=x.device) if rs else None)
        mask = sum(1 << s for s in rs)
        lib = build.library()
        with torch.cuda.device(x.device):
            err = lib.fhp_step_launch(
                x.data_ptr(), out.data_ptr(),
                *(None if a is None else a.data_ptr() for a in operands),
                None if mom is None else mom.data_ptr(),
                rule_id, mode_id, b, h, wd, bh, bw, T, int(t) & 0xFFFFFFFF,
                prng.i32(y0), prng.i32(xw0), hg, wdg, *bounds, pq, mask,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fhp_step kernel launch failed: CUDA error {err}")
    return (out, mom) if rs else out


def kernel_info(variant: str = "fhp2", mode: str = "periodic",
                static_solid: bool = False, block_rows: int = 32,
                block_words: int = 32, steps_per_launch: int = 8) -> dict:
    """What the card gives the kernel instantiation of a launch with these
    arguments, asked without launching it: resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes a thread, and dynamic shared bytes a block."""
    info = (ctypes.c_int * 4)()
    err = build.library().fhp_step_info(
        _RULE_ID[variant], _MODE_ID[mode], int(static_solid), block_rows,
        block_words, steps_per_launch, info)
    if err:
        raise RuntimeError(f"fhp_step_info failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes"), info))


def _launch_schedule(sizes, offset: int, k: int):
    """Per-launch ``record_steps`` for a record-every-``k`` cadence: launch
    ``j`` of length ``L`` records at in-launch step ``s`` exactly when the
    absolute step count ``offset + done + s + 1`` is a multiple of ``k``."""
    done = 0
    out = []
    for L in sizes:
        out.append(tuple(s for s in range(L)
                         if (offset + done + s + 1) % k == 0))
        done += L
    return out


def run_cuda(planes: torch.Tensor, steps: int, *, p_force: float = 0.0,
             t0: int = 0, steps_per_launch: int = 1,
             moments_every: int = 0, **kw):
    """Advance ``steps`` fused steps: ``steps // T`` launches of T steps and
    **one** launch of the ``steps % T`` remainder.

    ``moments_every`` = k > 0 returns ``(planes, moments)``:
    ``moments[..., r, :]`` is the rule's ``MomentSpec`` of the state after
    step ``(r + 1) * k``, recorded in-kernel."""
    T = int(steps_per_launch)
    full, rem = divmod(int(steps), T)
    sizes = [T] * full + ([rem] if rem else [])
    k = int(moments_every)
    schedule = _launch_schedule(sizes, 0, k) if k else [()] * len(sizes)
    out = planes
    moms = []
    done = 0
    for L, rs in zip(sizes, schedule):
        res = fhp_step_cuda(out, t0 + done, p_force=p_force,
                            steps_per_launch=L, record_steps=rs, **kw)
        if rs:
            out, m = res
            moms.append(m)
        else:
            out = res
        done += L
    if not k:
        return out
    if moms:
        with telemetry.span("fhp_step.moments"):
            return out, torch.cat(moms, dim=-2)
    spec = rulespec.get_rule(kw.get("variant", "fhp2"))
    ms = rulespec.moment_spec(spec, stack_planes=planes.shape[-3])
    return out, torch.zeros(planes.shape[:-3] + (0, ms.n_moments),
                            dtype=torch.int32, device=planes.device)


def run_extended(ext: torch.Tensor, steps: int, *, t0: int = 0,
                 p_force: float = 0.0, y0: int = 0, xw0: int = 0, hg: int,
                 wdg: int, steps_per_launch: int | None = None,
                 block_rows: int = 0, block_words: int = 0,
                 solid_ext: torch.Tensor | None = None,
                 moments_every: int = 0, moments_offset: int = 0, **kw):
    """Advance a halo-extended shard array ``steps`` steps in
    ceil(steps / T) extended-mode launches (T = ``steps_per_launch``,
    default ``min(steps, 8)``).

    ``ext`` is the ``(..., P, He, Wde)`` shard plus apron; ``y0``/``xw0``
    are the global coordinates of its element (0, 0), the apron corner.
    After the call rows ``[steps, He - steps)`` and words ``[1, Wde - 1)``
    hold the stepped shard (validity shrinks one row per side and one
    lattice column per step; the usual call has ``He = hl + 2*steps``, so
    exactly the owned block survives).  The rest is unspecified.

    ``solid_ext`` is the static-geometry cache: the ``(He, Wde)``
    pre-extended solid plane of this shard's tile; ``ext`` then carries
    the dynamic planes only.  It holds the true global solid, so one cache
    serves every launch and round.

    ``block_rows``/``block_words`` (0 = ``pick_tile``'s) are capped to the
    array.  ``moments_every`` = k > 0 returns ``(ext, moments)``: the
    rule's ``MomentSpec`` over the final validity window after every step
    where ``(moments_offset + step + 1) % k == 0`` (``moments_offset``
    carries the cadence phase across exchange rounds)."""
    spec = rulespec.get_rule(kw.get("variant", "fhp2"))
    steps = int(steps)
    T = int(steps_per_launch or min(steps, MAX_STEPS_PER_LAUNCH))
    he, wde = ext.shape[-2:]
    if solid_ext is not None and tuple(solid_ext.shape) != (he, wde):
        raise ValueError(f"solid_ext {tuple(solid_ext.shape)} != extended "
                         f"shard {(he, wde)}")
    bh, bw = int(block_rows), int(block_words)
    if not (bh and bw):
        auto = pick_tile(he, wde, min(T, steps), solid_ext is not None,
                         spec.n_planes)
        bh, bw = bh or auto[0], bw or auto[1]
    bh, bw = min(bh, he), min(bw, wde)   # no tile larger than the array
    full, rem = divmod(steps, T)
    sizes = [T] * full + ([rem] if rem else [])
    k = int(moments_every)
    schedules = (_launch_schedule(sizes, int(moments_offset), k) if k
                 else [()] * len(sizes))
    bounds = (steps, he - steps, 1, wde - 1)
    moms = []
    done = 0
    for L, rs in zip(sizes, schedules):
        res = fhp_step_cuda(ext, t0 + done, p_force=p_force, y0=y0, xw0=xw0,
                            steps_per_launch=L, block_rows=bh,
                            block_words=bw, extended=True, hg=hg, wdg=wdg,
                            solid=solid_ext, record_steps=rs,
                            moment_bounds=bounds, **kw)
        if rs:
            ext, m = res
            moms.append(m)
        else:
            ext = res
        done += L
    if not k:
        return ext
    if moms:
        return ext, torch.cat(moms, dim=-2)
    ms = rulespec.moment_spec(spec, stack_planes=ext.shape[-3])
    return ext, torch.zeros(ext.shape[:-3] + (0, ms.n_moments),
                            dtype=torch.int32, device=ext.device)


def boundary_slices(ext: torch.Tensor, steps: int):
    """``(top, bottom, left, right)``: the four views of a halo-extended
    shard ``(..., hl + 2d, wdl + 2)`` that the boundary launches read (d =
    ``steps``) -- the ``3d``-row bands at either end at full extended
    width (``d`` halo rows, corners included, and the ``2d`` own rows
    whose light cone reaches them) and the 3-word strips over the shard
    rows at either side (the halo word and two own words)."""
    d = int(steps)
    he, wde = ext.shape[-2:]
    return (ext[..., :3 * d, :], ext[..., he - 3 * d:, :],
            ext[..., d:he - d, :3], ext[..., d:he - d, wde - 3:])


def run_extended_interior(tile: torch.Tensor, steps: int, *, y0: int = 0,
                          xw0: int = 0, solid: torch.Tensor | None = None,
                          **kw):
    """The interior half of the split round: ``run_extended`` on the bare
    ``(..., hl, wdl)`` shard ``tile`` (its word (0, 0) at global ``(y0,
    xw0)``), which reads no halo and so can run while the halo is
    exchanged.  After the call rows ``[d, hl - d)`` and words ``[1, wdl -
    1)`` hold the stepped shard (d = ``steps``), and the moments cover
    that window.  ``solid`` is the shard's own ``(hl, wdl)`` solid window
    in static-geometry mode; ``kw`` as ``run_extended``'s."""
    return run_extended(tile, steps, y0=y0, xw0=xw0, solid_ext=solid, **kw)


def run_extended_boundary(slices, steps: int, *, y0: int = 0, xw0: int = 0,
                          solid=None, moments_every: int = 0, **kw):
    """The boundary half of the split round: one ``run_extended`` on each
    of the four ``boundary_slices`` ``(top, bottom, left, right)`` of a
    shard whose own word (0, 0) lies at global ``(y0, xw0)``; ``solid``
    the same four slices of its extended solid (static geometry).

    Returns the four valid pieces -- shard rows ``[0, d)`` and ``[hl - d,
    hl)`` at full shard width, and words ``0`` and ``wdl - 1`` of rows
    ``[d, hl - d)`` -- which ``compose_split`` writes into the interior
    half's output; with ``moments_every`` = k, ``(pieces, moments)``, the
    moments summed in int32 over the four pieces' windows."""
    d = int(steps)
    hl, wdl = slices[2].shape[-2], slices[0].shape[-1] - 2
    origins = ((-d, -1), (hl - 2 * d, -1), (0, -1), (0, wdl - 2))
    k = int(moments_every)
    outs, moms = [], []
    for x, (dy, dx), sol in zip(slices, origins, solid or (None,) * 4):
        out = run_extended(x, d, y0=y0 + dy, xw0=xw0 + dx, solid_ext=sol,
                           moments_every=k, **kw)
        if k:
            out, m = out
            moms.append(m)
        outs.append(out)
    top, bottom, left, right = outs
    pieces = (top[..., d:2 * d, 1:1 + wdl], bottom[..., d:2 * d, 1:1 + wdl],
              left[..., d:hl - d, 1:2], right[..., d:hl - d, 1:2])
    if k:
        return pieces, functools.reduce(torch.add, moms)
    return pieces


def compose_split(tile: torch.Tensor, pieces) -> torch.Tensor:
    """Write ``run_extended_boundary``'s valid pieces into the margins of
    the interior half's output ``tile`` ``(..., hl, wdl)``, in place: rows
    ``[0, d)`` and ``[hl - d, hl)``, and words ``0`` and ``wdl - 1`` of
    the rows between.  Returns ``tile``, now the whole stepped shard."""
    top, bottom, left, right = pieces
    d, hl = top.shape[-2], tile.shape[-2]
    tile[..., :d, :] = top
    tile[..., hl - d:, :] = bottom
    tile[..., d:hl - d, :1] = left
    tile[..., d:hl - d, -1:] = right
    return tile


def run_extended_split(ext: torch.Tensor, steps: int, *, t0: int = 0,
                       p_force: float = 0.0, y0: int = 0, xw0: int = 0,
                       hg: int, wdg: int, steps_per_launch: int | None = None,
                       block_rows: int = 0, block_words: int = 0,
                       solid_ext: torch.Tensor | None = None,
                       moments_every: int = 0, moments_offset: int = 0,
                       **kw):
    """``run_extended`` split into an interior launch plus four thin
    boundary launches; bit-identical to ``run_extended`` on its validity
    window.

    ``ext`` is the usual ``(..., He, Wde)`` shard with ``He = hl + 2*steps``
    and ``Wde = wdl + 2``.  The composition of the two halves:
    ``run_extended_interior`` on the bare ``(hl, wdl)`` shard, which does
    not read the exchanged apron, and ``run_extended_boundary`` on its
    four ``boundary_slices`` (two ``3*steps``-row bands at full extended
    width, two 3-word strips), each a ``run_extended`` with shifted
    ``y0``/``xw0`` (and the same slice of ``solid_ext``), whose valid
    pieces ``compose_split`` writes into the interior's output.  Their
    moments, counted over disjoint windows that tile the shard, add up to
    the serial path's.  Degenerate shards (``hl <= 2*steps`` or ``wdl <=
    2``) take ``run_extended`` itself.

    Like the reference's, the result is ``ext``-shaped with the stepped
    shard in its window and a zero apron.  The sharded stepper's
    ``overlap`` round (``core.distributed``) calls the two halves itself:
    the interior on the previous round's tile on a side stream while the
    current stream exchanges only the boundary slices, composing in place
    with no ``ext``-shaped array."""
    d = int(steps)
    he, wde = ext.shape[-2:]
    hl, wdl = he - 2 * d, wde - 2
    kw = dict(kw, t0=t0, p_force=p_force, hg=hg, wdg=wdg,
              steps_per_launch=steps_per_launch, block_rows=block_rows,
              block_words=block_words, moments_every=moments_every,
              moments_offset=moments_offset)
    if hl <= 2 * d or wdl <= 2:
        return run_extended(ext, d, y0=y0, xw0=xw0, solid_ext=solid_ext,
                            **kw)
    win = (..., slice(d, he - d), slice(1, wde - 1))
    tile = run_extended_interior(
        ext[win], d, y0=y0 + d, xw0=xw0 + 1,
        solid=None if solid_ext is None else solid_ext[win], **kw)
    pieces = run_extended_boundary(
        boundary_slices(ext, d), d, y0=y0 + d, xw0=xw0 + 1,
        solid=None if solid_ext is None else boundary_slices(solid_ext, d),
        **kw)
    if moments_every:
        (tile, m), (pieces, mb) = tile, pieces
    out = torch.zeros_like(ext)
    out[win] = compose_split(tile, pieces)
    return (out, m + mb) if moments_every else out
