"""Traffic model of the FHP hot path: the bytes each site update moves
through device memory and over the links between devices, priced in
seconds on a card's datasheet rates.

The FHP half of ``repro/roofline/analysis.py``, with the same byte terms
for the same arguments.  The reference prices a TPU; here the default
:class:`HW` is the NVIDIA H100 SXM5 80GB at its 700 W power limit,
from NVIDIA's datasheet.  The serve engine seeds its round-time model
with :func:`sharded_fhp_traffic` (``CAServeEngine._modeled_round_s``).

``sharded_fhp_traffic`` prices one shard of ``(hl, wdl)`` words advanced
``depth`` local steps per halo-exchange round, executed as ceil(d/T)
fused launches of T in-kernel steps on the (hl + 2d)-row extended array.
It prices three costs the (tile, T, depth) choice trades:

  memory   -- the extended stack crosses device memory once per launch
              plus the 2T/bh halo-band re-reads of the overlapping tiles;
  link     -- halo bytes per exchange, amortised over d steps;
  latency  -- a fixed per-exchange term (exchange round trip + launch
              overheads), amortised over d steps -- the paper's "two
              barriers per step" cost, and the reason exchange *count*
              matters independently of exchange *bytes*.

Redundant apron compute is priced in memory-row-equivalents via
``compute_row_weight`` (the kernel streams its tile, so apron rows are
cheap but not free).  All numbers are per *useful* site update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HW:
    """A card's peak rates.  ``ici_bw`` is the link bandwidth between two
    devices, each way (the reference's name for it, kept so the two
    models take the same arguments)."""
    peak_flops: float      # dense bf16 FLOP/s
    hbm_bw: float          # device memory bytes/s
    ici_bw: float          # bytes/s each way to another device


# NVIDIA H100 SXM5 80GB, 700 W (NVIDIA's datasheet): 989 TFLOP/s dense
# bf16, 3.35 TB/s HBM3, NVLink 900 GB/s to the other cards of the host,
# 450 GB/s each way.
H100 = HW(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)

PLANE_BYTES = 8 * 4            # 8 uint32 bit-planes per word of 32 nodes
DYN_PLANE_BYTES = 7 * 4        # the 7 dynamic planes (static-solid mode)
WORD_NODES = 32
EXCHANGE_LATENCY_S = 3e-6      # fallback cost per halo-exchange round


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_ge(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def sharded_fhp_traffic(hl: int, wdl: int, *, depth: int, T: int,
                        block_rows: int, block_words: int = 0,
                        compute_row_weight: float = 0.2,
                        exchange_latency_s: float = EXCHANGE_LATENCY_S,
                        hw: HW = H100,
                        static_solid: bool = False,
                        n_planes: int = 8,
                        overlap: bool = False) -> Dict[str, float]:
    """Modeled per-site-step costs of the sharded hot path.

    Returns a dict with ``hbm_bytes_per_site_step`` (device memory),
    ``ici_bytes_per_site_step`` (link),
    ``exchanges_per_step``, ``launches_per_step``, and the roofline-style
    time decomposition ``{hbm,compute,ici,latency,total}_s_per_site``.

    ``block_words`` (0 / >= width = the legacy full-width 1-D band)
    prices the 2-D (x x y) blocked kernel grid: each tile re-reads a
    T-word x apron per side per launch and the redundant-compute extents
    shrink in both axes -- the x-apron redundancy term the joint
    ``(block_rows, block_words, T, depth)`` choice trades against the
    shared-memory ceiling.  The extended width ``wdl + 2`` is word-padded to a
    block multiple, exactly like the row padding.

    ``static_solid`` prices the static-geometry cache: the solid plane is
    exchanged once per geometry (its one-time cost is reported as
    ``geometry_exchange_bytes``, excluded from the per-step totals) and
    every round moves the 7 *dynamic* planes over the link -- a 7/8 cut of the
    plane term -- while each launch writes 7 planes back to memory instead
    of 8 (reads stay at 8: the kernel still consumes the solid band).

    ``n_planes`` is the rule's plane count (``core.rulespec``): bytes
    per word-cell scale linearly with it, so e.g. 2-plane BML moves a
    quarter of FHP's memory and exchange bytes per site-step.  The default
    8 reproduces the historic FHP numbers exactly.

    ``overlap`` prices the compute/communication-overlapped schedule
    (``ops.run_extended_split``): each round issues the halo exchange
    concurrently with an *interior* launch set on the bare
    ``(hl, wdl)`` shard (whose depth-d light cone never touches the
    apron), then a thin *boundary* launch set -- two ``3d``-row bands and
    two 3-word column strips -- once halos land, so

        ``total = max(t_exchange, t_interior) + t_boundary``

    instead of the serial sum.  The split is priced honestly: interior +
    boundary launches together read slightly more memory than one full
    extended launch (each boundary slice pays its own T-row/T-word
    apron), so the overlap win is ``min(t_exchange, t_interior)`` minus
    that split overhead, and exactly the quantity
    ``overlap_speedup_modeled`` reports against the serial model.  The
    reported plan is the *better* of split and serial: when the boundary
    band covers the whole shard (``hl <= 2*depth`` or ``wdl <= 2``, the
    stepper's runtime fallback) or when the split overhead exceeds the
    hidden exchange time (tiny shards, where a tuner keeps the serial
    plan), the model reports the serial schedule --
    ``t_interior_s_per_site`` is 0 and the modeled speedup exactly 1.
    Hence overlap models *strictly* lower cost than serial whenever the
    reported ``t_interior_s_per_site`` is positive.
    """
    if not (1 <= T <= block_rows and 1 <= depth):
        raise ValueError(f"need 1 <= T <= block_rows and depth >= 1: "
                         f"T={T}, block_rows={block_rows}, depth={depth}")
    plane_bytes = 4 * n_planes
    dyn_plane_bytes = 4 * (n_planes - 1)
    we = wdl + 2                               # extended width in words
    bw = min(block_words, we) if block_words else we
    x_blocked = bw < we
    if x_blocked and T > bw:
        raise ValueError(f"T={T} exceeds the tile's {bw} words")
    he = hl + 2 * depth
    # Launch schedule: full T-step launches plus one rem-step tail launch.
    ts = [T] * (depth // T) + ([depth % T] if depth % T else [])
    sites = float(hl * wdl * WORD_NODES)       # useful sites per shard step
    write_pb = dyn_plane_bytes if static_solid else plane_bytes
    xchg_pb = dyn_plane_bytes if static_solid else plane_bytes

    def component(he_c, we_c, bh_c, bw_c):
        """(memory bytes, weighted-compute bytes) per round of one launch
        set covering a (he_c, we_c) sub-array with (bh_c, bw_c) tiles:
        per launch every tile reads (bh + 2*Tj) x (bw + 2*Tj_x) cells
        (all planes -- the solid band rides in either layout) and the
        padded array is written back once (7 or 8 planes); step s of a
        Tj-launch updates the shrinking apron extents of (cheap,
        weighted) redundant compute."""
        bw_c = min(bw_c, we_c)
        xb = bw_c < we_c
        he_cp = _ceil_to(he_c, bh_c)
        we_cp = _ceil_to(we_c, bw_c)
        nb_c, nbx_c = he_cp // bh_c, we_cp // bw_c
        hbm = sum(plane_bytes * nb_c * nbx_c * (bh_c + 2 * tj)
                  * (bw_c + (2 * tj if xb else 0))
                  + write_pb * he_cp * we_cp
                  for tj in ts)
        comp = compute_row_weight * plane_bytes * sum(
            nb_c * nbx_c * (bh_c + 2 * (tj - s - 1))
            * (bw_c + (2 * (tj - s - 1) if xb else 0))
            for tj in ts for s in range(tj))
        return hbm, comp

    # Serial launch set: the full extended array (legacy accounting).
    hbm_raw, comp_raw = component(he, we, block_rows, bw)
    hbm_b = hbm_raw / (sites * depth)
    comp_b = comp_raw / (sites * depth)
    we_p = _ceil_to(we, bw)
    nbx = we_p // bw

    # Link: per exchange each shard sends depth rows up + depth rows down of
    # the x-extended width, plus one word column each side for the x halo;
    # static geometry drops the solid plane from every round.
    halo_words = 2 * depth * (wdl + 2) + 2 * hl
    ici_exchange_b = xchg_pb * halo_words
    ici_b = ici_exchange_b / (sites * depth)

    lat_s = exchange_latency_s / (sites * depth)
    hbm_s = hbm_b / hw.hbm_bw
    comp_s = comp_b / hw.hbm_bw
    ici_s = ici_b / hw.ici_bw
    out = {
        "block_words": float(bw),
        "x_blocks": float(nbx),
        "hbm_bytes_per_site_step": hbm_b,
        "compute_row_equiv_bytes_per_site_step": comp_b,
        "ici_bytes_per_site_step": ici_b,
        "ici_bytes_per_exchange": float(ici_exchange_b),
        # one-time solid-apron exchange (amortises to ~0 over a run)
        "geometry_exchange_bytes": float(4 * halo_words) if static_solid
                                   else 0.0,
        "static_solid": float(static_solid),
        "exchanges_per_step": 1.0 / depth,
        "launches_per_step": len(ts) / depth,
        "hbm_s_per_site": hbm_s,
        "compute_s_per_site": comp_s,
        "ici_s_per_site": ici_s,
        "latency_s_per_site": lat_s,
        "total_s_per_site": hbm_s + comp_s + ici_s + lat_s,
    }
    if not overlap:
        return out

    serial_s = out["total_s_per_site"]
    exchange_s = ici_s + lat_s
    interior_ok = hl > 2 * depth and wdl > 2

    def as_serial():
        # The overlap plan degenerates to the serial schedule: either the
        # boundary band covers the whole shard (the stepper's runtime
        # fallback) or the split's apron overhead exceeds the hidden
        # exchange time, in which case a tuner keeps the serial plan
        # (ties break serial).  Either way the reported plan *is* serial:
        # no interior time, modeled speedup exactly 1.
        out.update({
            "overlap": 0.0,
            "t_exchange_s_per_site": exchange_s,
            "t_interior_s_per_site": 0.0,
            "t_boundary_s_per_site": hbm_s + comp_s,
            "serial_s_per_site": serial_s,
            "overlap_speedup_modeled": 1.0,
        })
        return out

    if not interior_ok:
        return as_serial()

    # Interior: the bare (hl, wdl) shard (no apron dependence); boundary:
    # two 3d-row bands at full extended width plus two 3-word column
    # strips over the interior rows -- the exact launch restriction of
    # ``ops.run_extended_split``, each slice's tile capped to its extent.
    bh_i = min(block_rows, _pow2_ge(hl))
    hbm_i, comp_i = component(hl, wdl, bh_i, bw)
    bh_tb = min(block_rows, _pow2_ge(3 * depth))
    hbm_tb, comp_tb = component(3 * depth, we, bh_tb, bw)
    hbm_lr, comp_lr = component(hl, 3, bh_i, 3)      # strips: full width
    hbm_bnd = 2 * (hbm_tb + hbm_lr)
    comp_bnd = 2 * (comp_tb + comp_lr)

    interior_s = (hbm_i + comp_i) / (sites * depth) / hw.hbm_bw
    boundary_s = (hbm_bnd + comp_bnd) / (sites * depth) / hw.hbm_bw
    total_s = max(exchange_s, interior_s) + boundary_s
    if total_s >= serial_s:
        return as_serial()
    out.update({
        "overlap": 1.0,
        "hbm_bytes_per_site_step": (hbm_i + hbm_bnd) / (sites * depth),
        "compute_row_equiv_bytes_per_site_step":
            (comp_i + comp_bnd) / (sites * depth),
        "hbm_s_per_site": (hbm_i + hbm_bnd) / (sites * depth) / hw.hbm_bw,
        "compute_s_per_site":
            (comp_i + comp_bnd) / (sites * depth) / hw.hbm_bw,
        "launches_per_step": 5 * len(ts) / depth,
        "t_exchange_s_per_site": exchange_s,
        "t_interior_s_per_site": interior_s,
        "t_boundary_s_per_site": boundary_s,
        "serial_s_per_site": serial_s,
        "total_s_per_site": total_s,
        "overlap_speedup_modeled": serial_s / total_s,
    })
    return out
