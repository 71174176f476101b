"""Host wrappers of the fused, temporally blocked FHP step kernel
(periodic mode).

``fhp_step_cuda`` has the keyword signature of the reference's
``repro.kernels.fhp_step.ops.fhp_step_pallas``: ``steps_per_launch`` = T
fused stream -> collide (-> force) steps in one launch on ``(NPS, H, Wd)``
or batched ``(B, NPS, H, Wd)`` int32 planes (lanes share the RNG stream),
``block_rows``/``block_words`` as the CUDA tile, ``solid=`` for the
static-geometry layout and ``record_steps`` for fused moments.
``run_cuda`` advances many steps like ``run_pallas``: ``steps // T`` full
launches plus one remainder launch, with the moments schedule unrolled.

Dispatch is by the tensor's device: a CUDA tensor launches the kernel
(``csrc/fhp_step.cu``, built at first use) or raises; a CPU tensor takes
the plain version (``ref.fhp_step_ref``); any other device raises.

The CUDA tile need not divide the lattice (edge tiles mask their stores
and moments), so the reference's ``block_words | Wd`` rule is dropped; its
other argument checks are kept.  Extended-shard mode (K5) and precomputed
RNG planes (K2) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import prng, rulespec
from repro_torch.kernels.fhp_step import build, codegen
from repro_torch.kernels.fhp_step.ref import fhp_step_ref

# Kernel launches since the count was last set to 0 (read by chip_smoke).
LAUNCHES = 0

SMEM_BYTES_PER_BLOCK = 232_448    # H100: 227 KB of shared memory per block
MAX_TILE = 32
_GRID_YZ_LIMIT = 65_535
_RULE_ID = {name: i for i, name in enumerate(codegen.RULES)}


def smem_bytes(bh: int, bw: int, steps: int = 1, static_solid: bool = False,
               n_planes: int = 8) -> int:
    """Dynamic shared memory of one block: two ping-pong buffers of the
    ``(bh + 2T) x (bw + 2T)`` tile for every stack plane, plus the solid
    plane's tile in static-solid mode."""
    nps = n_planes - 1 if static_solid else n_planes
    rw = (bh + 2 * steps) * (bw + 2 * steps)
    return 4 * (2 * nps * rw + (rw if static_solid else 0))


def _tile_ok(bh: int, bw: int, h: int, wd: int, steps: int,
             static_solid: bool, n_planes: int) -> bool:
    return (steps <= bh and (bw >= wd or steps <= bw)
            and smem_bytes(bh, bw, steps, static_solid, n_planes)
            <= SMEM_BYTES_PER_BLOCK)


def pick_tile(h: int, wd: int, steps: int = 1, static_solid: bool = False,
              n_planes: int = 8) -> Tuple[int, int]:
    """``(block_rows, block_words)``: the largest square power-of-two tile
    up to 32 x 32 words, clipped to the lattice, that admits the
    ``steps``-row / ``steps``-word apron and fits the H100's shared memory."""
    t = MAX_TILE
    while t >= 1:
        bh, bw = min(t, h), min(t, wd)
        if _tile_ok(bh, bw, h, wd, steps, static_solid, n_planes):
            return bh, bw
        t //= 2
    raise ValueError(f"no valid tile for H={h}, Wd={wd}, "
                     f"steps_per_launch={steps}")


def fhp_step_cuda(planes: torch.Tensor, t: int, *, p_force: float = 0.0,
                  y0: int = 0, xw0: int = 0, block_rows: int = 0,
                  block_words: int = 0, rng_in_kernel: bool = True,
                  variant: str = "fhp2", steps_per_launch: int = 1,
                  extended: bool = False, hg: int | None = None,
                  wdg: int | None = None, donate: bool = False,
                  solid: torch.Tensor | None = None,
                  record_steps: tuple = (),
                  moment_bounds: tuple | None = None):
    """``steps_per_launch`` fused steps of rule ``variant`` in one launch.

    ``y0``/``xw0`` are the global coordinates of word (0, 0) (RNG counters
    and row parity).  ``solid`` switches on static-geometry mode:
    ``planes`` then carries the dynamic planes only and the ``(H, Wd)``
    solid plane is a read-only operand shared by all lanes.
    ``record_steps`` (in-launch step indices) returns ``(planes, moments)``
    with ``moments`` ``(B?, len(record_steps), n_moments)`` int32, the
    rule's ``MomentSpec`` after each recorded step."""
    global LAUNCHES
    spec = rulespec.get_rule(variant)
    if not rng_in_kernel:
        raise NotImplementedError(
            "rng_in_kernel=False (precomputed RNG planes, kernel mode K2) is "
            "not ported yet: see ROADMAP.md, 'TPU kernels to port', K2")
    if extended or hg is not None or wdg is not None \
            or moment_bounds is not None:
        raise NotImplementedError(
            "extended-shard mode (kernel mode K5: hg/wdg/moment_bounds) is "
            "not ported yet: see ROADMAP.md, 'Modules to port', item 5")
    if donate:
        raise ValueError("donate=True needs extended mode (periodic band "
                         "maps re-read written bands)")
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
    if block_rows and block_words:
        bh, bw = int(block_rows), int(block_words)
    else:
        auto = pick_tile(h, wd, T, static_solid, spec.n_planes)
        bh, bw = int(block_rows) or auto[0], int(block_words) or auto[1]
    if T > bh:
        raise ValueError(f"steps_per_launch={T} > block_rows={bh}")
    if bw < wd and T > bw:
        raise ValueError(f"steps_per_launch={T} > block_words={bw}")
    need = smem_bytes(bh, bw, T, static_solid, spec.n_planes)
    if need > SMEM_BYTES_PER_BLOCK:
        raise ValueError(f"tile ({bh}, {bw}) at T={T} needs {need} B of "
                         f"shared memory > {SMEM_BYTES_PER_BLOCK}")
    rs = tuple(sorted(set(int(s) for s in record_steps)))
    if any(not 0 <= s < T for s in rs):
        raise ValueError(f"record_steps {rs} outside [0, {T})")
    if rs:
        ms = rulespec.moment_spec(spec, stack_planes=np_)
        rulespec.require_moment_headroom(ms, h * wd * 32)

    if planes.device.type == "cpu":
        out = fhp_step_ref(planes, t, p_force=p_force, y0=y0, xw0=xw0,
                           variant=variant, steps_per_launch=T, solid=solid,
                           record_steps=rs)
    elif planes.device.type == "cuda":
        out = _launch(planes, solid, _RULE_ID[variant], t, y0, xw0, bh, bw,
                      T, prng.quantize_p(p_force), rs,
                      ms.n_moments if rs else 0)
        LAUNCHES += 1
    else:
        raise ValueError(f"fhp_step_cuda runs on CUDA tensors (and its plain "
                         f"version on CPU tensors), not {planes.device}")
    if rs:
        p, m = out
        return (p[0], m[0]) if squeeze else (p, m)
    return out[0] if squeeze else out


def _launch(planes, solid, rule_id, t, y0, xw0, bh, bw, T, pq, rs,
            n_moments):
    """One kernel launch on CUDA tensors; raises if it is refused."""
    b, _, h, wd = planes.shape
    if -(-h // bh) > _GRID_YZ_LIMIT or b > _GRID_YZ_LIMIT:
        raise ValueError(f"grid ({-(-h // bh)} row tiles, {b} lanes) "
                         f"exceeds {_GRID_YZ_LIMIT}")
    x = planes.contiguous()
    out = torch.empty_like(x)
    sol = None
    if solid is not None:
        if solid.device != x.device or solid.dtype != torch.int32:
            raise ValueError(f"solid must be int32 on {x.device}")
        sol = solid.contiguous()
    mom = (torch.zeros((b, len(rs), n_moments), dtype=torch.int32,
                       device=x.device) if rs else None)
    mask = sum(1 << s for s in rs)
    lib = build.library()
    with torch.cuda.device(x.device):
        err = lib.fhp_step_launch(
            x.data_ptr(), out.data_ptr(),
            None if sol is None else sol.data_ptr(),
            None if mom is None else mom.data_ptr(),
            rule_id, b, h, wd, bh, bw, T, int(t) & 0xFFFFFFFF,
            int(y0) & 0xFFFFFFFF, int(xw0) & 0xFFFFFFFF, pq, mask,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fhp_step kernel launch failed: CUDA error {err}")
    return (out, mom) if rs else out


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
        return out, torch.cat(moms, dim=-2)
    spec = rulespec.get_rule(kw.get("variant", "fhp2"))
    ms = rulespec.moment_spec(spec, stack_planes=planes.shape[-3])
    return out, torch.zeros(planes.shape[:-3] + (0, ms.n_moments),
                            dtype=torch.int32, device=planes.device)
