"""Bit-exact parity sweeps of the CUDA kernel against its plain version.

``run_case`` runs ``ops.run_cuda`` (the kernel on a CUDA tensor) and the
same steps through ``ref.fhp_step_ref``, one step per call, on the same
device, over four ``(block_rows, block_words)`` -- the defaults, a
full-width row band, (24, 13), which divides neither axis, and 40 rows
64 - 2T words wide -- with odd ``y0``, nonzero ``xw0`` and ``t0``, ``2T +
1`` steps (so one remainder launch) and a moments cadence from {1, 3, T,
2}.  These periodic launches run on the row-streaming kernel, where the
pair names the rows a block owns and the widest strip's words.  FHP cases
also run the static-solid layout (tiles: the pair is the tile) and hold
it against the 8-plane run.

``run_extended_case`` does the same for the extended-shard mode through
``ops.run_extended``, with a negative ``y0`` (-T), ``xw0`` = -1 and global
extents larger than the array, and compares the validity window and the
moments only.  ``run_k2_case`` holds one step with precomputed random
words (``rng_in_kernel=False``) against the plain step that hashes them.

Used by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import itertools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import carry, rulespec
from repro_torch.kernels.fhp_step import ops
from repro_torch.kernels.fhp_step.ref import fhp_step_ref

Y0, XW0, T0 = 7, 5, 11


class Case(NamedTuple):
    variant: str
    steps_per_launch: int
    lanes: int
    p_force: float


CASES: Tuple[Case, ...] = tuple(
    Case(v, T, B, pf)
    for v, T, B, pf in itertools.product(("fhp2", "fhp3", "bml"),
                                         (1, 2, 4, 8), (1, 3), (0.0, 0.05))
    if not (v == "bml" and pf))


# T = 1 cases that draw a random plane: bml at p_force 0 draws none, so
# ``rng_in_kernel=False`` runs the periodic kernel there.
K2_CASES: Tuple[Case, ...] = tuple(
    c for c in CASES if c.steps_per_launch == 1
    and (rulespec.get_rule(c.variant).needs_rng or c.p_force))


def _tiles(T: int, wd: int):
    """The defaults (0, 0), a full-width band of T rows, a tile that
    divides neither axis, and a tile whose row with its apron fills two
    warps (64 words)."""
    return ((0, 0), (T, wd), (24, 13), (40, 64 - 2 * T))


def _random_planes(case: Case, h: int, wd: int, seed: int, device
                   ) -> torch.Tensor:
    n = rulespec.get_rule(case.variant).n_planes
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, size=(case.lanes, n, h, wd),
                         dtype=np.uint64).astype(np.uint32)
    return carry.planes_from_reference(words, device)


def _same_solid(planes: torch.Tensor, sp: int) -> torch.Tensor:
    """``planes`` with lane 0's solid plane in every lane: the static-solid
    operand is shared by all lanes."""
    full = planes.clone()
    full[:, sp] = planes[0, sp]
    return full


def _compare(bad: List[str], tag: str, pairs) -> None:
    for name, a, b in pairs:
        where = first_difference(a, b)
        if where is not None:
            bad.append(f"{tag}: {name} differ first at {where}")


def first_difference(a: torch.Tensor, b: torch.Tensor
                     ) -> Optional[Tuple[int, ...]]:
    """Index of the first differing element, or None when equal."""
    if a.shape != b.shape:
        return tuple(a.shape)
    diff = (a != b).nonzero()
    return None if diff.numel() == 0 else tuple(diff[0].tolist())


def _run_plain(planes, steps, k, **kw):
    """``steps`` plain steps from ``T0``, one at a time, with the moments
    after every ``k``-th: independent of ``ops``' launch schedule.  ``kw``
    goes to ``fhp_step_ref``."""
    out, moms = planes, []
    for i in range(steps):
        if (i + 1) % k:
            out = fhp_step_ref(out, T0 + i, **kw)
        else:
            out, m = fhp_step_ref(out, T0 + i, record_steps=(0,), **kw)
            moms.append(m)
    return out, torch.cat(moms, dim=-2)


def run_case(case: Case, device, h: int, wd: int, seed: int = 0
             ) -> List[str]:
    """Run one case over the four tiles; returns one line per mismatch
    (first differing index), empty when every comparison is bit-exact."""
    spec = rulespec.get_rule(case.variant)
    T = case.steps_per_launch
    planes = _random_planes(case, h, wd, seed, device)
    kw = dict(p_force=case.p_force, y0=Y0, xw0=XW0, variant=case.variant)
    steps = 2 * T + 1
    bad = []
    for (bh, bw), k in zip(_tiles(T, wd), (1, 3, T, 2)):
        tag = f"{case} tile={(bh, bw)} moments_every={k}"
        run = dict(t0=T0, steps_per_launch=T, moments_every=k,
                   block_rows=bh, block_words=bw, **kw)
        got, gm = ops.run_cuda(planes, steps, **run)
        want, wm = _run_plain(planes, steps, k, **kw)
        _compare(bad, tag, (("planes", got, want), ("moments", gm, wm)))
        if spec.solid_plane is None:
            continue
        sp = spec.solid_plane
        full = _same_solid(planes, sp)
        ref8, m8 = ops.run_cuda(full, steps, **run)
        dyn, dm = ops.run_cuda(full[:, :sp].contiguous(), steps,
                               solid=full[0, sp].contiguous(), **run)
        keep = [r for r, n in enumerate(rulespec.moment_spec(spec).names)
                if n != "solid"]
        _compare(bad, tag, (("static planes", dyn, ref8[:, :sp]),
                            ("static moments", dm, m8[..., keep])))
    return bad


def run_extended_case(case: Case, device, h: int, wd: int, seed: int = 0
                      ) -> List[str]:
    """``run_case`` for the extended-shard mode: ``ops.run_extended`` on a
    ``(B, P, h, wd)`` extended array against one extended plain step per
    call, compared on the validity window, with the moments over it."""
    spec = rulespec.get_rule(case.variant)
    T = case.steps_per_launch
    planes = _random_planes(case, h, wd, seed, device)
    steps = 2 * T + 1                    # <= 17: inside the one-word x halo
    win = (slice(steps, h - steps), slice(1, wd - 1))
    glob = dict(y0=-T, xw0=-1, hg=2 * h + 2, wdg=wd + 7)
    kw = dict(p_force=case.p_force, variant=case.variant, **glob)
    bad = []
    for (bh, bw), k in zip(_tiles(T, wd), (1, 3, T, 2)):
        tag = f"extended {case} tile={(bh, bw)} moments_every={k}"
        run = dict(t0=T0, steps_per_launch=T, moments_every=k,
                   block_rows=bh, block_words=bw, **kw)
        got, gm = ops.run_extended(planes, steps, **run)
        want, wm = _run_plain(planes, steps, k, extended=True,
                              moment_bounds=(steps, h - steps, 1, wd - 1),
                              **kw)
        _compare(bad, tag, (("planes", got[..., win[0], win[1]],
                             want[..., win[0], win[1]]),
                            ("moments", gm, wm)))
        if spec.solid_plane is None:
            continue
        sp = spec.solid_plane
        full = _same_solid(planes, sp)
        ref8, m8 = ops.run_extended(full, steps, **run)
        dyn, dm = ops.run_extended(full[:, :sp].contiguous(), steps,
                                   solid_ext=full[0, sp].contiguous(), **run)
        keep = [r for r, n in enumerate(rulespec.moment_spec(spec).names)
                if n != "solid"]
        _compare(bad, tag, (("static planes", dyn[..., win[0], win[1]],
                             ref8[:, :sp, win[0], win[1]]),
                            ("static moments", dm, m8[..., keep])))
    return bad


def run_k2_case(case: Case, device, h: int, wd: int, seed: int = 0
                ) -> List[str]:
    """One step with precomputed random words (kernel mode K2) over the
    four tiles, with moments, against the plain step that hashes them."""
    planes = _random_planes(case, h, wd, seed, device)
    kw = dict(p_force=case.p_force, y0=Y0, xw0=XW0, variant=case.variant,
              record_steps=(0,))
    bad = []
    for bh, bw in _tiles(1, wd):
        got, gm = ops.fhp_step_cuda(planes, T0, rng_in_kernel=False,
                                    block_rows=bh, block_words=bw, **kw)
        want, wm = fhp_step_ref(planes, T0, **kw)
        _compare(bad, f"K2 {case} tile={(bh, bw)}",
                 (("planes", got, want), ("moments", gm, wm)))
    return bad
