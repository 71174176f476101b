"""Bit-exact parity sweep of the CUDA kernel against its plain version.

Each case runs ``ops.run_cuda`` (the kernel on a CUDA tensor) and the same
steps through ``ref.fhp_step_ref``, one step per call, on the same device,
over three tiles -- ``pick_tile``'s, a full-width row band, and a (24, 13)
tile that divides neither axis -- with odd ``y0``, nonzero ``xw0`` and
``t0``, ``2T + 1`` steps (so one remainder launch) and a moments cadence
from {1, 3, T}.  FHP cases also run the static-solid layout and hold it
against the 8-plane run.  Used by ``chip_smoke.py`` and
``tests/test_torch_gpu.py``.
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


def first_difference(a: torch.Tensor, b: torch.Tensor
                     ) -> Optional[Tuple[int, ...]]:
    """Index of the first differing element, or None when equal."""
    if a.shape != b.shape:
        return tuple(a.shape)
    diff = (a != b).nonzero()
    return None if diff.numel() == 0 else tuple(diff[0].tolist())


def _run_plain(planes, steps, k, **kw):
    """``steps`` plain steps from ``T0``, one at a time, with the moments
    after every ``k``-th: independent of ``ops``' launch schedule."""
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
    """Run one case over the three tiles; returns one line per mismatch
    (first differing index), empty when every comparison is bit-exact."""
    spec = rulespec.get_rule(case.variant)
    T = case.steps_per_launch
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, size=(case.lanes, spec.n_planes, h, wd),
                         dtype=np.uint64).astype(np.uint32)
    planes = carry.planes_from_reference(words, device)
    kw = dict(p_force=case.p_force, y0=Y0, xw0=XW0, variant=case.variant)
    steps = 2 * T + 1
    bad = []
    tiles = ((0, 0), (T, wd), (24, 13))
    for tile, k in zip(tiles, (1, 3, T)):
        tag = f"{case} tile={tile} moments_every={k}"
        got, gm = ops.run_cuda(planes, steps, t0=T0, steps_per_launch=T,
                               moments_every=k, block_rows=tile[0],
                               block_words=tile[1], **kw)
        want, wm = _run_plain(planes, steps, k, **kw)
        for name, a, b in (("planes", got, want), ("moments", gm, wm)):
            where = first_difference(a, b)
            if where is not None:
                bad.append(f"{tag}: {name} differ first at {where}")
        if spec.solid_plane is None:
            continue
        sp = spec.solid_plane
        solid = planes[0, sp].contiguous()
        # Every lane shares the solid operand, so give the 8-plane run the
        # same solid plane in every lane before comparing.
        full = planes.clone()
        full[:, sp] = solid
        ref8, m8 = ops.run_cuda(full, steps, t0=T0, steps_per_launch=T,
                                moments_every=k, block_rows=tile[0],
                                block_words=tile[1], **kw)
        dyn, dm = ops.run_cuda(full[:, :sp].contiguous(), steps, t0=T0,
                               steps_per_launch=T, moments_every=k,
                               block_rows=tile[0], block_words=tile[1],
                               solid=solid, **kw)
        keep = [r for r, n in enumerate(rulespec.moment_spec(spec).names)
                if n != "solid"]
        for name, a, b in (("static planes", dyn, ref8[:, :sp]),
                           ("static moments", dm, m8[..., keep])):
            where = first_difference(a, b)
            if where is not None:
                bad.append(f"{tag}: {name} differ first at {where}")
    return bad
