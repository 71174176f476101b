"""Plain PyTorch version of the fused FHP step kernel.

``fhp_step_ref`` computes exactly what ``ops.fhp_step_cuda`` computes --
``steps_per_launch`` calls of ``core.rulespec.step_planes_rule`` at
``t, t+1, ...`` with the same ``y0``/``xw0`` offsets, the static-solid
layout (``solid=``) and the fused moments (``record_steps``) as
``core.rulespec.compute_moments`` after each recorded step -- in each of
the kernel's modes: periodic, extended shard (``extended=True``) and
precomputed random words (``chi=``/``accel=``).  It runs on any device;
``ops`` takes it only for CPU tensors, and the chip smoke run holds the
kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng, rulespec


def fhp_step_ref(planes: torch.Tensor, t: int, *, p_force: float = 0.0,
                 y0: int = 0, xw0: int = 0, variant: str = "fhp2",
                 steps_per_launch: int = 1, solid: torch.Tensor | None = None,
                 record_steps: tuple = (), extended: bool = False,
                 hg: int | None = None, wdg: int | None = None,
                 moment_bounds: tuple | None = None,
                 chi: torch.Tensor | None = None,
                 accel: torch.Tensor | None = None):
    """``steps_per_launch`` steps of rule ``variant`` on ``(NPS, H, Wd)`` or
    ``(B, NPS, H, Wd)`` int32 planes; with ``solid`` the stack holds the
    dynamic planes only and the ``(H, Wd)`` solid plane is shared by every
    lane.  Returns ``planes``, or ``(planes, moments)`` with ``moments``
    ``(B?, len(record_steps), n_moments)`` int32 when ``record_steps``.

    ``extended`` steps a halo-extended shard as the reference's jnp
    fallback does (``repro/core/distributed.py:266-279``): the random
    words of array row r, word c are drawn at global row ``(y0 + r) mod
    hg`` and word ``(xw0 + c) mod wdg``, and the row parity is that of the
    unreduced ``y0 + r`` (``hg`` is even).  The array still rolls at its
    edges, so only the caller's validity window is specified.
    ``moment_bounds = (r0, r1, c0, c1)`` counts the moments over array rows
    ``[r0, r1)`` x words ``[c0, c1)`` only.  ``chi``/``accel`` are the
    ``(H, Wd)`` chirality and force words of a one-step launch with
    precomputed RNG (kernel mode K2)."""
    spec = rulespec.get_rule(variant)
    nps = planes.shape[-3]
    h, wd = planes.shape[-2:]
    ms = rulespec.moment_spec(spec, stack_planes=nps)
    r0, r1, c0, c1 = moment_bounds or (0, h, 0, wd)
    s = planes
    if solid is not None:
        sol = solid.expand(planes.shape[:-3] + (1,) + planes.shape[-2:])
        s = torch.cat([planes, sol], dim=-3)
    if extended:
        dev = planes.device
        rows = torch.remainder(torch.arange(h, dtype=torch.int64,
                                            device=dev) + int(y0), hg)
        cols = torch.remainder(torch.arange(wd, dtype=torch.int64,
                                            device=dev) + int(xw0), wdg)
        rows, cols = rows[:, None], cols[None, :]
    moms = []
    for k in range(int(steps_per_launch)):
        tt = t + k
        if extended:
            chi = (prng.word_u32_at(rows, cols, tt, salt=0x11)
                   if spec.needs_rng else None)
            accel = (prng.bernoulli_words_at(rows, cols, tt, p_force)
                     if p_force > 0 else None)
        s = rulespec.step_planes_rule(s, tt, spec, p_force=p_force, y0=y0,
                                      xw0=xw0, chi=chi, accel=accel)
        if k in record_steps:
            moms.append(rulespec.compute_moments(
                s[..., :nps, r0:r1, c0:c1], ms))
    out = s[..., :nps, :, :].contiguous()
    if not record_steps:
        return out
    return out, torch.stack(moms, dim=-2)
