"""Plain PyTorch version of the fused FHP step kernel.

``fhp_step_ref`` computes exactly what ``ops.fhp_step_cuda`` computes --
``steps_per_launch`` calls of ``core.rulespec.step_planes_rule`` at
``t, t+1, ...`` with the same ``y0``/``xw0`` offsets, the static-solid
layout (``solid=``) and the fused moments (``record_steps``) as
``core.rulespec.compute_moments`` after each recorded step.  It runs on any
device; ``ops`` takes it only for CPU tensors, and the chip smoke run holds
the kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core import rulespec


def fhp_step_ref(planes: torch.Tensor, t: int, *, p_force: float = 0.0,
                 y0: int = 0, xw0: int = 0, variant: str = "fhp2",
                 steps_per_launch: int = 1, solid: torch.Tensor | None = None,
                 record_steps: tuple = ()):
    """``steps_per_launch`` steps of rule ``variant`` on ``(NPS, H, Wd)`` or
    ``(B, NPS, H, Wd)`` int32 planes; with ``solid`` the stack holds the
    dynamic planes only and the ``(H, Wd)`` solid plane is shared by every
    lane.  Returns ``planes``, or ``(planes, moments)`` with ``moments``
    ``(B?, len(record_steps), n_moments)`` int32 when ``record_steps``."""
    spec = rulespec.get_rule(variant)
    nps = planes.shape[-3]
    ms = rulespec.moment_spec(spec, stack_planes=nps)
    s = planes
    if solid is not None:
        sol = solid.expand(planes.shape[:-3] + (1,) + planes.shape[-2:])
        s = torch.cat([planes, sol], dim=-3)
    moms = []
    for k in range(int(steps_per_launch)):
        s = rulespec.step_planes_rule(s, t + k, spec, p_force=p_force,
                                      y0=y0, xw0=xw0)
        if k in record_steps:
            moms.append(rulespec.compute_moments(s[..., :nps, :, :], ms))
    out = s[..., :nps, :, :].contiguous()
    if not record_steps:
        return out
    return out, torch.stack(moms, dim=-2)
