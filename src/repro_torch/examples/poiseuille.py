"""Physics validation: body-forced channel flow develops the parabolic
Poiseuille profile (the standard FHP check), built from the scenario
registry.

Runs a 64 x 512 channel with weak forcing for a few thousand steps,
averages the per-row x-velocity over the last quarter of the run (one
sample every 50 steps) and fits u(y) = a*(y - y0)^2 + c.  The steps go
through the ensemble entry point (``make_ensemble_run(None, ...)``): on
the card the fused step kernel, with ``--device cpu`` its plain version.

    PYTHONPATH=src python -m repro_torch.examples.poiseuille [--steps 3000]
    PYTHONPATH=src python -m repro_torch.examples.poiseuille --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import bitplane, distributed

CHUNK = 50
STEPS_PER_LAUNCH = 8


def simulate(sc, steps: int, device="cuda", plain: bool = False):
    """``(planes after the warm phase, final planes, profile)`` of
    scenario ``sc`` over ``steps`` steps: ``3/4`` of them warm, then
    ``CHUNK``-step chunks whose ``row_velocity`` is averaged (float32,
    on the host).  ``plain`` steps with ``bitplane.run_planes`` instead of
    the entry point."""
    planes = sc.initial_planes(device=device)[None]   # one ensemble lane
    warm = steps * 3 // 4
    n_chunks = max((steps - warm) // CHUNK, 1)

    def stepper(n):
        if plain:
            return lambda p, t0: bitplane.run_planes(p, n, sc.p_force, t0)
        run, _ = distributed.make_ensemble_run(
            None, n, variant="fhp2", p_force=sc.p_force,
            steps_per_launch=STEPS_PER_LAUNCH)
        return run

    planes = stepper(warm)(planes, 0)
    warm_planes = planes
    advance = stepper(CHUNK)
    acc = torch.zeros(sc.height, dtype=torch.float32, device=device)
    t = warm
    for _ in range(n_chunks):
        planes = advance(planes, t)
        t += CHUNK
        acc = acc + bitplane.row_velocity(planes)[0]
    return warm_planes[0], planes[0], (acc / n_chunks).cpu().numpy()


def fit(prof: np.ndarray):
    """``(R^2, coefficients)`` of a parabola fitted over the fluid rows."""
    ys = np.arange(1, len(prof) - 1, dtype=np.float64)
    u = prof[1:-1].astype(np.float64)
    coef = np.polyfit(ys, u, 2)
    res = u - np.polyval(coef, ys)
    ss_tot = float(np.sum((u - u.mean()) ** 2))
    return 1.0 - float(np.sum(res ** 2)) / max(ss_tot, 1e-12), coef


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--p-force", type=float, default=0.02)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = scenarios.get("poiseuille", height=args.height, width=args.width,
                       p_force=args.p_force)
    _, _, prof = simulate(sc, args.steps, args.device)
    r2, coef = fit(prof)
    u = prof[1:-1].astype(np.float64)

    print(f"mean mid-channel velocity: {u[len(u) // 2]:+.4f}")
    print(f"profile peak/edge ratio: "
          f"{u[len(u) // 2] / max(np.mean([u[0], u[-1]]), 1e-9):.1f}")
    print(f"parabolic fit R^2 = {r2:.4f}")
    print(f"curvature a = {coef[0]:.3e} (negative = concave, correct)")
    if not r2 > 0.9:
        raise SystemExit("profile should be parabolic")
    if not coef[0] < 0:
        raise SystemExit("profile should be concave")
    print("OK: Poiseuille flow reproduced")
    return r2, coef


if __name__ == "__main__":
    main()
