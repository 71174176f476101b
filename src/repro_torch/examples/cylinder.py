"""Flow past a cylinder, built from the scenario registry and run through
the fused kernel's static-geometry path (7 dynamic planes + read-only
solid operand).  After spin-up the wake behind the disk has a velocity
deficit and the flow accelerates around the sides.

    PYTHONPATH=src python -m repro_torch.examples.cylinder [--steps 1500]
    PYTHONPATH=src python -m repro_torch.examples.cylinder --device cpu

The wake needs about a thousand steps to develop; shorter runs check mass
conservation and the empty disk interior only.
"""
import argparse

import numpy as np
import torch

from repro_torch import scenarios
from repro_torch.core import bitplane, byte_step
from repro_torch.geometry import Disk, rasterize
from repro_torch.kernels.fhp_step.ops import run_cuda
from repro_torch.scenarios import observables

STEPS_PER_LAUNCH = 8
WAKE_STEPS = 1000


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--radius", type=int, default=10)
    ap.add_argument("--p-force", type=float, default=0.03)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sc = scenarios.get("cylinder", height=args.height, width=args.width,
                       radius=args.radius, p_force=args.p_force)
    h, w = sc.height, sc.width
    disk = dict(sc.obstacles)["disk"]
    cy, cx, r = disk.cy, disk.cx, disk.r
    planes = sc.initial_planes(device=args.device)
    m0 = int(observables.mass(planes))

    # Static-geometry path: the solid plane rides as a read-only operand.
    solid = planes[7].contiguous()
    dyn = run_cuda(planes[:7].contiguous(), args.steps, p_force=sc.p_force,
                   steps_per_launch=STEPS_PER_LAUNCH, solid=solid)
    planes = torch.cat([dyn, solid[None]], dim=0)
    if not observables.mass_audit(planes, m0):
        raise SystemExit("mass must be conserved")

    out = bitplane.unpack(planes)
    px2, _ = byte_step.momentum(out)
    ux = px2.cpu().numpy().astype(np.float64) / 2.0
    dens = byte_step.density(out).cpu().numpy()
    n = np.maximum(dens.astype(np.float64), 1e-9)

    def region_u(y0, y1, x0, x1):
        return float(ux[y0:y1, x0:x1].sum() / n[y0:y1, x0:x1].sum())

    upstream = region_u(cy - r, cy + r, cx - 6 * r, cx - 3 * r)
    wake = region_u(cy - r, cy + r, cx + 2 * r, cx + 5 * r)
    side = region_u(2, cy - 2 * r, cx - r, cx + r)
    drag = observables.obstacle_report(planes, sc)

    print(f"lattice {h}x{w} on {args.device}, disk r={r} at ({cy},{cx}), "
          f"{args.steps} steps, mass conserved: True")
    print(f"mean u_x upstream: {upstream:+.4f}")
    print(f"mean u_x in wake : {wake:+.4f}  (deficit "
          f"{(1 - wake / max(upstream, 1e-9)) * 100:.0f}%)")
    print(f"mean u_x beside  : {side:+.4f}  (bypass acceleration "
          f"{(side / max(upstream, 1e-9) - 1) * 100:+.0f}%)")
    print(f"momentum on disk (px2, py): {drag['disk']}")
    # the disk's interior stays empty (its perimeter transiently holds
    # particles mid-bounce: that is the no-slip mechanism itself)
    interior = rasterize(Disk(cy, cx, max(r - 2, 0)), (h, w))
    if int(dens[interior].sum()):
        raise SystemExit("particles inside the disk")
    if args.steps < WAKE_STEPS:
        print(f"OK (wake not checked below {WAKE_STEPS} steps)")
        return planes
    if not wake < upstream:
        raise SystemExit("wake must show a velocity deficit")
    if not side > wake:
        raise SystemExit("flow must accelerate around the obstacle")
    print("OK: obstacle wake reproduced")
    return planes


if __name__ == "__main__":
    main()
