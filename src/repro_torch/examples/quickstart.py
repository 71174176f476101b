"""Quickstart: a driven FHP channel advanced through the ensemble entry
point (``core.distributed.make_ensemble_run``, the fused step kernel on a
CUDA tensor), with conservation and flow diagnostics.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import time

import torch

from repro_torch.core import bitplane, byte_step, distributed

STEPS_PER_LAUNCH = 8


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--p-force", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state = torch.from_numpy(byte_step.make_channel(
        args.height, args.width, density=0.25, seed=0)).to(args.device)
    planes = bitplane.pack(state)[None]          # one ensemble lane
    m0 = int(bitplane.density_total(planes)[0])
    print(f"lattice {args.height}x{args.width} on {args.device}, "
          f"{m0} particles")

    run, _ = distributed.make_ensemble_run(
        None, args.steps, variant="fhp2", p_force=args.p_force,
        steps_per_launch=STEPS_PER_LAUNCH)
    t0 = time.perf_counter()
    planes = run(planes, 0)
    m1 = int(bitplane.density_total(planes)[0])   # waits for the device
    dt = time.perf_counter() - t0

    px, py = (int(v[0]) for v in bitplane.momentum_total(planes))
    mid = float(bitplane.row_velocity(planes)[0, args.height // 2])
    mups = args.height * args.width * args.steps / dt / 1e6
    print(f"{args.steps} steps in {dt:.2f}s  ({mups:.1f} Mups)")
    print(f"mass: {m0} -> {m1}  (conserved: {m0 == m1})")
    print(f"total momentum (px2, py): ({px}, {py})")
    print(f"mid-channel mean x-velocity: {mid:+.4f} lattice units/step")
    if m0 != m1:
        raise SystemExit("mass must be conserved")
    if not mid > 0:
        raise SystemExit("forcing must drive a net flow")
    print("OK")
    return planes[0]


if __name__ == "__main__":
    main()
