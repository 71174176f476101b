"""Distributed FHP demo: the domain decomposition on a (2, 2, 2) mesh of
device slots, checked bit-identical to the single-device run at every
halo depth, and an obstacle scenario through the static-geometry cache
(7 dynamic planes exchanged per round).

    PYTHONPATH=src python -m repro_torch.examples.fhp_distributed
    PYTHONPATH=src python -m repro_torch.examples.fhp_distributed --device cpu

On the card the eight slots are the visible GPUs when there are eight,
else eight shards on the one card; ``--device cpu`` runs the plain
version on eight CPU slots.
"""
import argparse
import time

import torch

from repro_torch import scenarios
from repro_torch.core import bitplane, byte_step, distributed
from repro_torch.kernels.fhp_step.ops import run_cuda

MESH = ((2, 2, 2), ("pod", "data", "model"))
Y_AXES = ("pod", "data")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    n = 8
    devices = ([torch.device("cuda", i) for i in range(n)]
               if dev.type == "cuda" and torch.cuda.device_count() == n
               else dev)
    mesh = distributed.make_mesh(*MESH, devices=devices)
    print(f"mesh: {mesh.shape} on {args.device}")
    h, w, steps = args.height, args.width, args.steps
    planes = bitplane.pack(torch.from_numpy(byte_step.make_channel(
        h, w, density=0.25, seed=0)).to(dev))
    ref = run_cuda(planes, steps, p_force=0.02)
    exact = {}

    for depth in (1, 2, 4, 8):
        run = distributed.make_run(mesh, steps, y_axes=Y_AXES,
                                   x_axis="model", p_force=0.02, depth=depth)
        run(planes, 0)                    # warm-up (builds the kernel)
        t0 = time.perf_counter()
        out = run(planes, 0)
        exact[depth] = bool(torch.equal(out, ref))   # waits for the device
        dt = time.perf_counter() - t0
        print(f"depth={depth}: bit-identical={exact[depth]}  "
              f"({h * w * steps / dt / 1e6:.1f} Mups on {args.device}; "
              f"{steps // depth} halo exchanges)")

    # Static-geometry cache: an obstacle scenario through the extended
    # kernel -- the solid apron is exchanged once, every round moves 7
    # dynamic planes instead of 8.
    sc = scenarios.get("cylinder", height=h, width=w)
    planes = sc.initial_planes(device=dev)
    ref = run_cuda(planes, steps, p_force=sc.p_force)
    run = distributed.make_run(mesh, steps, y_axes=Y_AXES, x_axis="model",
                               p_force=sc.p_force, depth=4,
                               steps_per_launch=2, static_solid=True)
    exact["cylinder"] = bool(torch.equal(run(planes, 0), ref))
    print(f"cylinder scenario, static-geometry cache, depth=4: "
          f"bit-identical={exact['cylinder']} (7/8 exchange bytes per round)")
    if not all(exact.values()):
        raise SystemExit(f"sharded run differs from the single-device run: "
                         f"{exact}")
    print("OK: domain decomposition is bit-exact at every halo depth")
    return exact


if __name__ == "__main__":
    main()
