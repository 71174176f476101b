#!/usr/bin/env python3
"""Time the port's 64-step main path on one card, from a given source tree,
so that two trees of the repo can be held against each other in one run.

    python3 tools/main_path_times.py [--src DIR] [--repeats N] [--seed S]

The call timed is ``chip_smoke.py`` phase 3's:
``make_ensemble_run(None, 64, variant="fhp2", p_force=0.03,
steps_per_launch=8, moments_every=8)`` on 4 lanes of 4096 x 32768 nodes.
The lanes are random bits drawn on the card from the seed (the kernel has
no data-dependent branch, so its time does not depend on them).  ``DIR``
(default: this checkout's ``src``) comes first on the import path, so its
``repro_torch`` is the one timed, and its kernel is built there.  The first
run (memory allocated, the kernel loaded) is reported apart from the ``N``
runs after it (default 7).  Prints one JSON line: the card's name and
power limit, the first run's wall seconds, and the later runs' walls with
their median, least and most.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

LANES, HEIGHT, WIDTH = 4, 4096, 32768
STEPS, T, P_FORCE = 64, 8, 0.03


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("main_path_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import distributed
    from repro_torch.kernels.fhp_step import build

    build.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    planes = torch.randint(-2 ** 31, 2 ** 31, (LANES, 8, HEIGHT, WIDTH // 32),
                           dtype=torch.int64, device="cuda",
                           generator=gen).to(torch.int32)
    run, _ = distributed.make_ensemble_run(
        None, STEPS, variant="fhp2", p_force=P_FORCE, steps_per_launch=T,
        moments_every=T)

    def wall() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(planes, 0)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    first = wall()
    walls = [wall() for _ in range(args.repeats)]
    print(json.dumps({"src": args.src, "card": card, "first_s": first,
                      "median_s": statistics.median(walls),
                      "min_s": min(walls), "max_s": max(walls),
                      "walls_s": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
