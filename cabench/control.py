#!/usr/bin/env python3
"""The control of ``correct``, and broken timed paths, for any cell.

The control is the plain reference put in the program's place with one
stated guarantee broken.  FHP-II: the body force drawn from 8 random bits
a node instead of 16 (p = 0.03 becomes 8/256 = 0.03125 where the rule
states 1966/65536), the cut a faster kernel would be tempted to make,
since the comparator's rounds are a large share of a word-step's
instructions.  BML, which has no RNG: a car blocked only by a car of its
own kind ahead, one plane read a sub-step instead of two, so that two
cars may share a cell.  A run with it in place must come out not correct.

``faulty(kind)`` breaks the program's stepper underneath a run: its step
returns the state unchanged (``unchanged``), steps only the first half of
the lanes (``half``), or alters one bit of what it produces (``altered``).

On the card, at a cell's own size:

    python3 cabench/control.py --workload <cell> --seconds <s> --seeds <n>...

prints one JSON line a seed with the numbers compared: the control's
readings, the upper ones of the limits.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAULTS = ("unchanged", "half", "altered")


def _bml_own_kind_step(state, t: int):
    """One BML sub-step in which a car is blocked only by a car of its
    own kind ahead."""
    import torch
    east, north = state & 1, (state >> 1) & 1
    if int(t) % 2 == 0:
        go = east & (1 - torch.roll(east, -1, dims=-1))
        east = (east - go) | torch.roll(go, 1, dims=-1)
    else:
        go = north & (1 - torch.roll(north, -1, dims=-2))
        north = (north - go) | torch.roll(go, 1, dims=-2)
    return east | (north << 1)


def control_make_run(force_bits: int = 8, bml_exclusion: bool = False):
    """A stand-in for ``make_ensemble_run(None, ...)`` that steps with the
    reference at ``force_bits`` bits of forcing, and BML without its
    exclusion between kinds unless ``bml_exclusion``."""
    import torch
    from cabench.reference import lattice

    def make(mesh, steps, *, variant="fhp2", p_force=0.0, moments_every=0,
             **_kw):
        def run(planes, t0=0):
            s = lattice.to_bytes(planes)
            if variant == "bml" and not bml_exclusion:
                rec = []
                for k in range(steps):
                    s = _bml_own_kind_step(s, t0 + k)
                    if moments_every and (k + 1) % moments_every == 0:
                        rec.append((k + 1, lattice.moments(s, variant)))
            else:
                s, rec = lattice.run(s, variant, t0, steps, p_force=p_force,
                                     force_bits=force_bits,
                                     record_every=moments_every)
            out = lattice.to_planes(s, planes.shape[-3])
            return out, torch.stack([r for _, r in rec],
                                    dim=-2).to(torch.int32)
        return run, None
    return make


def faulty(kind: str):
    """``make_ensemble_run`` with its stepper broken as ``kind`` says."""
    if kind not in FAULTS:
        raise ValueError(f"fault {kind!r} not in {FAULTS}")
    from repro_torch.core import distributed
    real = distributed.make_ensemble_run

    def make(*args, **kw):
        run, sharding = real(*args, **kw)

        def broken(planes, t0=0):
            out, mom = run(planes, t0)
            if kind == "unchanged":
                return planes.clone(), mom
            out = out.clone()
            if kind == "half":
                half = planes.shape[0] // 2
                out[half:] = planes[half:]
            else:
                out[0, 1, 1, 1] ^= 1 << 5
            return out, mom
        return broken, sharding
    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cabench import harness
    hooks = {"make_run": control_make_run()}
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               hooks=hooks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
