#!/usr/bin/env python3
"""Run one benchmark cell once on the card and print its result.

    python3 cabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration, traffic mix
and metrics are found by name from ``BENCHMARK.json``; the program is the
checkout's ``src/repro_torch``.  Set-up (the kernel's build on a
checkout's first run, the inputs, the warm-up) is timed as ``setup_s``;
then the traffic runs for ``--seconds`` seconds; then what the window
produced is compared with the plain reference.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` the ``breakdown``, and last
``checks``: each number compared beside its limit); the checks are also
the last lines of standard error.  With ``--trace 0`` the metrics are the
cell's end-to-end ones, with ``--trace 1`` its per-layer ones.

Exits with a code other than 0 and prints no result when there is no
card (it never falls back to the CPU), when the program is missing, or
when JAX or the JAX package was loaded.
"""
import time

_STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cabench import harness
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        print(f"cabench: the program is missing ({err})", file=sys.stderr)
        return 3
    try:
        res = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            started=harness.process_start_wall() or _STARTED)
    except harness.BenchError as err:
        print(f"cabench: {err}", file=sys.stderr)
        return 2
    bad = harness.forbidden_loaded()
    if bad:
        print(f"cabench: forbidden modules were loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
