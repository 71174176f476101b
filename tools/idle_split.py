#!/usr/bin/env python3
"""Split a benchmark cell's device idle time three ways, from one traced
run on the card:

* launch latency: idle time after the runtime call that issued the next
  device operation (the work was already issued);
* host-late inside the program: idle time before that call, by the
  innermost of the program's own spans open (``repro_torch.telemetry``);
* host-late outside any program span (the benchmark's own loop).

    python3 tools/idle_split.py --workload <cell> --seed <n> [--seconds 48]

Prints the run's result line, then one JSON object with the split in
seconds and as a share of the window.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=48.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cabench import harness, program_spans

    kept = {}
    result = harness.result

    def keep(run, *rest):
        kept["run"] = run
        return result(run, *rest)

    harness.result = keep
    print(json.dumps(harness.run_cell(args.workload, args.seed,
                                      args.seconds, True)), flush=True)
    run = kept["run"]
    ops = program_spans.device_ops(run)
    spans = program_spans.window(run)
    win = run.window_wall
    late = program_spans.host_late(win, ops)
    idle = program_spans.host_late(win, [(s, t, None) for s, t, _ in ops])
    window_s = win[1] - win[0]
    idle_s = sum(b - a for a, b in idle)
    late_s = sum(b - a for a, b in late)
    split = program_spans.by_innermost(late, spans)
    out = {"window_s": window_s, "idle_s": idle_s,
           "launch_latency_s": idle_s - late_s, "host_late_s": late_s,
           "host_late_by_span_s": split,
           "unlaunched_ops": sum(1 for op in ops if op[2] is None),
           "ops": len(ops), "spans": len(spans)}
    out["share_pct"] = {k: 100 * v / window_s for k, v in (
        ("idle", idle_s), ("launch_latency", idle_s - late_s),
        ("host_late", late_s))}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
