#!/usr/bin/env python3
"""Run one benchmark cell with the program's telemetry on and print its
MLA decode counts: the rows the attention-core kernel took
(``mla.decode_kernel_rows``), the ``mla.decode`` spans (one a layer a
decode step) and the rows each span covered on average; each span's
count and mean host milliseconds (the host's time in it: the device's
work is asynchronous to it); and the host's issue of each engine step's
decode (``decode_step`` from its call until it returns with every
operation enqueued, before the step reads its ids back): median and
quartiles in ms, to set beside the result line's decode-step median.

    python3 tools/mla_counters.py --workload <cell> --seed <n> [--seconds S] [--trace 0|1]

The cell runs as ``cabench/run.py`` runs it (its result line is printed
as usual); the telemetry adds its span records and counters, so the
times of this run are not the benchmark's.  Prints one JSON line last.
"""
import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=48)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch import telemetry
    telemetry.configure(True)
    from repro_torch.serve import lm_engine
    issue_ms = []
    decode_step = lm_engine.decode_step

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = decode_step(*a, **kw)
        issue_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    lm_engine.decode_step = timed
    spec = importlib.util.spec_from_file_location("cabench_run",
                                                  ROOT / "cabench/run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace",
                   str(args.trace)])
    summ = telemetry.summary()
    rows = summ["counters"].get("mla.decode_kernel_rows", 0)
    spans = summ["spans"].get("mla.decode", {}).get("count", 0)
    host_ms = {name: {"count": v["count"],
                      "mean_ms": 1e3 * v["total_s"] / v["count"]}
               for name, v in summ["spans"].items()}
    print(json.dumps({"rc": rc, "mla.decode_kernel_rows": rows,
                      "mla.decode_spans": spans,
                      "rows_a_span": rows / spans if spans else None,
                      "decode_issue_ms": {
                          "calls": len(issue_ms),
                          "median": statistics.median(issue_ms),
                          "q1_q3": statistics.quantiles(issue_ms, n=4)[::2]}
                      if len(issue_ms) > 1 else None,
                      "counters": summ["counters"],
                      "span_host_ms": host_ms}))
    return rc


if __name__ == "__main__":
    sys.exit(main())
