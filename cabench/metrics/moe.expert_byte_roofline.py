"""The expert layers' share of their byte roofline in decode, in %: over
the window's engine steps that prefilled nothing, the least time their
expert layers' weights need on an H100 (``cabench.roofline.lm_mla_moe.
expert_seconds``: the held and shared experts and the router, read once a
layer a step, at 3.35e12 B/s) over the time the device was busy in the
operations that the program launched inside its ``moe.route`` and
``moe.experts`` spans of those steps (the union of their intervals; the
launch found by the profiler's correlation id).  No reading where the
program keeps no such spans."""
import bisect

from cabench import program_spans
from cabench.roofline import lm_mla_moe

SPANS = ("moe.route", "moe.experts")


def _inside(intervals, at) -> bool:
    """Whether ``at`` lies in one of ``intervals`` (sorted, disjoint)."""
    k = bisect.bisect_right(intervals, (at, float("inf"))) - 1
    return k >= 0 and at < intervals[k][1]


def busy_launched_in(run, names):
    """Seconds of the union of the device operations launched inside the
    program's spans ``names`` that began in a decode-only step (the
    benchmark's ``lm.step`` spans), or None where there are none."""
    spans = program_spans.window(run)
    ops = program_spans.device_ops(run)
    if not spans or not ops:
        return None
    steps = sorted((s, t) for name, s, t in run.spans.records
                   if name == "lm.step")
    inside = sorted((r.start, r.end) for r in spans
                    if r.name in names and _inside(steps, r.start))
    if not inside:
        return None
    busy, cur = 0.0, None
    for s, t, launch in ops:
        if launch is None or not _inside(inside, launch):
            continue
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    busy += cur[1] - cur[0] if cur else 0.0
    return busy or None


def read(run):
    steps = run.counters.get("decode_only_steps")
    if run.trace is None or not steps:
        return None
    busy = busy_launched_in(run, SPANS)
    if busy is None:
        return None
    return 100.0 * lm_mla_moe.expert_seconds(run.config, steps) / busy
