"""The decode step's share of its byte roofline, in %: over the window's
engine steps that prefilled nothing, the least time their bytes need on
an H100 (``cabench.roofline.lm.decode_seconds``: every weight, each live
row's keys and values, the logits, at 3.35e12 B/s) over the time the
device was busy in them: the union of the profiler's device operations
that start inside one of those steps (the benchmark's ``lm.step``
spans; a step ends when its tokens are on the host, so its operations
have ended too).  Device time, so neither the host's issue gaps nor the
profiler's cost to the host enter it."""
import bisect

from cabench.roofline import lm


def busy_in(ops, spans) -> float:
    """Length of the union of the intervals of ``ops`` (``(start, end,
    name)``, sorted) that start inside one of ``spans`` (``(start, end)``,
    not overlapping)."""
    spans = sorted(spans)
    starts = [s for s, _ in spans]
    busy, cur = 0.0, None
    for s, t, _ in ops:
        k = bisect.bisect_right(starts, s) - 1
        if k < 0 or s >= spans[k][1]:
            continue
        if cur is None or s > cur[1]:
            busy += cur[1] - cur[0] if cur else 0.0
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def read(run):
    c = run.counters
    if run.trace is None or not c.get("decode_only_steps"):
        return None
    busy = busy_in(run.trace.ops, [(s, t) for name, s, t in run.spans.records
                                   if name == "lm.step"])
    if busy <= 0:
        return None
    least = lm.decode_seconds(run.config, steps=c["decode_only_steps"],
                              rows=c["decode_only_rows"],
                              keys=c["decode_only_keys"])
    return 100.0 * least / busy
