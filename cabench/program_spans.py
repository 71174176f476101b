"""The program's own spans in a traced run, set beside the device's
timeline.

The program (``repro_torch.telemetry``) keeps its spans in memory, on the
wall clock, whenever a profiler records, as the ``DeviceTrace`` of a
``--trace 1`` run does.  This module reads them and the profiler's events
for the per-layer metrics that need both:

* ``window(run)``: the module default's span records that began in the
  window (``run.window_wall``), or None where the program keeps no span
  record or may have dropped some of the window's;
* ``device_ops(run)``: every device operation of the window, clipped to
  it, with the wall time of the runtime call that launched it (found by
  ``correlation_id()``; the profiler's clock is mapped to the wall clock
  through the trace's ``cabench.clock`` marker, as ``trace.py`` maps it);
* ``host_late(window, ops)``: the part of each idle gap of the device
  that lies before the launch of the operation that ends it, the time the
  device waited for the host to issue work.  The rest of a gap is launch
  latency of work already issued;
* ``covered(intervals, spans)`` and ``by_innermost(intervals, spans)``:
  how much of some intervals the spans cover, in all and by the innermost
  span open.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

from cabench import trace as dtrace

Interval = Tuple[float, float]
OUTSIDE = "outside any span"


def window(run) -> Optional[list]:
    """The program's span records ``(name, parent, start, end)`` that
    began in the run's window, in the order they ended; None where the
    record dropped spans that may have begun in the window."""
    from repro_torch import telemetry
    tel = telemetry.default()
    if not hasattr(tel, "spans"):
        return None
    recs = tel.spans()
    w0, w1 = run.window_wall
    # Records are kept in the order they end, so every dropped record
    # ended no later than the oldest kept one.
    if tel.dropped_spans and (not recs or recs[0].end >= w0):
        return None
    return [r for r in recs if w0 <= r.start < w1]


def _is_runtime_call(ev) -> bool:
    """A host-side CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemsetAsync``, ...), whose correlation id
    is that of the device operation it issued."""
    name = ev.name()
    return name.startswith("cu") and "::" not in name


def device_ops(run) -> Optional[List[Tuple[float, float, Optional[float]]]]:
    """``(start, end, launch)`` of every device operation in the window,
    sorted, on the wall clock; ``launch`` is the start of the runtime call
    that issued it, or None where the profiler holds none."""
    import torch
    tr = run.trace
    if tr is None or tr._prof is None:
        return None
    events = list(tr._events())
    mark = [e for e in events if e.name() == dtrace._MARK]
    if not mark:
        return None
    offset = tr._mark_wall - (dtrace._ns(mark[0], "start")
                              + dtrace._ns(mark[0], "duration") / 2) * 1e-9
    cuda = torch.autograd.DeviceType.CUDA
    launched = {e.correlation_id(): dtrace._ns(e, "start") * 1e-9 + offset
                for e in events
                if e.device_type() != cuda and _is_runtime_call(e)}
    w0, w1 = run.window_wall
    ops = []
    for e in events:
        if e.device_type() != cuda:
            continue
        s = dtrace._ns(e, "start") * 1e-9 + offset
        t = s + dtrace._ns(e, "duration") * 1e-9
        if min(t, w1) > max(s, w0):
            ops.append((max(s, w0), min(t, w1),
                        launched.get(e.correlation_id())))
    ops.sort(key=lambda op: op[:2])
    return ops


def host_late(win: Interval, ops: Sequence[Tuple[float, float,
                                                 Optional[float]]]
              ) -> List[Interval]:
    """The host-late part of each idle gap of ``win`` less the union of
    ``ops`` (sorted ``(start, end, launch)``): from the gap's start until
    the launch of the operation that ends the gap, nothing where that
    launch came before the gap.  A gap that no operation ends (the
    window's tail) or whose operation's launch is unknown counts whole."""
    w0, w1 = win
    out = []
    frontier = w0
    for s, t, launch in ops:
        if s > frontier:
            end = s if launch is None else min(max(launch, frontier), s)
            if end > frontier:
                out.append((frontier, end))
        frontier = max(frontier, t)
    if w1 > frontier:
        out.append((frontier, w1))
    return out


def _union(spans) -> List[Interval]:
    merged: List[List[float]] = []
    for s, t in sorted((r[2], r[3]) for r in spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def covered(intervals: Sequence[Interval], spans) -> float:
    """Seconds of ``intervals`` (disjoint) that the union of ``spans``
    (records ``(name, parent, start, end)``) covers."""
    union = _union(spans)
    starts = [s for s, _ in union]
    total = 0.0
    for a, b in intervals:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(union) and union[i][0] < b:
            total += max(0.0, min(b, union[i][1]) - max(a, union[i][0]))
            i += 1
    return total


def by_innermost(intervals: Sequence[Interval], spans) -> Dict[str, float]:
    """Seconds of ``intervals`` (disjoint) by the innermost span open (the
    latest to start; ``OUTSIDE`` where none is)."""
    points = []
    for a, b in intervals:
        points += [(a, 1, None), (b, -1, None)]
    for r in spans:
        points += [(r[2], 2, r), (r[3], -2, r)]
    points.sort(key=lambda p: (p[0], p[1]))
    out: Dict[str, float] = collections.defaultdict(float)
    open_spans: list = []
    inside = 0
    prev = None
    for at, kind, rec in points:
        if inside and prev is not None and at > prev:
            name = (max(open_spans, key=lambda r: (r[2], -r[3]))[0]
                    if open_spans else OUTSIDE)
            out[name] += at - prev
        prev = at
        if kind == 1:
            inside += 1
        elif kind == -1:
            inside -= 1
        elif kind == 2:
            open_spans.append(rec)
        else:
            open_spans.remove(rec)
    return dict(out)
