"""The device's side of a traced run, from ``torch.profiler``.

While open, a ``DeviceTrace`` profiles the host and the card.  ``read``
then takes every operation that ran on the device (kernels, copies,
sets), clipped to the measured window, and works out:

* ``busy_s``: the length of the union of their intervals, and
  ``window_s`` the window's length;
* ``kernels(part)``: the intervals of the kernels whose name holds
  ``part``;
* ``breakdown()``: the ten operations that took most device time, and the
  ten longest idle gaps, each named by the innermost of the benchmark's
  host spans (on the wall clock) open when the gap began.

The profiler's clock is tied to the wall clock by a marker range recorded
at a known wall time when the trace starts.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

_MARK = "cabench.clock"


def _ns(ev, what: str) -> float:
    """An event's start or duration in ns, across profiler versions."""
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.busy_s = 0.0
        self.window_s = 0.0
        self.ops: List[Tuple[float, float, str]] = []   # (start, end, name)
        self.gaps: List[Tuple[float, str]] = []
        self._prof = None
        self._mark_wall = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        t0 = time.time()
        with record_function(_MARK):
            pass
        self._mark_wall = (t0 + time.time()) / 2
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        return False

    def _events(self):
        return self._prof.profiler.kineto_results.events()

    def read(self, window: Tuple[float, float], spans: List[tuple]) -> None:
        """Clip the device's operations to ``window`` (wall-clock start and
        end) and name the idle gaps by ``spans`` ``(name, start, end)``."""
        import torch
        events = list(self._events())
        mark = [e for e in events if e.name() == _MARK]
        if not mark:
            raise RuntimeError("the profiler recorded no clock marker")
        offset = self._mark_wall - (_ns(mark[0], "start")
                                    + _ns(mark[0], "duration") / 2) * 1e-9
        w0, w1 = window
        ops = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = _ns(e, "start") * 1e-9 + offset
            t = s + _ns(e, "duration") * 1e-9
            s, t = max(s, w0), min(t, w1)
            if t > s:
                ops.append((s, t, e.name()))
        ops.sort()
        self.ops = ops
        self.window_s = w1 - w0
        busy, gaps = 0.0, []
        cur_s = cur_t = None
        prev_end = w0
        for s, t, _ in ops:
            if cur_t is None or s > cur_t:
                if cur_t is not None:
                    busy += cur_t - cur_s
                    prev_end = cur_t
                gaps.append((s - prev_end, prev_end))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is not None:
            busy += cur_t - cur_s
            prev_end = cur_t
        gaps.append((w1 - prev_end, prev_end))
        self.busy_s = busy
        gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:10]
        self.gaps = [(_innermost(spans, at), length) for length, at in gaps]

    def kernels(self, part: str) -> List[Tuple[float, float, str]]:
        return [op for op in self.ops if part in op[2]]

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = collections.defaultdict(float)
        for s, t, name in self.ops:
            by_name[name] += t - s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in self.gaps]}


def _innermost(spans: List[tuple], at: float) -> str:
    """The latest-starting span open at ``at``, or ``"outside any span"``."""
    best: Optional[tuple] = None
    for name, s, t in spans:
        if s <= at <= t and (best is None or s > best[1]):
            best = (name, s)
    return best[0] if best else "outside any span"
