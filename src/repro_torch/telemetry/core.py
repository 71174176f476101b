"""Lightweight telemetry: monotonic-clock spans, counters, gauges.

The serve/kernel stack built exchange overlap, audits, and
rollback-replay with zero metrics -- nothing recorded how often
rollbacks fire or where a round's latency budget goes.  This module is
the measurement layer those systems hang their numbers on:

* ``span(name, **attrs)`` -- a context manager timing one operation on
  the monotonic clock, with thread-local nesting (child spans carry
  their parent's id, so a ``serve.round`` decomposes into its
  ``exchange`` / ``kernel`` / ``audit`` / ``checkpoint`` children);
* ``count(name, n)`` / ``gauge(name, value)`` -- monotone event tallies
  and last-value measurements;
* ``event(name, critical=False, **attrs)`` -- a point-in-time record;
  ``critical`` events (rollback, quarantine) flush **and fsync** the
  JSONL sink, so the trace of a fault survives the process death that
  ``CAServeEngine.resume`` recovers from.

Sinks: an in-memory registry (bounded; ``summary()`` rolls spans up to
count/total/p50/p99/max) and an optional JSONL file -- one
self-describing object per line (``kind``: span | counter | gauge |
event), opened line-buffered so every record is its own ``write()``.

Disabled telemetry is a **true no-op**: ``span`` hands back a shared
null context manager and ``count``/``gauge``/``event`` return before
touching any state -- no clock reads, no allocation beyond the call
itself, and (asserted in tests) no numeric change to instrumented code.

While ``torch.compile`` traces a function, wall-clocking the span body
would time *trace* time, not run time -- and a compiled region re-runs
without re-tracing.  A span opened while compiling
(``torch.compiler.is_compiling()``) therefore wraps the body in
``torch.profiler.record_function`` instead -- plus an NVTX range when
CUDA is in use -- so the name shows up in ``torch.profiler`` timelines,
and the span is recorded with ``traced: true`` and the trace-time
duration (compile-side cost, not step time -- consumers filter on the
flag).

The counterpart of ``repro/telemetry/core.py``, with the same API and
the same records.

The module-level default instance is what library code instruments
against (``telemetry.span(...)`` at layer boundaries); ``configure()``
switches it on and points it at a sink.  Constructing private
``Telemetry`` instances keeps tests and engines isolated.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Telemetry", "configure", "default", "span", "count", "gauge",
           "event", "summary", "span_stats"]


def _tracing() -> bool:
    """True while ``torch.compile`` traces the calling code."""
    return torch.compiler.is_compiling()


class _NullSpan:
    """Shared do-nothing context manager: the disabled-telemetry span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """One live monotonic-clock span; records itself on exit."""
    __slots__ = ("_tel", "name", "attrs", "t0", "_parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = self._tel._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self.t0
        self._tel._stack().pop()
        self._tel._record_span(self.name, dur, self._parent, self.attrs,
                               traced=False)
        return False


class _TracedSpan:
    """Span opened while ``torch.compile`` traces: names the region
    (``torch.profiler.record_function``, and an NVTX range when CUDA is
    in use -- visible in profiler timelines) and records the
    *trace-time* duration with ``traced: true``."""
    __slots__ = ("_tel", "name", "attrs", "t0", "_scope", "_nvtx",
                 "_parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = self._tel._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._scope = torch.profiler.record_function(self.name)
        self._scope.__enter__()
        self._nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        dur = time.monotonic() - self.t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._scope.__exit__(*exc)
        self._tel._stack().pop()
        self._tel._record_span(self.name, dur, self._parent, self.attrs,
                               traced=True)
        return False


class Telemetry:
    """Span/counter/gauge registry with an optional JSONL sink.

    ``max_events`` bounds the in-memory per-span duration lists (oldest
    halved out) so a long-lived serve process cannot grow without bound;
    the JSONL sink, when given, keeps the full stream.
    """

    def __init__(self, enabled: bool = False,
                 jsonl_path: Optional[str] = None,
                 max_events: int = 65536):
        self.enabled = enabled
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._durs: Dict[str, List[float]] = {}
        self._traced: Dict[str, int] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._events: List[Dict] = []
        self._file = None
        self.jsonl_path = None
        if jsonl_path is not None:
            self.open_sink(jsonl_path)

    # -- sink ---------------------------------------------------------------
    def open_sink(self, path: str) -> None:
        """Attach (or switch) the JSONL sink.  Line-buffered: each record
        is one ``write()`` of one line, so a crash loses at most the
        record being written."""
        with self._lock:
            if self._file is not None:
                self._file.close()
            self._file = open(path, "a", buffering=1)
            self.jsonl_path = path

    def _emit(self, rec: Dict, critical: bool = False) -> None:
        if self._file is None:
            return
        self._file.write(json.dumps(rec) + "\n")
        if critical:
            self._file.flush()
            os.fsync(self._file.fileno())

    # -- spans --------------------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs):
        """Context manager timing ``name``; the disabled path returns a
        shared null object (no clock read, no allocation of state)."""
        if not self.enabled:
            return _NULL
        if _tracing():
            return _TracedSpan(self, name, attrs)
        return _Span(self, name, attrs)

    def _record_span(self, name: str, dur: float, parent: Optional[str],
                     attrs: Dict, traced: bool) -> None:
        with self._lock:
            if traced:
                self._traced[name] = self._traced.get(name, 0) + 1
            else:
                d = self._durs.setdefault(name, [])
                d.append(dur)
                if len(d) > self.max_events:
                    del d[:len(d) // 2]
            rec = {"kind": "span", "name": name, "wall": time.time(),
                   "dur_s": dur, "traced": traced}
            if parent:
                rec["parent"] = parent
            if attrs:
                rec["attrs"] = attrs
            self._emit(rec)

    # -- counters / gauges / events -----------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            self._emit({"kind": "counter", "name": name, "wall": time.time(),
                        "n": n})

    def gauge(self, name: str, value: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._gauges[name] = value
            self._emit({"kind": "gauge", "name": name, "wall": time.time(),
                        "value": value})

    def event(self, name: str, critical: bool = False, **attrs) -> None:
        """Point-in-time record.  ``critical=True`` (rollback,
        quarantine, crash) flushes and fsyncs the sink before returning:
        the fault trace must survive the process dying on the next
        instruction."""
        if not self.enabled:
            return
        with self._lock:
            rec = {"kind": "event", "name": name, "wall": time.time()}
            if attrs:
                rec["attrs"] = attrs
            if critical:
                rec["critical"] = True
            self._events.append(rec)
            if len(self._events) > self.max_events:
                del self._events[:len(self._events) // 2]
            self._emit(rec, critical=critical)

    # -- rollup -------------------------------------------------------------
    def summary(self) -> Dict:
        """Percentile rollup of everything recorded so far: per-span
        ``{count, total_s, p50_s, p99_s, max_s}`` (wall spans only;
        traced spans roll up as a count), counters, gauges."""
        with self._lock:
            spans = {}
            for name, durs in self._durs.items():
                d = sorted(durs)
                n = len(d)
                spans[name] = {
                    "count": n,
                    "total_s": sum(d),
                    "p50_s": d[(n - 1) // 2],
                    "p99_s": d[min(n - 1, (99 * n) // 100)],
                    "max_s": d[-1],
                }
            for name, n in self._traced.items():
                spans.setdefault(name, {}).update(traced_count=n)
            return {"spans": spans,
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "events": len(self._events)}

    def span_stats(self, name: str) -> Optional[Dict]:
        """Rollup for one span name -- ``{count, p50_s, p99_s, max_s}``
        or None if never recorded.  The serve layer's straggler detector
        and SLO report read single spans this way without paying for the
        full :meth:`summary` walk."""
        with self._lock:
            durs = self._durs.get(name)
            if not durs:
                return None
            d = sorted(durs)
            n = len(d)
            return {"count": n, "p50_s": d[(n - 1) // 2],
                    "p99_s": d[min(n - 1, (99 * n) // 100)],
                    "max_s": d[-1]}

    def events(self, name: Optional[str] = None) -> List[Dict]:
        with self._lock:
            return [e for e in self._events
                    if name is None or e["name"] == name]

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                os.fsync(self._file.fileno())

    def reset(self) -> None:
        with self._lock:
            self._durs.clear()
            self._traced.clear()
            self._counters.clear()
            self._gauges.clear()
            self._events.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# -- module default: what library instrumentation points bind to ------------
_default = Telemetry()


def default() -> Telemetry:
    return _default


def configure(enabled: bool = True,
              jsonl_path: Optional[str] = None) -> Telemetry:
    """Switch the module default on (or off) and optionally attach a
    JSONL sink; returns the default instance."""
    _default.enabled = enabled
    if jsonl_path is not None:
        _default.open_sink(jsonl_path)
    return _default


def span(name: str, **attrs):
    return _default.span(name, **attrs)


def count(name: str, n: float = 1) -> None:
    _default.count(name, n)


def gauge(name: str, value: float) -> None:
    _default.gauge(name, value)


def event(name: str, critical: bool = False, **attrs) -> None:
    _default.event(name, critical=critical, **attrs)


def summary() -> Dict:
    return _default.summary()


def span_stats(name: str) -> Optional[Dict]:
    return _default.span_stats(name)
