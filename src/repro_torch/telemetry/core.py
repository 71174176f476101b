"""Lightweight telemetry: wall-clock span records, counters, events.

The serve/kernel stack built exchange overlap, audits, and
rollback-replay with zero metrics -- nothing recorded how often
rollbacks fire or where a round's latency budget goes.  This module is
the measurement layer those systems hang their numbers on:

* ``span(name, **attrs)`` -- a context manager timing one operation,
  with thread-local nesting (child spans carry their parent's name, so a
  ``serve.round`` decomposes into its ``admit`` / ``kernel`` / ``audit``
  / ``checkpoint`` children);
* ``count(name, n)`` -- monotone event tallies;
* ``event(name, critical=False, **attrs)`` -- a point-in-time record;
  ``critical`` events (rollback, quarantine) flush **and fsync** the
  JSONL sink, so the trace of a fault survives the process death that
  ``CAServeEngine.resume`` recovers from.

A span's start is ``time.time()`` read as it opens; its duration is a
``time.perf_counter()`` difference, and its end the start plus that
duration.  So spans lie on the wall clock, the clock a profiler's device
timeline is mapped onto, while durations stay monotonic.

Sinks: a bounded in-memory record of every span (``spans()``: name,
parent, start, end; ``dropped_spans`` counts what the bound evicted), a
rollup (``summary()``: count/total/p50/p99/max a span name, counters,
the number of events) and an optional JSONL file -- one self-describing
object per line (``kind``: span | counter | event; a span's ``wall`` is
its end), opened line-buffered so every record is its own ``write()``.

**When spans record.**  An enabled instance records everything.  A
disabled one records spans, into the in-memory record only, while a
``torch.profiler`` is recording (``torch.autograd.profiler.
_is_profiler_enabled``), so that a traced run can set the program's own
spans beside the device's timeline without switching telemetry on.
Spans are never emitted into the profiler itself: a ``record_function``
range around kernel launches comes back as a device-side annotation,
which a reader of device operations would count as device work.
Otherwise disabled telemetry is a **true no-op**: ``span`` hands back a
shared null context manager and ``count``/``event`` return before
touching any state -- no clock reads, no allocation beyond the call
itself, and (asserted in tests) no numeric change to instrumented code.

The counterpart of ``repro/telemetry/core.py``, with its span, counter
and event records.

The module-level default instance is what library code instruments
against (``telemetry.span(...)`` at layer boundaries); ``configure()``
switches it on and points it at a sink.  Constructing private
``Telemetry`` instances keeps tests and engines isolated.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _autograd_profiler

__all__ = ["Telemetry", "SpanRecord", "configure", "default", "span",
           "count", "event", "summary"]

# Spans kept in memory: a 48 s window of ~8,000 ensemble calls of ~10
# spans each fits with room.
MAX_SPANS = 1 << 18


class SpanRecord(NamedTuple):
    """One finished span: its name, its parent's name (None at the top)
    and its start and end in wall-clock seconds."""
    name: str
    parent: Optional[str]
    start: float
    end: float


class _NullSpan:
    """Shared do-nothing context manager: the disabled-telemetry span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """One live span; records itself on exit."""
    __slots__ = ("_tel", "name", "attrs", "wall0", "t0", "_parent")

    def __init__(self, tel: "Telemetry", name: str, attrs: Dict):
        self._tel = tel
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = self._tel._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self.wall0 = time.time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self.t0
        self._tel._stack().pop()
        self._tel._record_span(self.name, self.wall0, dur, self._parent,
                               self.attrs)
        return False


class Telemetry:
    """Span/counter/event registry with an optional JSONL sink.

    ``max_events`` bounds the rollup's per-span duration lists and the
    event list (oldest halved out) and ``max_spans`` the span record, so
    a long-lived serve process cannot grow without bound; the JSONL
    sink, when given, keeps the full stream.
    """

    def __init__(self, enabled: bool = False,
                 jsonl_path: Optional[str] = None,
                 max_events: int = 65536, max_spans: int = MAX_SPANS):
        self.enabled = enabled
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._durs: Dict[str, List[float]] = {}
        self._counters: Dict[str, float] = {}
        self._events: List[Dict] = []
        self._spans: collections.deque = collections.deque(
            maxlen=int(max_spans))
        self.dropped_spans = 0
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
        """Context manager timing ``name``.  Disabled with no profiler
        recording, it returns a shared null object (no clock read, no
        allocation of state)."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _NULL
        return _Span(self, name, attrs)

    def _record_span(self, name: str, wall0: float, dur: float,
                     parent: Optional[str], attrs: Dict) -> None:
        end = wall0 + dur
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            # A plain tuple of strings and floats, which the garbage
            # collector stops tracking (a named tuple it tracks for good:
            # ~80k of them trigger full collections of ~0.1-0.2 s).
            self._spans.append((name, parent, wall0, end))
            if not self.enabled:
                return
            d = self._durs.setdefault(name, [])
            d.append(dur)
            if len(d) > self.max_events:
                del d[:len(d) // 2]
            rec = {"kind": "span", "name": name, "wall": end,
                   "dur_s": dur, "traced": False}
            if parent:
                rec["parent"] = parent
            if attrs:
                rec["attrs"] = attrs
            self._emit(rec)

    def spans(self) -> List[SpanRecord]:
        """Every span recorded and not dropped, in the order they ended."""
        with self._lock:
            return [SpanRecord._make(r) for r in self._spans]

    # -- counters / events --------------------------------------------------
    def count(self, name: str, n: float = 1) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            self._emit({"kind": "counter", "name": name, "wall": time.time(),
                        "n": n})

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
        """Percentile rollup of what an enabled instance recorded: per-span
        ``{count, total_s, p50_s, p99_s, max_s}``, counters, and the number
        of events."""
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
            return {"spans": spans,
                    "counters": dict(self._counters),
                    "events": len(self._events)}

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
            self._counters.clear()
            self._events.clear()
            self._spans.clear()
            self.dropped_spans = 0

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


def event(name: str, critical: bool = False, **attrs) -> None:
    _default.event(name, critical=critical, **attrs)


def summary() -> Dict:
    return _default.summary()
