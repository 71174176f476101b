"""Telemetry layer: spans, counters, events; JSONL sink + summary rollup.

See :mod:`repro_torch.telemetry.core`.  Library code instruments against
the module-level default instance (``telemetry.span("exchange")``), which
is disabled -- a true no-op while no profiler records -- until
``telemetry.configure(...)`` turns it on.
"""
from repro_torch.telemetry.core import (SpanRecord, Telemetry, configure,
                                        count, default, event, span,
                                        summary)

__all__ = ["SpanRecord", "Telemetry", "configure", "count", "default",
           "event", "span", "summary"]
