"""Telemetry layer: spans, counters, gauges; JSONL sink + summary rollup.

See :mod:`repro_torch.telemetry.core`.  Library code instruments against
the module-level default instance (``telemetry.span("exchange")``), which
is disabled -- a true no-op -- until ``telemetry.configure(...)`` turns it
on.
"""
from repro_torch.telemetry.core import (Telemetry, configure, count,
                                        default, event, gauge, span,
                                        span_stats, summary)

__all__ = ["Telemetry", "configure", "count", "default", "event", "gauge",
           "span", "span_stats", "summary"]
