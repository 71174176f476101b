"""The readers of the program's own spans (``cabench/program_spans.py``)
on the CPU: a traced run of the ensemble mix at a tiny size records one
``ensemble.run`` a call, each inside the benchmark's ``ensemble.call``;
the host-late arithmetic on synthetic device intervals and launches; a
record that dropped spans of the window gives no reading.

    python -m pytest cabench/checks -o python_files='check_*.py'
"""
from __future__ import annotations

import types

import pytest

from cabench import harness, program_spans
from cabench.checks.check_harness import ENSEMBLES, SEED, TINY


@pytest.mark.parametrize("cell", ENSEMBLES)
def test_one_program_span_a_call_inside_the_benchmarks(cell, monkeypatch):
    kept = {}
    result = harness.result

    def keep(run, *args):
        kept["run"] = run
        return result(run, *args)

    monkeypatch.setattr(harness, "result", keep)
    overrides, seconds = TINY[cell]
    res = harness.run_cell(cell, SEED, seconds, True, device="cpu",
                           overrides=overrides)
    run = kept["run"]
    runs = [r for r in program_spans.window(run) if r.name == "ensemble.run"]
    assert len(runs) == run.counters["calls"] > 0
    calls = [(s, t) for name, s, t in run.spans.records
             if name == "ensemble.call"]
    assert len(calls) == len(runs)
    for r, (s, t) in zip(runs, calls):
        assert s <= r.start <= r.end <= t
    assert res["metrics"]["ensemble.run_ms"]["value"] == pytest.approx(
        1e3 * sum(r.end - r.start for r in runs) / len(runs))
    # No device operation on the CPU: nothing to set the spans beside.
    assert "ensemble.issue_idle_share" not in res["metrics"]


def _rec(name, start, end, parent=None):
    return (name, parent, start, end)


# Device operations (start, end, launch) in a window of 0-10 s: a gap at
# 2-3 whose operation was queued at 1.5, one at 5-7 whose operation was
# launched at 6, one at 8-9 whose operation was launched at 8.8 while the
# host ran no ensemble.run, and the window's tail, 9.5-10.
OPS = [(0.0, 2.0, -1.0), (3.0, 5.0, 1.5), (7.0, 8.0, 6.0), (9.0, 9.5, 8.8)]
RUNS = [_rec("ensemble.run", 1.0, 2.5), _rec("ensemble.run", 4.5, 6.5)]


def test_host_late_counts_only_the_wait_for_a_launch():
    late = program_spans.host_late((0.0, 10.0), OPS)
    assert late == [(5.0, 6.0), (8.0, pytest.approx(8.8)), (9.5, 10.0)]
    assert program_spans.covered(late, RUNS) == pytest.approx(1.0)


@pytest.mark.parametrize("ops, want", [
    ([(2.0, 3.0, 1.0)], [(0.0, 1.0), (3.0, 4.0)]),   # queued mid-gap
    ([(2.0, 3.0, 0.0)], [(3.0, 4.0)]),              # queued before it
    ([(2.0, 3.0, None)], [(0.0, 2.0), (3.0, 4.0)]),  # launch unknown
    ([(0.0, 3.0, -1.0), (1.0, 2.0, -1.0)], [(3.0, 4.0)]),  # overlapping
    ([], [(0.0, 4.0)]),
])
def test_host_late_cases(ops, want):
    assert program_spans.host_late((0.0, 4.0), ops) == want


def test_by_innermost_names_the_deepest_open_span():
    late = program_spans.host_late((0.0, 10.0), OPS)
    spans = RUNS + [_rec("fhp_step.launch", 5.5, 6.2, "ensemble.run")]
    split = program_spans.by_innermost(late, spans)
    assert split == pytest.approx({"ensemble.run": 0.5,
                                   "fhp_step.launch": 0.5,
                                   program_spans.OUTSIDE: 1.3})
    assert sum(split.values()) == pytest.approx(
        sum(b - a for a, b in late))


def test_a_record_that_may_have_dropped_window_spans_gives_no_reading(
        monkeypatch):
    """Records are kept in the order they end, so once the oldest kept
    one ends inside the window, a dropped one may have begun there."""
    from repro_torch import telemetry
    tel = telemetry.Telemetry(enabled=True, max_spans=3)
    monkeypatch.setattr(telemetry, "default", lambda: tel)
    with tel.span("before"):
        pass
    run = types.SimpleNamespace(window_wall=(tel.spans()[0].end + 1e-6,
                                             float("inf")))
    for _ in range(2):
        with tel.span("ensemble.run"):
            pass
    assert tel.dropped_spans == 0
    assert len(program_spans.window(run)) == 2
    with tel.span("ensemble.run"):
        pass
    assert tel.dropped_spans == 1
    assert program_spans.window(run) is None
