"""Milliseconds of host time to issue one ensemble call: the mean length
of the program's own ``ensemble.run`` spans (``make_ensemble_run``'s
``run``: argument checks, the launch loop's allocations and library
calls, the moments' concatenation) that began in the window.  No reading
where their number is not the window's count of calls."""
from cabench import program_spans


def read(run):
    spans = program_spans.window(run)
    calls = run.counters.get("calls")
    if spans is None or not calls:
        return None
    runs = [r for r in spans if r.name == "ensemble.run"]
    if len(runs) != calls:
        return None
    return 1e3 * sum(r.end - r.start for r in runs) / calls
