"""Kernel launches per ensemble call: the change in the program's launch
counter (``ops.launches_total()``) over the window, over its calls."""


def read(run):
    calls = run.counters.get("calls")
    if not calls or not run.counters.get("launches"):
        return None
    return run.counters["launches"] / calls
