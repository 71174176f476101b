"""Device operations an engine step: the operations (kernels, copies,
sets) that ran on the device in the window, from the profiler's trace,
over the window's engine steps."""


def read(run):
    steps = run.counters.get("steps")
    if run.trace is None or not steps or not run.trace.ops:
        return None
    return len(run.trace.ops) / steps
