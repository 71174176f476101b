"""The share of the window, in %, in which no operation ran on the device:
one less the union of the profiler's device intervals over the window.
Read for every ``device_idle_share.<end-to-end metric>`` of a cell."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
