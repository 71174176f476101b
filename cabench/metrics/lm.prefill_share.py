"""The share of the window, in %, spent in engine steps that prefilled:
the benchmark's ``lm.step.prefill`` spans (the engine's prefills of the
step, one request at a time, then its decode of every live row) over the
window, on the host clock."""


def read(run):
    w0, w1 = run.window_wall
    if w1 <= w0 or not run.counters.get("steps"):
        return None
    spent = sum(t - s for name, s, t in run.spans.records
                if name == "lm.step.prefill" and w0 <= s < w1)
    return 100.0 * spent / (w1 - w0)
