"""Seconds of admission a job admitted in the window: the benchmark's
``serve.admit`` spans (around the engine's admission step: queue order,
each job's lattice set-up on the host and its copy into a lane) that
began in the window, on the host clock, over the jobs they admitted."""


def read(run):
    w0, w1 = run.window_wall
    n = run.counters.get("jobs_admitted")
    total = sum(t - s for name, s, t in run.spans.records
                if name == "serve.admit" and w0 <= s < w1)
    if not n or total <= 0:
        return None
    return total / n
