"""The share of the window, in %, in which the device sat idle waiting
for the launch loop: each idle gap of the device (the window less the
union of its operations) counted from its start until the runtime call
that launched the operation ending it (``program_spans.host_late``: a
kernel already queued, waiting only on launch latency, counts for
nothing), where that lies inside one of the program's ``ensemble.run``
spans, over the window."""
from cabench import program_spans


def read(run):
    spans = program_spans.window(run)
    ops = program_spans.device_ops(run)
    if spans is None or not ops:
        return None
    runs = [r for r in spans if r.name == "ensemble.run"]
    if not runs:
        return None
    w0, w1 = run.window_wall
    late = program_spans.host_late((w0, w1), ops)
    return 100.0 * program_spans.covered(late, runs) / (w1 - w0)
