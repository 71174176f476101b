"""The fhp_step kernel's share of its roofline, in %: the least time the
window's calls need on an H100 (``cabench.roofline``: frozen instruction
counts against the ALU, IMAD, POPC and issue rates, and each call's state
read and written once against HBM) over the device time of the window's
``fhp_step`` kernels in the profiler's trace."""
from cabench import roofline
from cabench.reference import lattice


def read(run):
    if (run.trace is None or not run.counters.get("calls")
            or run.config["rule"] not in roofline.COUNTED_RULES):
        return None
    kernels = run.trace.kernels("fhp_step")
    busy = sum(t - s for s, t, _ in kernels)
    if busy <= 0:
        return None
    cfg = run.config
    records = cfg["steps_per_call"] // cfg["moments_every"]
    rule = cfg["rule"]
    bound_s, _ = roofline.call_bound(
        cfg["lanes"], lattice.N_BITS[rule], cfg["height"], cfg["width"] // 32,
        cfg["steps_per_call"], records, len(lattice.MOMENT_ROWS[rule]))
    return 100.0 * run.counters["calls"] * bound_s / busy
