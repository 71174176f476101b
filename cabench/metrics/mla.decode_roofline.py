"""MLA decode's share of its roofline, in %: over the window's engine
steps that prefilled nothing, the least time of their MLA on an H100
(``cabench.roofline.lm_mla_moe.mla_decode_seconds``: the larger of the
weights and the live latent cache read and written, at 3.35e12 B/s, and
the absorbed form's FLOPs at 989.4e12) over the time the device was busy
in the operations that the program launched inside its ``mla.decode``
spans of those steps.  No reading where the program keeps no such
spans."""
from cabench import harness
from cabench.roofline import lm_mla_moe

_expert = harness._load_file_module(
    harness.reader_path("moe.expert_byte_roofline"))


def read(run):
    c = run.counters
    if run.trace is None or not c.get("decode_only_steps"):
        return None
    busy = _expert.busy_launched_in(run, ("mla.decode",))
    if busy is None:
        return None
    least = lm_mla_moe.mla_decode_seconds(
        run.config, steps=c["decode_only_steps"],
        rows=c["decode_only_rows"], keys=c["decode_only_keys"])
    return 100.0 * least / busy
