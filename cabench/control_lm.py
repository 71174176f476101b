"""The controls of ``correct`` for the LM cells, and broken timed paths.

Controls, each a run that must come out not correct:

* ``fp8_kv``: the program with its key/value cache rounded through
  ``float8_e4m3fn`` after every prefill and decode step: the precision
  below the configuration's bf16 cache, the step a faster decode would be
  tempted to take;
* ``rope_1e4``: the program with rotary theta 1e4 where the
  configuration states 1e6, which the reference keeps.

``rope_theta(x)`` is the second with any theta; at the configuration's
own it must come out correct (the control fails for what it breaks, not
for standing in).

Faults of the timed path (``fault(kind)``): a decode step that leaves
the cache as it was (``unchanged``); half of the batch's rows given the
other half's logits, the second half on odd steps and the first on even
ones, so that every slot's requests are hit (``half``); every served
token altered
where it is produced, the logits' best moved to another token
(``altered``); a cache leaf zeroed after every step (``zeroed``).

On the card, at a cell's own size:

    python3 cabench/control_lm.py --workload <cell> --seconds <s> \\
        --kind fp8_kv --seeds <n>...

prints one JSON line a seed with the numbers compared (``--kind sound``
runs the program as it is, so the sound readings of several seeds come
from one process).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONTROLS = ("fp8_kv", "rope_1e4")
FAULTS = ("unchanged", "half", "altered", "zeroed")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, tuple):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def round_fp8(cache) -> None:
    """Round every cache leaf through float8_e4m3fn in place, one layer
    at a time (a whole leaf's copies would take 12 GB at full size)."""
    import torch
    for leaf in _leaves(cache):
        for layer in leaf:
            layer.copy_(layer.to(torch.float8_e4m3fn).to(leaf.dtype))


def fp8_kv() -> dict:
    def prefill(inner):
        def call(*a, **kw):
            last, cache = inner(*a, **kw)
            round_fp8(cache)
            return last, cache
        return call

    def decode_step(inner):
        def call(*a, **kw):
            logits, cache = inner(*a, **kw)
            round_fp8(cache)
            return logits, cache
        return call
    return {"prefill": prefill, "decode_step": decode_step}


def rope_theta(theta: float) -> dict:
    return {"model_cfg": lambda cfg: dataclasses.replace(cfg,
                                                         rope_theta=theta)}


def control(kind: str) -> dict:
    """The run hooks of control ``kind`` (``sound``: none)."""
    if kind == "sound":
        return {}
    if kind == "fp8_kv":
        return fp8_kv()
    if kind == "rope_1e4":
        return rope_theta(1e4)
    raise ValueError(f"control {kind!r} not in {CONTROLS}")


def fault(kind: str) -> dict:
    """The run hooks that break the program's decode step as ``kind``
    says."""
    if kind not in FAULTS:
        raise ValueError(f"fault {kind!r} not in {FAULTS}")
    steps = [0]

    def decode_step(inner):
        def call(params, cfg, cache, token, pos):
            if kind == "unchanged":
                copy = {"layers": {n: {k: t.clone() for k, t in c.items()}
                                   for n, c in cache["layers"].items()}}
                logits, _ = inner(params, cfg, copy, token, pos)
                return logits, cache
            logits, cache = inner(params, cfg, cache, token, pos)
            if kind == "zeroed":
                next(_leaves(cache)).zero_()
                return logits, cache
            logits = logits.clone()
            if kind == "half":
                b, steps[0] = logits.shape[0], steps[0] + 1
                if steps[0] % 2:
                    logits[b // 2:] = logits[:b - b // 2]
                else:
                    logits[:b // 2] = logits[b - b // 2:]
            else:
                best = logits.argmax(-1)
                other = (best + 1) % logits.shape[-1]
                top = logits.gather(-1, best[:, None])
                logits.scatter_(-1, other[:, None], top + 1)
            return logits, cache
        return call
    return {"decode_step": decode_step}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kind", required=True,
                    choices=("sound",) + CONTROLS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from cabench import harness
    for seed in args.seeds:
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               hooks=control(args.kind))
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "correct": res["correct"],
                          "metrics": res["metrics"],
                          "memory_peak_bytes":
                              res["device"]["memory_peak_bytes"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
