"""The controls of ``correct`` for the DeepSeek-V3 cell, and broken timed
paths.

Controls, each a run that must come out not correct:

* ``fp8_latent``: the program with its latent cache (``c`` and ``kr``)
  rounded through ``float8_e4m3fn`` after every prefill and decode step:
  the precision below the configuration's bf16 cache;
* ``yarn_off``: the program with plain rotary at the configuration's
  theta and the softmax scale ``(nope + rope) ** -0.5``, where the
  reference keeps YaRN;
* ``router_ungrouped``: the program's gate choosing its top k over all
  experts with no group limit (every group kept).

Faults of the timed path (``fault(kind)``), for the CPU checks: a decode
step that leaves the cache as it was (``unchanged``); half of the batch's
rows given the other half's logits (``half``, ``control_lm``'s); a
latent leaf zeroed after every step (``zeroed``, ``control_lm``'s); the
experts of another share computed in this share's place (``experts``:
the held range moved by its own width).

On the card, at the cell's own size:

    python3 cabench/control_lm_mla_moe.py --workload <cell> --seconds <s> \\
        --kind fp8_latent --seeds <n>...

prints one JSON line a seed with the numbers compared (``--kind sound``
runs the program as it is).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cabench import control_lm  # noqa: E402

CONTROLS = ("fp8_latent", "yarn_off", "router_ungrouped")
FAULTS = ("unchanged", "half", "zeroed", "experts")


def yarn_off(cfg):
    from repro_torch.models import MLACfg
    m = cfg.mla
    return dataclasses.replace(cfg, mla=MLACfg(
        q_lora=m.q_lora, kv_lora=m.kv_lora, rope_dim=m.rope_dim,
        nope_dim=m.nope_dim, v_dim=m.v_dim))


def ungrouped(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, topk_groups=cfg.moe.n_groups))


def other_experts(cfg):
    e = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        e, first_expert=(e.first_expert + e.n_held) % e.n_experts))


def control(kind: str) -> dict:
    """The run hooks of control ``kind`` (``sound``: none)."""
    if kind == "sound":
        return {}
    if kind == "fp8_latent":
        return control_lm.fp8_kv()
    if kind == "yarn_off":
        return {"model_cfg": yarn_off}
    if kind == "router_ungrouped":
        return {"model_cfg": ungrouped}
    raise ValueError(f"control {kind!r} not in {CONTROLS}")


def fault(kind: str) -> dict:
    """The run hooks that break the program's timed path as ``kind``
    says."""
    if kind not in FAULTS:
        raise ValueError(f"fault {kind!r} not in {FAULTS}")
    if kind in ("half", "zeroed"):
        return control_lm.fault(kind)
    if kind == "experts":
        return {"model_cfg": other_experts}

    def decode_step(inner):
        def call(params, cfg, cache, token, pos):
            from repro_torch.models import lm
            logits, _ = inner(params, cfg, lm.tree_map(
                lambda t: t.clone(), cache), token, pos)
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
        # Each seed's set-up from its own start, not the process's.
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               hooks=control(args.kind), started=time.time())
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "correct": res["correct"],
                          "metrics": res["metrics"],
                          "memory_peak_bytes":
                              res["device"]["memory_peak_bytes"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
