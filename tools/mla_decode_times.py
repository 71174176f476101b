#!/usr/bin/env python3
"""Time MLA decode's attention core on one card: the kernel
(``kernels/mla_decode``) at DeepSeek-V3's widths over rows of a 2,560-long
latent cache at the chat mix's depths, beside its bound and the plain
core, at ``plan``'s split and, with ``--sweep``, at 1-4 splits.

    python3 tools/mla_decode_times.py [--seed S] [--rows N] [--sweep]

Prints the card's name and power limit, torch's version, the build's
seconds and ptxas report (registers, spills, shared bytes of each
kernel), then one JSON line a split: its time (CUDA events, 20 calls
after 3), its bound (live latent bytes at 3.35e12 B/s against the
absorbed FLOPs at 989.4e12), the share, and its largest relative L2
distance from the plain core's context; the plain core's time once.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mla_decode import build, check, ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

SPLITS = (1, 2, 3, 4)
T = 2560


def card() -> str:
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        q = torch.cuda.get_device_name(0)
    return q.splitlines()[0] if q else torch.cuda.get_device_name(0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mla_decode_times: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = card()
    print(f"{name} | torch {torch.__version__} CUDA {torch.version.cuda}")
    cfg = get_config("deepseek-v3")
    m = cfg.mla
    pos = check.chat_positions(args.rows, T, args.seed)
    k = check.case(args.rows, cfg.n_heads, m.kv_lora, m.rope_dim, T, pos,
                   scale=attention.mla_scale(cfg), device=dev,
                   seed=args.seed)
    want = check.plain(k)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = [ops.plan(args.rows, cfg.n_heads, T, n_sm)]
    if args.sweep:
        splits += [ops.split_keys(T, s) for s in SPLITS]
    for i, split in enumerate(splits):
        got = check.kernel(k, split)
        torch.cuda.synchronize()
        if i == 0:
            print(json.dumps({"build_s": build.BUILD_INFO.get("seconds"),
                              "ptxas": build.BUILD_INFO.get("ptxas")}))
        dist = float(check._rel(got, want).max())
        row = check.time_core(k, plain_reps=5 if i == 0 else 0, split=split)
        print(json.dumps({"card": name, "plan": i == 0, "splits": split[0],
                          "chunk": split[1], "rows": args.rows,
                          "live_keys": sum(min(p + 1, T) for p in pos),
                          "max_rel_vs_plain": dist, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
