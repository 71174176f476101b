"""Batched serving demo: continuous batching over 4 slots, mixed prompt
lengths, greedy decoding, with a smoke-size model of ``--arch`` whose
weights are drawn from a seed.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch deepseek-v3-671b]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu

``--arch`` takes any decoder-only config (attention, experts/MLA, SSM,
hybrid).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke
from repro_torch.models import common as cm
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback to the CPU)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch)
    device = cm.device_or_card(args.device)
    params = init_params(cfg, 0, device=device)
    eng = ServeEngine(params, cfg, batch_size=4, max_len=96, device=device)

    rng = np.random.default_rng(7)
    n_req = 10
    for rid in range(n_req):
        plen = int(rng.integers(4, 24))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new=int(rng.integers(4, 16))))

    t0 = time.perf_counter()
    done = eng.run_until_done()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"{cfg.name} (smoke) on {device}: served {len(done)}/{n_req} "
          f"requests, {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"batch={eng.bs} slots)")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.out}")
    if len(done) != n_req:
        raise SystemExit(f"served {len(done)} of {n_req} requests")
    print("OK")
    return done


if __name__ == "__main__":
    main()
