"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \
        --steps 300 --seq-len 512 --global-batch 8 [--smoke] \
        [--ckpt-dir /tmp/ckpt] [--device cpu]

The reference's flags; the model trains on the card unless ``--device``
names another device (no fallback to the CPU).  ``--mesh`` takes ``none``
only: sharded training comes with ROADMAP §1 item 11f.
"""
from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none", choices=["none"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback to the CPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                       microbatches=args.microbatches, steps=args.steps,
                       lr=args.lr, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every)
    trainer = Trainer(cfg, tcfg, device=args.device)
    hist = trainer.run()
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(first {hist['loss'][0]:.4f}); "
          f"mean step {1e3 * sum(hist['step_time'][1:]) / max(len(hist['step_time']) - 1, 1):.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
