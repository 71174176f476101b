"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \
        --steps 300 --seq-len 512 --global-batch 8 [--smoke] \
        [--ckpt-dir /tmp/ckpt] [--device cpu] [--mesh none|test|prod]

The reference's flags; the model trains on the card unless ``--device``
names another device (no fallback to the CPU).  ``--mesh test`` (4 x 2)
and ``--mesh prod`` (16 x 16) train sharded, one process per rank, each
started by ``torchrun`` (the process group comes from its environment:
gloo on the CPU, NCCL on cards, one card a rank); the group must have
the mesh's size:

    PYTHONPATH=src torchrun --nproc-per-node 8 -m \
        repro_torch.launch.train --smoke --mesh test --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
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
    ap.add_argument("--mesh", default="none",
                    choices=["none", "test", "prod"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback to the CPU)")
    args = ap.parse_args(argv)
    if args.mesh != "none" and "WORLD_SIZE" not in os.environ:
        ap.error(f"--mesh {args.mesh} runs one process per rank: start it "
                 f"with torchrun --nproc-per-node <ranks>")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    from repro_torch.models.common import device_or_card
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                       microbatches=args.microbatches, steps=args.steps,
                       lr=args.lr, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every)
    mesh, device = None, args.device
    if args.mesh != "none":
        kind = device_or_card(device).type
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            device = None
        dist.init_process_group("nccl" if kind == "cuda" else "gloo")
        mesh = {"test": make_test_mesh, "prod": make_production_mesh}[
            args.mesh](device_type=kind)
    trainer = Trainer(cfg, tcfg, mesh=mesh, device=device)
    hist = trainer.run()
    if mesh is None or dist.get_rank() == 0:
        print(f"final loss {hist['loss'][-1]:.4f} "
              f"(first {hist['loss'][0]:.4f}); "
              f"mean step {1e3 * sum(hist['step_time'][1:]) / max(len(hist['step_time']) - 1, 1):.0f} ms")
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
