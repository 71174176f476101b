"""End-to-end training example: train the repro-100m decoder LM on the
synthetic Zipf stream with checkpointing, then resume once to prove the
fault-tolerance path.

    PYTHONPATH=src python -m repro_torch.examples.train_lm            # reduced
    PYTHONPATH=src python -m repro_torch.examples.train_lm --full     # 100M
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu

It trains on the card unless ``--device`` names another device.
"""
import argparse
import logging
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 100M-param config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (no fallback to the CPU)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("repro-100m") if args.full else get_smoke("repro-100m")
    steps = args.steps or (300 if args.full else 60)
    seq = args.seq_len or (512 if args.full else 128)

    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainConfig(seq_len=seq, global_batch=args.global_batch,
                           steps=steps, lr=3e-4, warmup=20,
                           ckpt_dir=ckpt, ckpt_every=max(steps // 3, 10),
                           log_every=10)
        tr = Trainer(cfg, tcfg, device=args.device)
        hist = tr.run()
        print(f"loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
              f"over {steps} steps")
        if not hist["loss"][-1] < hist["loss"][0]:
            raise AssertionError("the loss did not fall")

        # simulated restart: a fresh Trainer resumes from the checkpoint
        tr2 = Trainer(cfg, tcfg, device=args.device)
        print(f"resume check: restart would continue from step "
              f"{tr2.start_step} (>{2 * steps // 3})")
        if not tr2.start_step >= 2 * steps // 3:
            raise AssertionError("the restart did not resume")
    print("OK")
    return hist


if __name__ == "__main__":
    main()
